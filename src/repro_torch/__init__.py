"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout module by module.  It imports torch
and numpy, never jax and nothing of ``repro``.  Entry points run on the
card: ``device=None`` means ``"cuda"``, and the CPU runs only when a caller
asks for it with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
