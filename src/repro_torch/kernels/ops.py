"""Model-layout wrappers of the port's kernels.

A CUDA tensor goes to the hand-written kernel, which launches or raises; a
CPU tensor goes to the kernel's plain PyTorch version.  There is no other
route: nothing here falls back from the kernel to the plain version.
``LAUNCHES`` counts kernel launches, one per launch and nowhere else.
One ``ssd_scan`` count stands for one call of the scan, which launches its
five passes (cumsum, C.B^T, chunk states, state passing, chunk output) as
five CUDA kernels on the current stream; one ``flash_attention`` count is
one kernel launch.

Neither kernel has a backward (the JAX package's Pallas kernels have none
either): a call that autograd would have to differentiate raises, on the
card and on the CPU alike, and falls back to nothing.  Training goes
through the plain paths, ``ShardCtx(attention_impl="torch",
ssm_impl="torch")`` (``train.steps.TRAIN_CTX``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .flash_attention import flash_attention_cuda, flash_attention_plain
from .ssd_scan import ssd_scan_cuda, ssd_scan_plain

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "ssd_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _forward_only(name: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (nor do the JAX package's Pallas kernels): "
            "train with ShardCtx(attention_impl='torch', ssm_impl='torch'), "
            "as train.steps.TRAIN_CTX does")


def flash_attention(
    q: torch.Tensor,      # (B, Sq, H, hd)
    k: torch.Tensor,      # (B, Sk, KV, hd)
    v: torch.Tensor,      # (B, Sk, KV, hd)
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Flash attention in the model layout; returns (B, Sq, H, hd)."""
    _forward_only("flash_attention", q, k, v)
    if q.is_cuda:
        out = flash_attention_cuda(q, k, v, causal=causal)
        LAUNCHES["flash_attention"] += 1
        return out
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")


def ssd_scan(
    x: torch.Tensor,      # (B, S, nh, hp)
    dt: torch.Tensor,     # (B, S, nh)
    A: torch.Tensor,      # (nh,)
    Bc: torch.Tensor,     # (B, S, n)
    Cc: torch.Tensor,     # (B, S, n)
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan in the model layout.  Returns (y (B, S, nh, hp) f32,
    h_final (B, nh, hp, n) f32).  A ragged last chunk is handled inside
    (it equals the JAX wrapper's dt = 0 padding), so nothing is padded."""
    _forward_only("ssd_scan", x, dt, A, Bc, Cc)
    if x.is_cuda:
        out = ssd_scan_cuda(x, dt, A, Bc, Cc, chunk=chunk)
        LAUNCHES["ssd_scan"] += 1
        return out
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bc, Cc, chunk=chunk)
    raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, not {x.device}")
