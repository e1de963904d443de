"""Parameters from the JAX package's pytree, given as numpy arrays.

The port cannot import jax, so the caller flattens the JAX parameters to
nested dicts of numpy arrays first (``jax.tree.map(np.asarray, params)``).
Names and the stacked [L, ...] layout are kept, so both packages compute
the same function on the same weights.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None) -> Dict:
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``.
    Float32 leaves are cast to ``dtype`` when it is given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.dtype == torch.float32:
        t = t.to(dtype)
    return t.to(device)
