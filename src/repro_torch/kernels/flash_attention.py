"""Flash attention: the wrapper of the CUDA kernel and its plain version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_bhsd``.  It reads the model
layout (B, S, H, hd) through strides, so no transposes are needed and
masks the ragged tail itself.  Causal attention reads query row ``i`` as
position ``q_offset + i`` and needs ``q_offset + Sq <= Sk``: ``q_offset``
0 with Sq == Sk is the square causal product, a positive one a slice of
later query rows against every key (a shard of a sequence-sharded q).

Scores are scaled by ``scale`` (None: ``1/sqrt(hd)``).

``flash_attention_cuda`` launches the kernel and raises on anything it does
not take; it never falls back.  ``attention_reference`` computes the same
function in plain PyTorch, and with ``kv_len`` that of the decode kernel
(``decode_attention``) too: it is the CPU implementation of both operators,
the comparison on the card, and the models' plain attention
(``models.ops.attention_chunked``, a cache whose head dim is sharded).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from . import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, q_offset: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,H,hd) and k, v (B,Sk,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if causal and not (q_offset >= 0 and q_offset + Sq <= k.shape[1]):
        raise ValueError(f"causal attention needs 0 <= q_offset and q_offset + Sq "
                         f"<= Sk; got q_offset {q_offset}, Sq {Sq}, Sk {k.shape[1]}")
    if not causal and q_offset:
        raise ValueError(f"q_offset {q_offset} means nothing without a causal mask")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_offset: int = 0,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax attention with GQA head grouping, math in float32.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).  H must be a multiple of KV.
    ``q_offset``: absolute position of q[0] (for causal masking in decode).
    ``kv_len``: optional number of valid kv entries (cache decode); a
    scalar, or a (B,) vector for continuous-batching decode where every
    slot sits at its own sequence position.
    ``scale``: the scores' factor; None divides them by sqrt(hd).
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    mask = None  # broadcastable to (B, 1, 1, Sq, Sk)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :])[None, None, None]
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
        valid = torch.arange(Sk, device=q.device)[None, :] < kv_len[:, None]
        valid = valid[:, None, None, None, :]       # (B|1, 1, 1, 1, Sk)
        mask = valid if mask is None else mask & valid
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        dims = (ctypes.c_int * 32)()
        lib.flash_attention_head_dims.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.flash_attention_head_dims.restype = ctypes.c_int
        n = lib.flash_attention_head_dims(dims, 32)
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _FN = (fn, frozenset(dims[:n]), lib.flash_attention_error_string)
    return _FN


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream; (B, Sq, H, hd)
    out in q's dtype.  Raises on what the kernel does not take and when
    the launch fails."""
    _check(q, k, v, causal, q_offset)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs all "
                             f"of q, k, v on {q.device}, a CUDA device")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous; "
                             f"strides {t.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    fn, dims, err_str = _kernel()
    if hd not in dims:
        raise ValueError(f"head dim {hd} not among the kernel's {sorted(dims)}")
    if Sq == 0 or Sk == 0 or B == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 _DTYPES[q.dtype], B, H, KV, Sq, Sk, hd, strides,
                 1.0 / math.sqrt(hd) if scale is None else float(scale), int(causal),
                 int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return o
