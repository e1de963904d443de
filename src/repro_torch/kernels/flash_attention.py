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
not take; it never falls back.  ``flash_attention_plain`` computes the same
function in plain PyTorch: the CPU path and the comparison on the card.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, q_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 math, GQA by
    grouping query heads, output in q's dtype."""
    _check(q, k, v, causal, q_offset)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * _scale(scale, hd)
    if causal:
        keep = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(q_offset)
        s = s.masked_fill(~keep, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _scale(scale: Optional[float], hd: int) -> float:
    return 1.0 / math.sqrt(hd) if scale is None else float(scale)


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
                 _scale(scale, hd), int(causal), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return o
