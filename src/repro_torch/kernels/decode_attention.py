"""Decode attention: the wrapper of the CUDA kernel and its plain version.

One query row per slot against the first ``kv_len[b]`` rows of each slot's
cache lane, non-causal, GQA by index (query head ``h`` reads KV head
``h // (H / KV)``): the decode step's cache attention.  The kernel
(``csrc/decode_attention.cu``) replaces no TPU kernel; it reads only the
live prefix of each lane, in the cache's dtype, once for a whole GQA
group, and computes in float32 (see its source for the design).

``kv_len`` is None (the whole lane, as whisper's cross-attention reads
it), a 0-d integer tensor (every slot at one length) or a (B,) one (each
slot at its own, as the engine's continuous batching has it).  Each length
must lie in [1, Sk]: the kernel reads the lengths on the device, where no
check can raise without the host waiting for it, and takes a value outside
as the nearest end of that range.

Scores are scaled by ``scale`` (None: ``1/sqrt(hd)``).

``decode_attention_cuda`` launches the kernel and raises on anything it
does not take; it never falls back.  Its plain version is
``flash_attention.attention_reference`` with ``kv_len``, non-causal: the
operator's CPU implementation and the comparison on the card.
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
           kv_len: Optional[torch.Tensor]) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,1,H,hd) and k, v (B,Sk,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    if Sq != 1:
        raise ValueError(f"decode attention takes one query row a slot; got Sq {Sq}")
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if kv_len is not None:
        if kv_len.is_floating_point() or kv_len.is_complex() or kv_len.dtype == torch.bool:
            raise TypeError(f"kv_len must be an integer tensor, not {kv_len.dtype}")
        if kv_len.ndim > 1 or kv_len.numel() not in (1, B):
            raise ValueError(f"kv_len must be 0-d or ({B},); got {tuple(kv_len.shape)}")


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("decode_attention")
        fn = lib.decode_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.decode_attention_supported.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.decode_attention_supported.restype = ctypes.c_int
        lib.decode_attention_chunk.argtypes = []
        lib.decode_attention_chunk.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.decode_attention_supported, lib.decode_attention_chunk(),
               lib.decode_attention_error_string)
    return _FN


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_len: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel's two passes on PyTorch's current stream; (B, 1, H,
    hd) out in q's dtype.  Raises on what the kernel does not take and when
    a launch fails.  Nothing here waits for the device."""
    _check(q, k, v, kv_len)
    tensors = {"q": q, "k": k, "v": v}
    if kv_len is not None:
        tensors["kv_len"] = kv_len
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs q, k, v and "
                             f"kv_len on {q.device}, a CUDA device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous; strides {t.stride()}")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}'s rows must start on 16 bytes; strides {t.stride()}")
    B, _, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    fn, supported, chunk, err_str = _kernel()
    if not supported(hd, G):
        raise ValueError(f"decode attention kernel not built for head dim {hd} with "
                         f"{G} query heads a KV head")
    if kv_len is not None:
        kv_len = kv_len.reshape(-1).to(torch.int32).expand(B).contiguous()
    nc = -(-Sk // chunk)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    part_o = torch.empty((B, KV, nc, G, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, KV, nc, G, 2), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 10)(
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
                 part_o.data_ptr(), part_ml.data_ptr(), _DTYPES[q.dtype], B, H, KV, Sk,
                 hd, strides, 1.0 / math.sqrt(hd) if scale is None else float(scale),
                 stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return out
