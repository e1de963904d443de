"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernel and its plain version.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_bhsp``.  Both functions here take the
model layout: x (B, S, nh, hp), dt (B, S, nh), A (nh,), Bc and Cc (B, S, n)
shared across heads, and return y (B, S, nh, hp) and the final state
h (B, nh, hp, n), both float32.

Chunks start at 0 every ``min(chunk, S)`` steps, as in the JAX wrapper, and
the cumulative decay restarts at each chunk.  The last chunk may be
partial: the kernel masks it itself; ``ssd_chunked`` pads it with dt = 0
steps, as the JAX wrapper does, which leave the state unchanged and whose
outputs are dropped.

``ssd_scan_cuda`` launches the kernel's five passes (cumsum, C.B^T per
chunk, chunk states, state passing, chunk output; ``csrc/ssd_scan.cu``)
and raises on anything it does not take; it never falls back.
``ssd_chunked`` computes the same function in plain PyTorch, every chunk at
once (the JAX package's ``repro.models.ssm.ssd_chunked``): the operator's
CPU implementation, the comparison on the card, and the mamba2 block's
plain route (``ssm_impl="torch"``, training).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's passes, in launch order, and the bit of each in ``passes``
PASSES = {"cumsum": 1, "cb": 2, "states": 4, "passing": 8, "output": 16}
ALL_PASSES = sum(PASSES.values())
_FN = None


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bc: torch.Tensor, Cc: torch.Tensor, chunk: int) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1 or Bc.ndim != 3 \
            or Cc.shape != Bc.shape:
        raise ValueError(
            f"want x (B,S,nh,hp), dt (B,S,nh), A (nh,), Bc/Cc (B,S,n); got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
            f"{tuple(Bc.shape)}, {tuple(Cc.shape)}")
    B_, S, nh, _ = x.shape
    if dt.shape != (B_, S, nh) or A.shape != (nh,) or Bc.shape[:2] != (B_, S):
        raise ValueError(
            f"x {tuple(x.shape)} does not match dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, Bc {tuple(Bc.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def segsum(dtA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular cumulative decay: out[..., i, j] = sum_{j<k<=i} dtA_k
    for j <= i, -inf otherwise.  dtA: (..., Q)."""
    Q = dtA.shape[-1]
    cs = torch.cumsum(dtA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=dtA.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _ssd_intra(L, scores, dtc, xc):
    """y_intra = sum_k L[h,q,k] * scores[q,k] * dt[k,h] * x[k,h,p]."""
    w = L * scores[:, :, None, :, :]                       # (B,nc,nh,Q,Q)
    wdt = w * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]    # * dt_k
    return torch.einsum("bchqk,bckhp->bcqhp", wdt, xc)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD, chunked, math in float32.  x: (B,S,nh,hp); dt: (B,S,nh);
    A: (nh,) (<0); Bc, Cc: (B,S,n) (shared across heads).  Returns (y,
    h_final (B,nh,hp,n)), float32.
    """
    x, dt, A, Bc, Cc = (t.float() for t in (x, dt, A, Bc, Cc))
    B_, S, nh, hp = x.shape
    n = Bc.shape[-1]
    S0 = S
    if S % chunk:
        # pad to a chunk multiple: padded steps have dt = 0, so exp(dt*A) = 1
        # and dt*B*x = 0 — the state passes through unchanged.
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
        S = S + pad
    nc = S // chunk

    xc = x.reshape(B_, nc, chunk, nh, hp)
    dtc = dt.reshape(B_, nc, chunk, nh)
    Bcc = Bc.reshape(B_, nc, chunk, n)
    Ccc = Cc.reshape(B_, nc, chunk, n)
    dtA = dtc * A                                          # (B,nc,Q,nh)

    # intra-chunk (quadratic within chunk)
    L = torch.exp(segsum(dtA.transpose(-1, -2)))           # (B,nc,nh,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Ccc, Bcc)     # (B,nc,Q,Q)
    y_intra = _ssd_intra(L, scores, dtc, xc)

    # chunk state: S_c = sum_k exp(sum_{j>k} dtA_j) dt_k B_k x_k
    dtA_cum = torch.cumsum(dtA, dim=2)                     # (B,nc,Q,nh)
    decay_to_end = torch.exp(dtA_cum[:, :, -1:, :] - dtA_cum)
    states = torch.einsum("bcqh,bcqh,bcqn,bcqhp->bchpn",
                          decay_to_end, dtc, Bcc, xc)      # (B,nc,nh,hp,n)

    # inter-chunk recurrence (sequential over nc, nc is small)
    chunk_decay = torch.exp(dtA_cum[:, :, -1, :])          # (B,nc,nh)
    h = torch.zeros(B_, nh, hp, n, dtype=x.dtype, device=x.device) if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)                                  # state BEFORE chunk
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (B,nc,nh,hp,n)

    # inter-chunk contribution: y_inter[q] = exp(dtA_cum[q]) C_q . h_prev
    in_decay = torch.exp(dtA_cum)                          # (B,nc,Q,nh)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Ccc, h_prevs, in_decay)
    y = (y_intra + y_inter).reshape(B_, S, nh, hp)[:, :S0]
    return y, h


def _kernel():
    global _FN
    if _FN is None:
        lib = build.load("ssd_scan")
        fn = lib.ssd_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        scratch = lib.ssd_scan_scratch_floats
        scratch.argtypes = [ctypes.c_int] * 6
        scratch.restype = ctypes.c_int64
        max_state, max_chunk = ctypes.c_int(), ctypes.c_int()
        lib.ssd_scan_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.ssd_scan_limits.restype = None
        lib.ssd_scan_limits(ctypes.byref(max_state), ctypes.byref(max_chunk))
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _FN = (fn, scratch, max_state.value, max_chunk.value,
               lib.ssd_scan_error_string)
    return _FN


def ssd_scan_launcher(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bc: torch.Tensor, Cc: torch.Tensor, *, chunk: int
                      ) -> Tuple[Callable[[int], None], torch.Tensor, torch.Tensor]:
    """Check the inputs and allocate the outputs and the scratch of one
    scan.  Returns ``(launch, y, h)``: ``launch(passes)`` launches the
    passes named by the bit mask (``PASSES`` gives each bit; ``ALL_PASSES``
    runs the scan) on PyTorch's current stream and raises when one fails.
    A single pass reads what the earlier ones wrote, so alone it is only
    meaningful after a full run on the same buffers, to time it."""
    _check(x, dt, A, Bc, Cc, chunk)
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bc", Bc), ("Cc", Cc)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs all "
                             f"of x, dt, A, Bc, Cc on {x.device}, a CUDA device")
    for name, t in (("x", x), ("Bc", Bc), ("Cc", Cc), ("A", A)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous; "
                             f"strides {t.stride()}")
    if x.dtype not in _DTYPES or not (x.dtype == dt.dtype == Bc.dtype == Cc.dtype):
        raise TypeError(f"kernel takes x, dt, Bc, Cc all float32 or all "
                        f"bfloat16; got {x.dtype}, {dt.dtype}, {Bc.dtype}, "
                        f"{Cc.dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"kernel takes A in float32, not {A.dtype}")
    B_, S, nh, hp = x.shape
    n = Bc.shape[-1]
    if 0 in (B_, S, nh, hp, n):
        raise ValueError(f"empty scan: x {tuple(x.shape)}, Bc {tuple(Bc.shape)}")
    fn, scratch_floats, max_state, max_chunk, err_str = _kernel()
    if n > max_state or min(chunk, S) > max_chunk:
        raise ValueError(f"state size {n} / chunk {min(chunk, S)} above the "
                         f"kernel's {max_state} / {max_chunk}")
    floats = scratch_floats(B_, S, nh, hp, n, chunk)
    if floats < 0:
        raise ValueError(f"kernel does not take x {tuple(x.shape)}, n {n}, "
                         f"chunk {chunk}")
    y = torch.empty((B_, S, nh, hp), dtype=torch.float32, device=x.device)
    h = torch.empty((B_, nh, hp, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 10)(
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1))
    # the closure holds the tensors themselves, so none of its buffers is
    # freed while it can still launch
    buffers = (x, dt, A, Bc, Cc, y, h, scratch)

    def launch(passes: int) -> None:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = fn(*(t.data_ptr() for t in buffers), _DTYPES[x.dtype], B_,
                     S, nh, hp, n, chunk, passes, strides, stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan kernel failed: CUDA error {err} "
                               f"({err_str(err).decode()})")

    return launch, y, h


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bc: torch.Tensor, Cc: torch.Tensor, *,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel's five passes on PyTorch's current stream; returns
    (y (B, S, nh, hp), h (B, nh, hp, n)), float32.  Raises on what the
    kernel does not take and when a launch fails."""
    launch, y, h = ssd_scan_launcher(x, dt, A, Bc, Cc, chunk=chunk)
    launch(ALL_PASSES)
    return y, h
