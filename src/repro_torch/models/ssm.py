"""Mamba2 (SSD) blocks: the zamba2 backbone layer.

Port of the mamba2 half of ``repro.models.ssm``.  The full-sequence path
(training / prefill) runs the SSD scan either through
``kernels.ops.ssd_scan`` (``ssm_impl="kernel"``: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor) or through ``ssd_chunked``
(``ssm_impl="torch"``, the chunked algorithm in plain PyTorch).  Decode is
the O(1) one-token recurrence.  The mamba1 half waits: it has no kernel and
its family (falcon-mamba) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .ops import ShardCtx, rms_norm

# cache lanes of one mamba2 layer
STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C); b: (C,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i]
    return out + b


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal-conv decode step.  x_t: (B, C); conv_state: (B, K-1, C).
    Returns (out (B, C), the new state window[:, 1:])."""
    window = torch.cat([conv_state, x_t[:, None, :].to(conv_state.dtype)], dim=1)
    out = torch.einsum("bkc,kc->bc", window, w) + b
    return out, window[:, 1:, :]


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
    """Mamba2 SSD, chunked.  x: (B,S,nh,hp); dt: (B,S,nh); A: (nh,) (<0);
    Bc, Cc: (B,S,n) (shared across heads).  Returns (y, h_final (B,nh,hp,n)).
    """
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


def mamba2_block(p: Dict, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx,
                 cache: Optional[Dict] = None,
                 return_state: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 block (zamba2 backbone layer).  x: (B, S, d).

    Prefill with ``return_state``: also returns the decode state, the last
    K-1 pre-conv inputs (``conv_x``, ``conv_B``, ``conv_C``) and the final
    SSM state (``ssm``, float32).  Decode (``cache`` given, S == 1): the
    one-token recurrence; the cache's tensors (views of one layer of the
    pooled cache) are updated IN PLACE, where the JAX package returns new
    arrays, and returned.
    """
    ssm = cfg.ssm
    di, n, hp = cfg.d_inner, ssm.d_state, ssm.head_dim
    nh = di // hp
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    z = h @ p["wz"]
    xi = h @ p["wx"]
    Bc = h @ p["wB"]
    Cc = h @ p["wC"]
    dt = F.softplus(h @ p["wdt"] + p["dt_bias"])          # (B,S,nh)
    A = -torch.exp(p["A_log"].float())                     # (nh,)

    if cache is None:
        K = ssm.d_conv
        xc = F.silu(causal_conv(xi, p["conv_x_w"], p["conv_x_b"]))
        Bcv = F.silu(causal_conv(Bc, p["conv_B_w"], p["conv_B_b"]))
        Ccv = F.silu(causal_conv(Cc, p["conv_C_w"], p["conv_C_b"]))
        xh = xc.reshape(*xc.shape[:2], nh, hp)
        args = (xh.float(), dt.float(), A, Bcv.float(), Ccv.float())
        if ctx.ssm_impl == "kernel":
            from repro_torch.kernels.ops import ssd_scan

            y, h_fin = ssd_scan(*args, chunk=ssm.chunk)
        else:
            y, h_fin = ssd_chunked(*args, ssm.chunk)
        y = y.to(x.dtype) + xh * p["D"][:, None]
        y = y.reshape(*xc.shape[:2], di)
        y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
        state = None
        if return_state:
            state = {"conv_x": xi[:, -(K - 1):, :], "conv_B": Bc[:, -(K - 1):, :],
                     "conv_C": Cc[:, -(K - 1):, :], "ssm": h_fin}
        return x + y @ p["w_out"], state

    # --- decode ---------------------------------------------------------------
    xc, conv_x = conv_step(xi[:, 0], cache["conv_x"], p["conv_x_w"], p["conv_x_b"])
    Bcv, conv_B = conv_step(Bc[:, 0], cache["conv_B"], p["conv_B_w"], p["conv_B_b"])
    Ccv, conv_C = conv_step(Cc[:, 0], cache["conv_C"], p["conv_C_w"], p["conv_C_b"])
    xc, Bcv, Ccv = F.silu(xc), F.silu(Bcv), F.silu(Ccv)
    xh = xc.reshape(-1, nh, hp).float()
    dt0 = dt[:, 0].float()                                 # (B,nh)
    dA = torch.exp(dt0 * A)                                # (B,nh)
    hs = cache["ssm"] * dA[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt0, xh, Bcv.float())
    y = torch.einsum("bhpn,bn->bhp", hs, Ccv.float())
    y = y.to(x.dtype) + xh.to(x.dtype) * p["D"][:, None]
    y = y.reshape(-1, di)
    y = rms_norm(y * F.silu(z[:, 0]), p["out_norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    for key, new in (("conv_x", conv_x), ("conv_B", conv_B), ("conv_C", conv_C),
                     ("ssm", hs)):
        cache[key].copy_(new)
    return x + out[:, None, :], cache
