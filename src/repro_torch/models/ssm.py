"""State-space blocks: the mamba1 selective scan (falcon-mamba) and the
mamba2 SSD chunked scan (the zamba2 backbone layer).

Port of ``repro.models.ssm``.  Both blocks have a full-sequence path
(training / prefill) and an O(1) recurrent decode step.  The mamba2
full-sequence path runs the SSD scan either through
``kernels.ops.ssd_scan`` (``ssm_impl="kernel"``: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor) or through ``ssd_chunked``
(``ssm_impl="torch"``, the chunked algorithm in plain PyTorch).  The mamba1
scan has no kernel in the reference either (an ``associative_scan`` in XLA
code): here it is the same log-depth scan in plain PyTorch.
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


# ---------------------------------------------------------------------------
# mamba1 (falcon-mamba)
# ---------------------------------------------------------------------------


def _linear_scan(a: torch.Tensor, b: torch.Tensor, need_a: bool):
    """Inclusive scan over dim 1 of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2): the first-order recurrence
    h_t = a_t h_{t-1} + b_t.  The odd/even recursion of
    ``jax.lax.associative_scan`` (log depth, linear work), so the products
    associate as in the reference.  Returns (a-prefix or None, h)."""
    S = a.shape[1]
    if S < 2:
        return (a if need_a else None), b
    a0, b0 = a[:, 0:-1:2], b[:, 0:-1:2]
    a1, b1 = a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _linear_scan(a0 * a1, b0 * a1 + b1, need_a=True)
    a2, b2 = a[:, 2::2], b[:, 2::2]
    if S % 2 == 0:
        odd_a_in, odd_b_in = odd_a[:, :-1], odd_b[:, :-1]
    else:
        odd_a_in, odd_b_in = odd_a, odd_b
    even_b = odd_b_in * a2 + b2
    h = torch.empty_like(b)
    h[:, 0] = b[:, 0]
    h[:, 2::2] = even_b
    h[:, 1::2] = odd_b
    if not need_a:
        return None, h
    out_a = torch.empty_like(a)
    out_a[:, 0] = a[:, 0]
    out_a[:, 2::2] = odd_a_in * a2
    out_a[:, 1::2] = odd_a
    return out_a, h


def mamba1_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan.  x, dt: (B,S,di); A: (di,n); Bc, Cc: (B,S,n).

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t
    Log-depth scan over S.  Returns (y (B,S,di), h_S (B,di,n)).
    """
    dA = torch.exp(dt[..., None] * A)                      # (B,S,di,n)
    dBx = (dt * x)[..., None] * Bc[:, :, None, :]          # (B,S,di,n)
    if h0 is not None:
        # fold carry-in into the first step
        dBx[:, 0] += dA[:, 0] * h0
    _, h = _linear_scan(dA, dBx, need_a=False)
    y = torch.einsum("bsdn,bsn->bsd", h, Cc)
    # a copy: a view would keep all of h (S times the state) alive
    return y, h[:, -1].clone()


def mamba1_block(p: Dict, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx,
                 cache: Optional[Dict] = None,
                 return_state: bool = False) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full mamba1 block.  x: (B, S, d).  With ``cache`` (decode), S == 1:
    the cache's ``conv`` and ``ssm`` tensors (views of one layer of the
    pooled cache) are updated IN PLACE, where the JAX package returns new
    arrays, and returned.  ``return_state`` (prefill): also returns the
    decode state, the last K-1 pre-conv inputs (``conv``) and the final SSM
    state (``ssm``, float32)."""
    ssm = cfg.ssm
    di, n = cfg.d_inner, ssm.d_state
    dt_rank = max(1, cfg.d_model // 16)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xz = h @ p["w_in"]                                     # (B,S,2*di)
    xi, z = xz[..., :di], xz[..., di:]
    A = -torch.exp(p["A_log"].float())                     # (di,n)

    if cache is None:
        K = ssm.d_conv
        xc = F.silu(causal_conv(xi, p["conv_w"], p["conv_b"]))
        xdb = xc @ p["w_xproj"]                            # (B,S,r+2n)
        dt = F.softplus(xdb[..., :dt_rank] @ p["w_dt"] + p["dt_bias"])
        Bc = xdb[..., dt_rank:dt_rank + n].float()
        Cc = xdb[..., dt_rank + n:].float()
        y, h_fin = mamba1_scan(xc.float(), dt.float(), A, Bc, Cc)
        y = y.to(x.dtype) + xc * p["D"]
        out = (y * F.silu(z)) @ p["w_out"]
        state = None
        if return_state:
            # copies, not views of the (B, S, 2*di) projection
            state = {"conv": xi[:, -(K - 1):, :].clone(), "ssm": h_fin}
        return x + out, state

    # --- decode step ----------------------------------------------------------
    xc, conv_state = conv_step(xi[:, 0], cache["conv"], p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    xdb = xc @ p["w_xproj"]
    dt = F.softplus(xdb[..., :dt_rank] @ p["w_dt"] + p["dt_bias"])
    Bc = xdb[..., dt_rank:dt_rank + n].float()
    Cc = xdb[..., dt_rank + n:].float()
    dA = torch.exp(dt.float()[..., None] * A)             # (B,di,n)
    hs = cache["ssm"] * dA + (dt * xc).float()[..., None] * Bc[:, None, :]
    y = torch.einsum("bdn,bn->bd", hs, Cc).to(x.dtype)
    y = y + xc * p["D"]
    out = (y * F.silu(z[:, 0])) @ p["w_out"]
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(hs)
    return x + out[:, None, :], cache


# ---------------------------------------------------------------------------
# mamba2 / SSD (zamba2 backbone)
# ---------------------------------------------------------------------------


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
