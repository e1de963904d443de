"""State-space blocks: the mamba1 selective scan (falcon-mamba) and the
mamba2 SSD chunked scan (the zamba2 backbone layer).

Port of ``repro.models.ssm``.  Both blocks have a full-sequence path
(training / prefill) and an O(1) recurrent decode step.  The mamba2
full-sequence path runs the SSD scan either through
``kernels.ops.ssd_scan`` (``ssm_impl="kernel"``: the CUDA kernel on a CUDA
tensor, its plain version on a CPU tensor) or through that plain version
itself, ``kernels.ssd_scan.ssd_chunked`` (``ssm_impl="torch"``, the
chunked algorithm in plain PyTorch).  The mamba1 scan has no kernel in the
reference either (an ``associative_scan`` in XLA code): here it is the
same log-depth scan in plain PyTorch.

Sharded (DTensor parameters, ``ctx.enabled``): each block gathers its
weights over the FSDP axes (``ShardCtx.gather``).  The mamba1 scan is
channel-local under the ``d_inner`` rule: it runs per shard in
``local_map`` with x, dt and A sharded on ``d_inner`` and ``Bc``/``Cc``
replicated over the model axis (their gradient a partial sum over it).
The mamba2 scan is head-local under the ``ssm_heads`` rule: the kernel's
DTensor strategy runs it, or ``ssd_chunked`` runs per shard under the
same placements.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.launch.mesh import per_shard, redistribute, spec_to_placements
from repro_torch.obs.trace import TRACER

from .config import ArchConfig
from .ops import ShardCtx, rms_norm

# cache lanes of one mamba2 layer
STATE_KEYS = ("conv_x", "conv_B", "conv_C", "ssm")


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C); b: (C,).  On
    DTensors it runs per shard (rows over the batch axes, channels over
    the model axis): channel-local, as the JAX rules shard it; DTensor's
    own rule for the sequence padding is not one to lean on."""
    if isinstance(x, DTensor):
        return _causal_conv_sharded(x, w, b)
    return _causal_conv(x, w, b)


def _causal_conv_sharded(x, w, b) -> torch.Tensor:
    if any(pl == Shard(1) for pl in x.placements):
        raise ValueError("causal_conv needs the whole sequence on each shard")
    chan = [pl == Shard(2) for pl in x.placements]
    w_pl = tuple(Shard(1) if c else Replicate() for c in chan)
    b_pl = tuple(Shard(0) if c else Replicate() for c in chan)
    return per_shard(_causal_conv, out=(x.placements,), ins=(x.placements, w_pl, b_pl),
                     mesh=x.device_mesh)(x, redistribute(w, w_pl), redistribute(b, b_pl))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
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


def _ssm_heads_axis(ctx: ShardCtx, x: torch.Tensor, nh: int):
    """The mesh axis of the SSM heads: the JAX package's ``ssm_heads`` rule
    (the model axis when ``nh`` divides it, else replicated).  The channels
    of ``d_inner`` may shard where the heads cannot; they are gathered
    before they are split into heads."""
    if not isinstance(x, DTensor) or ctx.tp is None:
        return ctx.tp
    mesh = x.device_mesh
    return ctx.tp if nh % mesh.size(mesh.mesh_dim_names.index(ctx.tp)) == 0 else None


def _mamba1_scan_sharded(x, dt, A, Bc, Cc, ctx: ShardCtx):
    """``mamba1_scan`` per shard: channels (``d_inner``) over ``ctx.tp``,
    rows over ``ctx.dp``."""
    mesh = x.device_mesh
    chan = spec_to_placements((ctx.dp, None, ctx.tp), mesh)
    rows = spec_to_placements((ctx.dp, None, None), mesh)
    a_pl = spec_to_placements((ctx.tp, None), mesh)
    state = spec_to_placements((ctx.dp, ctx.tp, None), mesh)
    args = (ctx.act(x, ctx.dp, None, ctx.tp), ctx.act(dt, ctx.dp, None, ctx.tp),
            ctx.act(A, ctx.tp, None), ctx.act(Bc, ctx.dp, None, None),
            ctx.act(Cc, ctx.dp, None, None))
    return per_shard(mamba1_scan, out=(chan, state), ins=(chan, chan, a_pl, rows, rows),
                     mesh=mesh)(*args)


def _ssd_chunked_sharded(x, dt, A, Bc, Cc, chunk: int):
    """``ssd_chunked`` per shard, under the placements the kernel's
    sharding strategy takes (``kernels.ops.ssd_out_placements``): rows over
    the batch axes, heads over the model axis."""
    args = (x, dt, A, Bc, Cc)
    return per_shard(lambda *a: ssd_chunked(*a, chunk), out=kops.ssd_out_placements(*args),
                     ins=tuple(t.placements for t in args), mesh=x.device_mesh)(*args)


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
    p = ctx.gather(p)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    xz = h @ p["w_in"]                                     # (B,S,2*di)
    xi, z = xz[..., :di], xz[..., di:]
    xi = ctx.act(xi, ctx.dp, None, ctx.tp)
    A = -torch.exp(p["A_log"].float())                     # (di,n)

    if cache is None:
        K = ssm.d_conv
        xc = F.silu(causal_conv(xi, p["conv_w"], p["conv_b"]))
        # a partial sum over the channels where they shard: reduced whole
        xdb = ctx.act(xc @ p["w_xproj"], ctx.dp, None, None)   # (B,S,r+2n)
        dt = F.softplus(xdb[..., :dt_rank] @ p["w_dt"] + p["dt_bias"])
        Bc = xdb[..., dt_rank:dt_rank + n].float()
        Cc = xdb[..., dt_rank + n:].float()
        scan = _mamba1_scan_sharded if isinstance(xc, DTensor) and ctx.enabled \
            else lambda *a, ctx: mamba1_scan(*a)
        y, h_fin = scan(xc.float(), dt.float(), A, Bc, Cc, ctx=ctx)
        y = y.to(x.dtype) + xc * p["D"]
        out = (y * F.silu(z)) @ p["w_out"]
        state = None
        if return_state:
            # copies, not views of the (B, S, 2*di) projection
            state = {"conv": xi[:, -(K - 1):, :].clone(), "ssm": h_fin}
        return x + ctx.res(out), state

    # --- decode step ----------------------------------------------------------
    xc, conv_state = conv_step(xi[:, 0], cache["conv"], p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    xdb = ctx.act(xc @ p["w_xproj"], ctx.dp, None)
    dt = F.softplus(xdb[..., :dt_rank] @ p["w_dt"] + p["dt_bias"])
    Bc = xdb[..., dt_rank:dt_rank + n].float()
    Cc = xdb[..., dt_rank + n:].float()
    dA = torch.exp(dt.float()[..., None] * A)             # (B,di,n)
    hs = cache["ssm"] * dA + (dt * xc).float()[..., None] * Bc[:, None, :]
    y = torch.einsum("bdn,bn->bd", hs, Cc).to(x.dtype)
    y = y + xc * p["D"]
    out = ctx.batch((y * F.silu(z[:, 0])) @ p["w_out"])
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(hs)
    return x + out[:, None, :], cache


# ---------------------------------------------------------------------------
# mamba2 / SSD (zamba2 backbone)
# ---------------------------------------------------------------------------


def mamba2_block(p: Dict, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx,
                 cache: Optional[Dict] = None, return_state: bool = False,
                 out_scale: float = 1.0) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Mamba2 block (zamba2's backbone layer, granite-4.0-h's mamba2
    mixer).  x: (B, S, d).  The block's output is multiplied by
    ``out_scale`` before the residual add.

    Prefill with ``return_state``: also returns the decode state, the last
    K-1 pre-conv inputs (``conv_x``, ``conv_B``, ``conv_C``) and the final
    SSM state (``ssm``, float32).  Decode (``cache`` given, S == 1): the
    one-token recurrence; the cache's tensors (views of one layer of the
    pooled cache) are updated IN PLACE, where the JAX package returns new
    arrays, and returned.

    While ``TRACER`` is on, the full-sequence path records an ``ssm.scan``
    span around the scan's enqueue.
    """
    ssm = cfg.ssm
    di, n, hp = cfg.d_inner, ssm.d_state, ssm.head_dim
    nh = di // hp
    p = ctx.gather(p)
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
        heads = _ssm_heads_axis(ctx, xc, nh)
        xc = ctx.act(xc, ctx.dp, None, heads)
        dt = ctx.act(dt, ctx.dp, None, heads)
        A = ctx.act(A, heads)
        xh = xc.reshape(*xc.shape[:2], nh, hp)
        args = (xh.float(), dt.float(), A, Bcv.float(), Ccv.float())
        on = TRACER.on
        if on:
            TRACER.open("ssm.scan")
        if ctx.ssm_impl == "kernel":
            y, h_fin = kops.ssd_scan(*args, chunk=ssm.chunk)
        else:
            scan = _ssd_chunked_sharded if isinstance(xh, DTensor) else ssd_chunked
            y, h_fin = scan(*args, ssm.chunk)
        if on:
            TRACER.close()
        y = y.to(x.dtype) + xh * p["D"][:, None]
        y = y.reshape(*xc.shape[:2], di)
        y = rms_norm(y * F.silu(z), p["out_norm"], cfg.norm_eps)
        state = None
        if return_state:
            state = {"conv_x": xi[:, -(K - 1):, :], "conv_B": Bc[:, -(K - 1):, :],
                     "conv_C": Cc[:, -(K - 1):, :], "ssm": h_fin}
        out = y @ p["w_out"]
        if out_scale != 1.0:
            out = out * out_scale
        return x + ctx.res(out), state

    # --- decode ---------------------------------------------------------------
    xc, conv_x = conv_step(xi[:, 0], cache["conv_x"], p["conv_x_w"], p["conv_x_b"])
    Bcv, conv_B = conv_step(Bc[:, 0], cache["conv_B"], p["conv_B_w"], p["conv_B_b"])
    Ccv, conv_C = conv_step(Cc[:, 0], cache["conv_C"], p["conv_C_w"], p["conv_C_b"])
    xc, Bcv, Ccv = F.silu(xc), F.silu(Bcv), F.silu(Ccv)
    xc = ctx.act(xc, ctx.dp, _ssm_heads_axis(ctx, xc, nh))
    xh = xc.reshape(-1, nh, hp).float()
    dt0 = dt[:, 0].float()                                 # (B,nh)
    dA = torch.exp(dt0 * A)                                # (B,nh)
    hs = cache["ssm"] * dA[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt0, xh, Bcv.float())
    y = torch.einsum("bhpn,bn->bhp", hs, Ccv.float())
    y = y.to(x.dtype) + xh.to(x.dtype) * p["D"][:, None]
    y = y.reshape(-1, di)
    y = rms_norm(y * F.silu(z[:, 0]), p["out_norm"], cfg.norm_eps)
    out = ctx.batch(y @ p["w_out"])
    if out_scale != 1.0:
        out = out * out_scale
    for key, new in (("conv_x", conv_x), ("conv_B", conv_B), ("conv_C", conv_C),
                     ("ssm", hs)):
        cache[key].copy_(new)
    return x + out[:, None, :], cache
