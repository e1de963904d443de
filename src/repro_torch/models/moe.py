"""Mixture-of-Experts MLP with sort-based (MegaBlocks-style) dispatch.

Port of ``repro.models.moe``.  Tokens are routed top-k over the router's
softmax, sorted by expert into a fixed-capacity buffer (Ep, C, d), run
through the experts as batched products, and combined back with their
gates.  Tokens beyond an expert's capacity are dropped (their residual
passes through).  Padded experts (granite: 40 -> 48) get -1e30 logits:
probability 0, never chosen.  With ``MoEConfig.shared_d_ff`` (granite-4.0-h)
every token also goes through one SwiGLU shared expert on the same normed
input, whose output is added to the routed sum.

Where eager PyTorch on the card would otherwise decide differently from
the reference, or differently from run to run:
  * top-k: ``jax.lax.top_k`` puts the lower index first on ties;
    ``torch.topk`` promises no order, so a stable descending sort is used;
  * dispatch: ``argsort`` is stable, so capacity keeps the same tokens;
  * combine: the reference's ``yf.at[tok_sorted].add(contrib)`` promotes to
    float32, adds each token's contributions serially in the sorted
    (expert-ascending) order and rounds once to ``x.dtype``.  Here the
    contributions are gathered per token in that order and summed as a
    fixed sequence of float32 adds, never by atomics, so every run on the
    card gives the same bits.

Sharded (DTensor parameters, ``ctx.enabled``): experts over the model
axis (``ctx.act(buf, tp, ...)``, the JAX package's EP constraints), the
router gathered whole.  Routing stays in DTensor's ops, so the aux losses'
gradients need no care; the sort-based dispatch, the expert products and
the combine, which DTensor has no rule for, run per shard in
``local_map``:
  * global dispatch: the token pool is replicated first (a global sort
    needs every token, as XLA's does), and each rank fills its experts'
    rows of the buffer (the routing is the whole pool's on every rank);
  * row dispatch: each data shard dispatches its own rows;
  * combine: each rank adds the contributions of its own experts, a
    partial sum over the model axis that the residual constraint reduces
    (the (T, d) collective the JAX comment asks XLA for, not (T*k, d)).
    The gates' gradient is partial over that axis too.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.launch.mesh import per_shard, redistribute, spec_to_placements
from repro_torch.obs.trace import TRACER

from .config import ArchConfig, MLPKind
from .ops import ShardCtx, rms_norm

NEG_LOGIT = -1e30


def _route(xn: torch.Tensor, p: Dict, cfg: ArchConfig):
    """Router logits (float32, padded experts masked), softmax, and the
    top-k gates (renormalised) and expert ids; ``xn``'s last dim is d."""
    moe = cfg.moe
    E, Ep, k = moe.n_experts, moe.n_experts_padded, moe.top_k
    logits = (xn @ p["router"]).float()
    if Ep > E:
        logits[..., E:] = NEG_LOGIT
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: ties keep the lower index first, as lax.top_k
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def _dispatch(xf: torch.Tensor, e_flat: torch.Tensor, Ep: int, C: int, k: int,
              first: int = 0, n_local: int = None):
    """Sort-based dispatch of one token pool.  xf: (T, d); e_flat: (T*k,)
    expert ids in (token, rank) order.  Returns the expert buffer (Ep, C, d)
    and the sorted routing: order, e_sorted, pos_c, keep.  With ``n_local``
    the buffer holds only experts ``first .. first + n_local - 1``
    (n_local, C, d), the rows of one expert-parallel shard; the routing is
    the whole pool's."""
    n, d = e_flat.shape[0], xf.shape[1]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    # a fixed-shape count (bincount's output shape depends on the data, so
    # it does not trace under FakeTensorMode)
    counts = torch.zeros(Ep, dtype=e_flat.dtype, device=e_flat.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=xf.device) - offsets[e_sorted]
    keep = pos < C
    pos_c = torch.where(keep, pos, 0)
    # kept entries have distinct (expert, pos) slots; dropped ones go to a
    # scratch row C that is cut off, so the buffer holds what the
    # reference's scatter-add of zeros for them leaves: the kept tokens
    if n_local is None:
        buf = xf.new_zeros(Ep, C + 1, d)
        buf[e_sorted, torch.where(keep, pos, C)] = xf[order // k]
        return buf[:, :C], order, e_sorted, pos_c, keep
    e_local = e_sorted - first
    mine = keep & (e_local >= 0) & (e_local < n_local)
    buf = xf.new_zeros(n_local, C + 1, d)
    buf[e_local.clamp(0, n_local - 1), torch.where(mine, pos, C)] = xf[order // k]
    return buf[:, :C], order, e_sorted, pos_c, keep


def _capacity(moe, tokens: int, rows: bool) -> int:
    """Each expert's slots for a pool of ``tokens``: ceil(tokens k / Ep)
    times the capacity factor, at least 8; a row's (``rows``) padded up to
    a multiple of 8."""
    C = int(-(-tokens * moe.top_k // moe.n_experts_padded) * moe.capacity_factor)
    return max(8, (C + 7) // 8 * 8) if rows else max(8, C)


def _dispatch_rows(xr: torch.Tensor, ir: torch.Tensor, Ep: int, C: int, k: int,
                   first: int = 0, n_local: int = None):
    """``_dispatch`` of each row of xr (R, N, d) with its ids ir (R, N, k)
    on its own.  Returns the buffers (R, Ep or n_local, C, d) and the
    token-order routing tables e_tok, pos_tok, keep_tok (R, N*k) that
    ``_combine_local`` reads."""
    bufs, metas = [], []
    for r in range(xr.shape[0]):
        e_flat = ir[r].reshape(-1)
        buf, order, _, pos_c, keep = _dispatch(xr[r], e_flat, Ep, C, k, first, n_local)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=xr.device)
        bufs.append(buf)
        metas.append((e_flat, pos_c[inv], keep[inv]))
    return (torch.stack(bufs),) + tuple(torch.stack(m) for m in zip(*metas))


def _experts(buf: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """(..., Ep, C, d) -> (..., Ep, C, d) through each expert's MLP."""
    if cfg.mlp == MLPKind.GATED_SILU:
        h = F.silu(buf @ p["w_gate"]) * (buf @ p["w_up"])
    else:
        h = F.gelu(buf @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


def _shared(xn: torch.Tensor, p: Dict) -> torch.Tensor:
    """The shared expert: silu(xn Sg) * (xn Su), then Sd."""
    return (F.silu(xn @ p["shared_gate"]) * (xn @ p["shared_up"])) @ p["shared_down"]


def _serial_sum(c: torch.Tensor) -> torch.Tensor:
    """Sum (N, k, d) over k as k - 1 float32 adds in index order."""
    acc = c[:, 0].float()
    for j in range(1, c.shape[1]):
        acc = acc + c[:, j]
    return acc


def _aux(logits, probs, idx, keep, Ep) -> Dict[str, torch.Tensor]:
    """Load balance (top-1 share x mean probability), router z-loss and
    the dropped fraction, over every routed token."""
    me = F.one_hot(idx[..., 0].reshape(-1), Ep).float().mean(0)
    pe = probs.reshape(-1, Ep).mean(0)
    z = torch.logsumexp(logits, dim=-1)
    return {
        "load_balance": Ep * torch.sum(me * pe),
        "router_z": torch.mean(torch.square(z)),
        "drop_fraction": 1.0 - torch.mean(keep.float()),
    }


def moe_mlp(
    p: Dict, x: torch.Tensor, cfg: ArchConfig, ctx: ShardCtx, *,
    with_aux: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), aux-loss dict.  Pre-norm block: the
    residual stream is rms-normed before the router and experts see it.

    The global sort (one token pool of T = B*S slots) by default; with
    ``ctx.moe_row_dispatch`` the per-row capacity of ``_moe_mlp_rows``.
    ``with_aux=False`` skips the aux losses (the serving steps discard
    them) and returns ``{}``.

    While ``TRACER`` is on, every layout records four spans of the host's
    enqueue: ``moe.route`` (the norm and the router), ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine``, and a fifth, ``moe.shared``, for
    the shared expert where there is one.
    """
    if ctx.enabled and isinstance(x, DTensor):
        return _moe_mlp_sharded(ctx.gather(p), x, cfg, ctx, with_aux=with_aux)
    if ctx.moe_row_dispatch:
        return _moe_mlp_rows(p, x, cfg, with_aux=with_aux)
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    Ep, k = moe.n_experts_padded, moe.top_k
    C = _capacity(moe, T, rows=False)

    tr = TRACER
    on = tr.on
    if on:
        tr.open("moe.route")
    xf = rms_norm(x, p["ln"], cfg.norm_eps).reshape(T, d)
    logits, probs, gates, idx = _route(xf, p, cfg)
    if on:
        tr.then("moe.dispatch")
    buf, order, e_sorted, pos_c, keep = _dispatch(xf, idx.reshape(-1), Ep, C, k)
    if on:
        tr.then("moe.experts")
    out_buf = _experts(buf, p, cfg)
    if on:
        tr.then("moe.combine")

    # combine: the float32 contributions in sorted order, then per token
    # its k slots of that order ascending (= its experts ascending)
    gathered = out_buf[e_sorted, pos_c]                       # (T*k, d)
    g_sorted = gates.reshape(-1)[order]
    contrib = torch.where(keep[:, None], gathered * g_sorted[:, None], 0.0)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(T * k, device=x.device)
    slots = torch.sort(slot.view(T, k), dim=-1).values
    yf = _serial_sum(contrib[slots]).to(x.dtype)
    if moe.shared_d_ff:
        if on:
            tr.then("moe.shared")
        yf = yf + _shared(xf, p)
    if on:
        tr.close()
    aux = _aux(logits, probs, idx, keep, Ep) if with_aux else {}
    return yf.reshape(B, S, d), aux


def _moe_mlp_rows(
    p: Dict, x: torch.Tensor, cfg: ArchConfig, *, with_aux: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Row dispatch: the sort-based dispatch and combine of each batch row
    on its own (``_dispatch_rows``, ``_combine_local``), with a per-row
    capacity padded to a multiple of 8; the expert products batched over
    rows.  Each token's k gated outputs, in the compute dtype, are summed
    over its ranks in float32."""
    moe = cfg.moe
    B, S, d = x.shape
    Ep, k = moe.n_experts_padded, moe.top_k
    C = _capacity(moe, S, rows=True)

    tr = TRACER
    on = tr.on
    if on:
        tr.open("moe.route")
    xn = rms_norm(x, p["ln"], cfg.norm_eps)                  # (B, S, d)
    logits, probs, gates, idx = _route(xn, p, cfg)           # idx (B, S, k)
    if on:
        tr.then("moe.dispatch")
    buf, e_tok, pos_tok, keep_tok = _dispatch_rows(xn, idx, Ep, C, k)
    if on:
        tr.then("moe.experts")
    out_buf = _experts(buf, p, cfg)                          # (B, Ep, C, d)
    if on:
        tr.then("moe.combine")
    y = _combine_local(out_buf, gates.to(out_buf.dtype), e_tok, pos_tok, keep_tok, 0, S, k)
    if moe.shared_d_ff:
        if on:
            tr.then("moe.shared")
        y = y + _shared(xn, p)
    if on:
        tr.close()
    aux = _aux(logits, probs, idx, keep_tok, Ep) if with_aux else {}
    return y, aux


def _combine_local(out_buf, gates, e_tok, pos_tok, keep_tok, first, S, k):
    """Per row of ``out_buf`` (R, E_l, C, d): each token's gated outputs of
    the experts ``first .. first + E_l - 1`` (the others add 0), summed
    over its ranks in float32; (R, S, d) in ``out_buf``'s dtype.
    e_tok/pos_tok/keep_tok: (R, S*k) in token order."""
    El = out_buf.shape[1]
    local = e_tok - first
    mine = keep_tok & (local >= 0) & (local < El)
    ys = []
    for r in range(out_buf.shape[0]):
        gathered = out_buf[r][local[r].clamp(0, El - 1), pos_tok[r]]   # (S*k, d)
        contrib = torch.where(mine[r][:, None],
                              gathered * gates[r].reshape(-1)[:, None], 0.0)
        ys.append(_serial_sum(contrib.view(S, k, -1)).to(out_buf.dtype))
    return torch.stack(ys)


def _moe_mlp_sharded(p, x, cfg, ctx, *, with_aux):
    """``moe_mlp`` on DTensors (module docstring).  The global dispatch
    is one row of all B*S tokens; the row dispatch one row per batch row,
    each on its data shard.  Capacity as in ``moe_mlp`` /
    ``_moe_mlp_rows``."""
    moe = cfg.moe
    if moe.shared_d_ff:
        raise NotImplementedError("a shared expert on a mesh")
    B, S, d = x.shape
    Ep, k = moe.n_experts_padded, moe.top_k
    mesh = x.device_mesh
    rows = ctx.moe_row_dispatch
    dp, per_row = (ctx.dp, S) if rows else (None, B * S)
    C = _capacity(moe, per_row, rows)
    full = [Replicate()] * mesh.ndim
    tok = spec_to_placements((dp, None, None), mesh)      # (B, S, .) on dp
    tr = TRACER
    on = tr.on
    if on:
        tr.open("moe.route")
    xn = ctx.act(rms_norm(x, p["ln"], cfg.norm_eps), dp, None, None)
    # routing per shard too: DTensor's backward of the router product may
    # shard its token dim, which no view back to (B, S) can follow
    logits, probs, gates, idx = per_shard(
        lambda xl, rl: _route(xl, {"router": rl}, cfg), out=(tok,) * 4,
        ins=(tok, full), mesh=mesh)(xn, redistribute(p["router"], full))

    # EP shard: each rank fills only its experts' rows; experts that do not
    # divide the model axis stay whole on every rank, as the ``experts``
    # rule keeps their weights
    m = mesh.mesh_dim_names.index(ctx.tp) if ctx.tp is not None else None
    ep_ax = ctx.tp if m is not None and Ep % mesh.size(m) == 0 else None
    El = Ep // mesh.size(m) if ep_ax else Ep
    first = mesh.get_local_rank(m) * El if ep_ax else 0
    ep = spec_to_placements((dp, ep_ax, None, None), mesh)

    def dispatch(xl, il):
        return _dispatch_rows(xl.reshape(-1, per_row, d), il.reshape(-1, per_row, k),
                              Ep, C, k, first, El)

    row2 = spec_to_placements((dp, None), mesh)
    if on:
        tr.then("moe.dispatch")
    buf, e_tok, pos_tok, keep_tok = per_shard(
        dispatch, out=(ep, row2, row2, row2), ins=(tok, tok), mesh=mesh)(xn, idx)
    if on:
        tr.then("moe.experts")
    w_pl = spec_to_placements((ep_ax, None, None), mesh)
    names = [name for name in ("w_gate", "w_up", "w_down") if name in p]
    out_buf = per_shard(
        lambda b, *ws: _experts(b, dict(zip(names, ws)), cfg), out=(ep,),
        ins=(ep,) + (w_pl,) * len(names), mesh=mesh,
    )(buf, *(redistribute(p[name], w_pl) for name in names))
    if on:
        tr.then("moe.combine")
    partial = tuple(Partial() if ep_ax and i == m else pl for i, pl in enumerate(tok))

    def combine(ob, g, e, pc, kp):
        y = _combine_local(ob, g.reshape(-1, per_row, k), e, pc, kp, first, per_row, k)
        return y.reshape(-1, S, d)

    y = per_shard(combine, out=(partial,), ins=(ep, tok, row2, row2, row2),
                  mesh=mesh)(out_buf, gates.to(out_buf.dtype), e_tok, pos_tok, keep_tok)
    y = ctx.res(y)
    if on:
        tr.close()
    aux = _aux(logits, probs, idx, keep_tok, Ep) if with_aux else {}
    return y, aux
