"""Mixture-of-Experts MLP with sort-based (MegaBlocks-style) dispatch.

Port of ``repro.models.moe``.  Tokens are routed top-k over the router's
softmax, sorted by expert into a fixed-capacity buffer (Ep, C, d), run
through the experts as batched products, and combined back with their
gates.  Tokens beyond an expert's capacity are dropped (their residual
passes through).  Padded experts (granite: 40 -> 48) get -1e30 logits:
probability 0, never chosen.

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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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


def _dispatch(xf: torch.Tensor, e_flat: torch.Tensor, Ep: int, C: int, k: int):
    """Sort-based dispatch of one token pool.  xf: (T, d); e_flat: (T*k,)
    expert ids in (token, rank) order.  Returns the expert buffer (Ep, C, d)
    and the sorted routing: order, e_sorted, pos_c, keep."""
    n, d = e_flat.shape[0], xf.shape[1]
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.bincount(e_flat, minlength=Ep)
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=xf.device) - offsets[e_sorted]
    keep = pos < C
    pos_c = torch.where(keep, pos, 0)
    # kept entries have distinct (expert, pos) slots; dropped ones go to a
    # scratch row C that is cut off, so the buffer holds what the
    # reference's scatter-add of zeros for them leaves: the kept tokens
    buf = xf.new_zeros(Ep, C + 1, d)
    buf[e_sorted, torch.where(keep, pos, C)] = xf[order // k]
    return buf[:, :C], order, e_sorted, pos_c, keep


def _experts(buf: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """(..., Ep, C, d) -> (..., Ep, C, d) through each expert's MLP."""
    if cfg.mlp == MLPKind.GATED_SILU:
        h = F.silu(buf @ p["w_gate"]) * (buf @ p["w_up"])
    else:
        h = F.gelu(buf @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


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
    """
    if ctx.moe_row_dispatch:
        return _moe_mlp_rows(p, x, cfg, with_aux=with_aux)
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    Ep, k = moe.n_experts_padded, moe.top_k
    C = int(-(-T * k // Ep) * moe.capacity_factor)  # ceil(T*k/Ep)*cf
    C = max(8, C)

    xf = rms_norm(x, p["ln"], cfg.norm_eps).reshape(T, d)
    logits, probs, gates, idx = _route(xf, p, cfg)
    buf, order, e_sorted, pos_c, keep = _dispatch(xf, idx.reshape(-1), Ep, C, k)
    out_buf = _experts(buf, p, cfg)

    # combine: the float32 contributions in sorted order, then per token
    # its k slots of that order ascending (= its experts ascending)
    gathered = out_buf[e_sorted, pos_c]                       # (T*k, d)
    g_sorted = gates.reshape(-1)[order]
    contrib = torch.where(keep[:, None], gathered * g_sorted[:, None], 0.0)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(T * k, device=x.device)
    slots = torch.sort(slot.view(T, k), dim=-1).values
    yf = _serial_sum(contrib[slots]).to(x.dtype)
    aux = _aux(logits, probs, idx, keep, Ep) if with_aux else {}
    return yf.reshape(B, S, d), aux


def _moe_mlp_rows(
    p: Dict, x: torch.Tensor, cfg: ArchConfig, *, with_aux: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Row dispatch: the sort-based dispatch and combine of each batch row
    on its own, with a per-row capacity padded to a multiple of 8; the
    expert products batched over rows.  Each token's k gated outputs, in
    the compute dtype, are summed over its ranks in float32."""
    moe = cfg.moe
    B, S, d = x.shape
    Ep, k = moe.n_experts_padded, moe.top_k
    C = int(-(-S * k // Ep) * moe.capacity_factor)
    C = max(8, (C + 7) // 8 * 8)

    xn = rms_norm(x, p["ln"], cfg.norm_eps)                  # (B, S, d)
    logits, probs, gates, idx = _route(xn, p, cfg)           # idx (B, S, k)
    bufs, metas = [], []
    for b in range(B):
        e_flat = idx[b].reshape(-1)
        buf, order, _, pos_c, keep = _dispatch(xn[b], e_flat, Ep, C, k)
        # token-order routing tables for the scatter-free combine
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=x.device)
        bufs.append(buf)
        metas.append((e_flat, pos_c[inv], keep[inv]))
    out_buf = _experts(torch.stack(bufs), p, cfg)            # (B, Ep, C, d)
    gr = gates.to(out_buf.dtype)
    ys = []
    for b, (e_tok, pos_tok, keep_tok) in enumerate(metas):
        gathered = out_buf[b][e_tok, pos_tok]                # (S*k, d)
        contrib = torch.where(keep_tok[:, None],
                              gathered * gr[b].reshape(-1)[:, None], 0.0)
        ys.append(_serial_sum(contrib.view(S, k, d)).to(out_buf.dtype))
    aux = {}
    if with_aux:
        aux = _aux(logits, probs, idx, torch.stack([m[2] for m in metas]), Ep)
    return torch.stack(ys), aux
