"""AdamW with cosine schedule, global-norm clipping, configurable
optimizer-state dtype (bf16 moments for 100B+ models), and optional int8
error-feedback gradient compression.

Port of ``repro.optim.adamw``, with its arithmetic: float32 moments, bias
correction by ``b1 ** step``, decay only on leaves with ``ndim >= 2``, the
clip scale ``min(1, clip / (gnorm + 1e-9))``.  Trees are walked in
``jax.tree``'s order (``repro_torch.tree``), so the gradient norm sums its
leaves in the same order.  Not ``torch.optim.AdamW``, whose update differs
(decay applied before the step, no clip, another bias correction).

The compression path is the standard error-feedback scheme:
  q = quantize(g + e);  e' = (g + e) - dequant(q);  update uses dequant(q)
so the quantisation error is re-injected on the next step.

On DTensor leaves (a sharded train step) the update is per shard: the
moments and error residuals carry their parameters' placements, and the
two reductions over whole tensors, the global norm and the int8 scale's
max, are made whole by an explicit all-reduce.

Every division here is of two tensors: ``number / tensor`` multiplies by
the tensor's reciprocal, and on the card so does ``tensor / number``, which
rounds twice where the reference divides once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.mesh import per_shard, redistribute
from repro_torch.tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"      # "float32" | "bfloat16"
    compress_grads: bool = False      # int8 error-feedback DP compression


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any
    error: Any   # error-feedback residual (zeros when compression is off)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_frac``; float32."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1), step),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(cfg: OptimizerConfig, params: Any) -> OptState:
    """Zero moments in ``state_dtype`` and a zero step, on the params' device."""
    dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32
    mu = tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
    nu = tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params)
    err = tree_map(
        lambda p: torch.zeros(p.shape if cfg.compress_grads else (),
                              dtype=torch.float32, device=p.device),
        params)
    device = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=mu, nu=nu, error=err)


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A reduction over a sharded DTensor (a partial max or sum on the mesh
    dims its input was split over) made whole on every rank, the
    all-reduce XLA inserts for the same reduction; a plain tensor as it
    is."""
    if not isinstance(t, DTensor):
        return t
    return redistribute(t, (Replicate(),) * t.device_mesh.ndim)


def _quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _replicated(torch.max(torch.abs(g))) / _f32(127.0, g) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_gradient(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 round trip: (dequantised g + err in g's dtype,
    the new residual in float32)."""
    t = g.float() + err
    q, scale = _quantize_int8(t)
    deq = q.float() * scale
    return deq.to(g.dtype), t - deq


def global_norm(tree: Any) -> torch.Tensor:
    """The norm of every leaf together.  On DTensor leaves each rank sums
    the squares of its shards (partial sums over the mesh dims the leaf is
    split on, a replicated leaf's sum counted on one rank of the others),
    and one all-reduce makes the total whole."""
    flat = leaves(tree)
    if not isinstance(flat[0], DTensor):
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in flat))
    mesh = flat[0].device_mesh
    placements = [x.placements for x in flat]
    # a leaf replicated on a mesh dim is counted by that dim's rank 0
    owner = [all(mesh.get_local_rank(m) == 0 for m, pl in enumerate(p)
                 if not isinstance(pl, Shard)) for p in placements]

    def local_sum(*xs):
        sums = [torch.sum(torch.square(x.float())) for x in xs]
        return sum(s if own else torch.zeros_like(s) for s, own in zip(sums, owner))

    total = per_shard(local_sum, out=((Partial(),) * mesh.ndim,),
                      ins=tuple(placements), mesh=mesh)(*flat)
    return torch.sqrt(_replicated(total))


def _update(cfg: OptimizerConfig, p, g, m, v, scale, lr, b1c, b2c):
    """One leaf: (new p, new m, new v) in their own dtypes.  In-place
    operations only on fresh temporaries, each rounding as the reference's
    expression does."""
    g32 = g.float() * scale
    m32 = m.float() * cfg.b1
    m32 += (1 - cfg.b1) * g32
    v32 = v.float() * cfg.b2
    v32 += (1 - cfg.b2) * g32.square_()
    den = torch.sqrt(v32 / b2c)
    den += cfg.eps
    upd = m32 / b1c
    upd /= den
    if p.ndim >= 2:
        upd += cfg.weight_decay * p.float()
    upd *= lr
    return (p.float() - upd).to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def apply(
    cfg: OptimizerConfig,
    params: Any,
    grads: Any,
    state: OptState,
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).  The
    inputs are not modified."""
    step = state.step + 1

    error = state.error
    if cfg.compress_grads:
        pairs = [compress_gradient(g, e)
                 for g, e in zip(leaves(grads), leaves(state.error))]
        grads = unflatten(grads, [p[0] for p in pairs])
        error = unflatten(state.error, [p[1] for p in pairs])

    gnorm = global_norm(grads)
    scale = torch.clamp(_f32(cfg.clip_norm, gnorm) / (gnorm + 1e-9), max=1.0)

    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    b2c = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)

    out = [_update(cfg, p, g, m, v, scale, lr, b1c, b2c)
           for p, g, m, v in zip(leaves(params), leaves(grads),
                                 leaves(state.mu), leaves(state.nu))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(state.mu, [o[1] for o in out])
    new_v = unflatten(state.nu, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(step, new_m, new_v, error), metrics
