"""Training and serving step factories.

``make_train_step`` builds (params, opt_state, batch) -> (params,
opt_state, metrics), the port of ``repro.train.steps.make_train_step``:
  * gradient accumulation over micro-batches (a loop in micro-batch order,
    the reference's ``lax.scan``) in ``tuning.accum_dtype``;
  * per-layer remat (``torch.utils.checkpoint``) when ``tuning.remat``;
  * MoE auxiliary losses folded into the objective;
  * AdamW with clipping/schedule, optional int8 error-feedback compression.
Gradients come from ``torch.autograd.grad`` on the float32 leaves; the
compute-dtype cast sits inside the differentiated function.  The step runs
the plain attention and SSD paths (``TRAIN_CTX``), as the JAX step runs
XLA's: the hand-written kernels have no backward.

Sharded: given a ``ctx`` with ``enabled`` and DTensor parameters, optimizer
state and batch (``launch.plan``'s sharded plans), every step is the SPMD
program on the mesh.  Micro-batch ``i`` is the ``i``-th slice of each
rank's local rows, so every micro-batch keeps its data shard (the tokens
of a micro-batch are not the global batch's contiguous rows, as in the
JAX step's reshape, but the same tokens enter the summed gradient); each
gradient leaf is brought to its parameter's placements before it is
accumulated, as the JAX step's carry keeps the parameters' sharding.

``make_prefill_step`` / ``make_serve_step`` build the serving entry points:
the full-sequence cache build and the one-token decode step.  Parameters
come in the compute dtype already (``models.model.cast_params``, as the
engine casts them once), or the step casts them when given the cell's
``tuning`` (as the JAX steps do on every call: a dry run's plan).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor import zeros as distributed_zeros

from repro_torch.launch.mesh import plain_tensors_replicated, redistribute
from repro_torch.models.config import ArchConfig, CellTuning, Family
from repro_torch.models.model import DECODE, PREFILL, TRAIN, backbone, cast_params, forward, head
from repro_torch.models.ops import NOSHARD, ShardCtx, softmax_cross_entropy
from repro_torch.optim import adamw
from repro_torch.tree import leaves, unflatten

LOAD_BALANCE_COEF = 0.01
ROUTER_Z_COEF = 1e-4
Z_LOSS_COEF = 1e-4

# the plain paths: the counterpart of the JAX step's default context, whose
# attention and SSD run in XLA, never through a Pallas kernel
TRAIN_CTX = ShardCtx(attention_impl="torch", ssm_impl="torch")


def loss_fn(
    params: Any,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    ctx: ShardCtx,
    tuning: CellTuning,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics).  Float32 leaves are cast to ``tuning.compute_dtype``
    here, inside the graph, so their gradients reach the float32 leaves."""
    p = cast_params(params, getattr(torch, tuning.compute_dtype))
    logits, _, aux = forward(p, cfg, batch, ctx=ctx, mode=TRAIN, remat=tuning.remat)
    ce, zloss = softmax_cross_entropy(logits, batch["labels"], cfg.vocab)
    loss = ce + Z_LOSS_COEF * zloss
    metrics = {"ce": ce, "z_loss": zloss}
    if aux:
        loss = loss + LOAD_BALANCE_COEF * aux["load_balance"] \
            + ROUTER_Z_COEF * aux["router_z"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.OptimizerConfig,
    tuning: CellTuning,
    ctx: ShardCtx = TRAIN_CTX,
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics with the JAX step's keys (``ce``, ``z_loss``,
    ``loss``, the MoE aux keys, ``grad_norm``, ``lr``).  The batch's leading
    axis splits into ``tuning.num_microbatches`` consecutive micro-batches.
    The inputs are not modified."""
    n_micro = tuning.num_microbatches
    accum_dtype = getattr(torch, tuning.accum_dtype)
    keys = _metric_keys(cfg)

    def train_step(params, opt_state, batch):
        gb = batch["tokens"].shape[0]
        if gb % n_micro:
            raise ValueError(f"global batch {gb} does not split into "
                             f"{n_micro} micro-batches")
        with _dtensor_scope(params):
            flat = leaves(params)
            gsum = [_zeros(p, accum_dtype) for p in flat]
            msum = {k: _scalar_zeros(flat[0]) for k in keys}
            for i in range(n_micro):
                mb = {k: _micro_batch(v, i, n_micro) for k, v in batch.items()}
                with torch.enable_grad():
                    req = [p.detach().requires_grad_() for p in flat]
                    loss, metrics = loss_fn(unflatten(params, req), cfg, mb, ctx, tuning)
                    grads = torch.autograd.grad(loss, req)
                for acc, g, p in zip(gsum, grads, flat):
                    if isinstance(g, DTensor):
                        g = redistribute(g, p.placements)
                    acc += g.to(accum_dtype)
                del grads
                for k in keys:
                    msum[k] += metrics[k].detach()
            # tensor divisors: on the card ``tensor / number`` multiplies by the
            # number's reciprocal
            for acc in gsum:
                acc /= torch.full((), n_micro, dtype=accum_dtype, device=acc.device)
            n = torch.full((), n_micro, dtype=torch.float32, device=flat[0].device)
            metrics = {k: v / n for k, v in msum.items()}
            params, opt_state, opt_metrics = adamw.apply(
                opt_cfg, params, unflatten(params, gsum), opt_state)
            metrics.update(opt_metrics)
            return params, opt_state, metrics

    return train_step


def _dtensor_scope(tree):
    """``launch.mesh.plain_tensors_replicated`` where ``tree`` holds DTensors: plain tensors
    made inside a sharded step (divisors, masks) count as replicated."""
    if isinstance(leaves(tree)[0], DTensor):
        return plain_tensors_replicated()
    return contextlib.nullcontext()


def _zeros(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``p``'s shape in ``dtype``: on ``p``'s mesh with its
    placements for a DTensor."""
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _scalar_zeros(like: torch.Tensor) -> torch.Tensor:
    """A float32 zero on ``like``'s device, replicated over ``like``'s mesh
    for a DTensor."""
    if not isinstance(like, DTensor):
        return torch.zeros((), dtype=torch.float32, device=like.device)
    mesh = like.device_mesh
    return distributed_zeros((), device_mesh=mesh, placements=[Replicate()] * mesh.ndim)


def _micro_batch(v: torch.Tensor, i: int, n_micro: int) -> torch.Tensor:
    """Micro-batch ``i`` of ``n_micro`` of a batch leaf: consecutive global
    rows for a plain tensor, consecutive rows of each rank's local rows for
    a DTensor (which keeps its placements)."""
    if isinstance(v, DTensor):
        loc = v.to_local()
        m = loc.shape[0] // n_micro
        return DTensor.from_local(loc[i * m:(i + 1) * m], v.device_mesh,
                                  v.placements, run_check=False)
    m = v.shape[0] // n_micro
    return v[i * m:(i + 1) * m]


def _metric_keys(cfg: ArchConfig) -> List[str]:
    keys = ["ce", "z_loss", "loss"]
    if cfg.family == Family.MOE:
        keys += ["drop_fraction", "load_balance", "router_z"]
    return keys


def make_prefill_step(cfg: ArchConfig, ctx: ShardCtx = NOSHARD, *,
                      tuning: Optional[CellTuning] = None) -> Callable:
    """prefill(params, batch, last=None) -> (last-token logits (B, Vp), cache).

    ``batch`` holds ``tokens`` and, for the encoder-decoder family,
    ``enc_embeds`` (B, enc_len, d), which ``backbone`` reads.  Only the
    last position goes through the vocab head: the logits are the same as
    the JAX step's ``logits[:, -1]`` without the (B, S, Vp) tensor it
    builds first.  ``last``, a (B,) int64 tensor on the tokens' device,
    names each row's last real position instead (a prompt padded at its
    end).  With ``tuning``, float32 parameters are cast to
    ``tuning.compute_dtype`` inside the step, as the JAX step casts them;
    without it they are used as they come."""

    def prefill_step(params, batch, last=None):
        with _no_autograd(params):
            p = _compute_params(params, tuning)
            h, cache, _ = backbone(p, cfg, batch, ctx=ctx, mode=PREFILL)
            if last is None:
                h = h[:, -1]
            else:
                h = h[torch.arange(h.shape[0], device=h.device), last]
            return head(p, cfg, h, ctx), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, ctx: ShardCtx = NOSHARD, *,
                    tuning: Optional[CellTuning] = None) -> Callable:
    """serve_step(params, cache, tokens (B,1)) -> (logits (B,Vp), cache).

    One new token against a KV cache of length max_len; the cache's k/v
    are updated in place and returned.  ``tuning`` as in
    ``make_prefill_step``."""

    def serve_step(params, cache, tokens):
        with _no_autograd(params):
            p = _compute_params(params, tuning)
            h, new_cache, _ = backbone(p, cfg, {"tokens": tokens}, ctx=ctx,
                                       mode=DECODE, cache=cache)
            return head(p, cfg, h[:, -1], ctx), new_cache

    return serve_step


def _no_autograd(params):
    """``inference_mode`` for plain tensors; ``no_grad`` for DTensors, whose
    views (a layer of a stacked weight) cannot be made of inference
    tensors."""
    if isinstance(leaves(params)[0], DTensor):
        return torch.no_grad()
    return torch.inference_mode()


def _compute_params(params, tuning: Optional[CellTuning]):
    if tuning is None:
        return params
    return cast_params(params, getattr(torch, tuning.compute_dtype))
