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

``make_prefill_step`` / ``make_serve_step`` build the serving entry points:
the full-sequence cache build and the one-token decode step.  Parameters
come in the compute dtype already (``models.model.cast_params``, as the
engine casts them once), or the step casts them when given the cell's
``tuning`` (as the JAX steps do on every call: a dry run's plan).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

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
        mb_size = gb // n_micro
        flat = leaves(params)
        gsum = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                for p in flat]
        msum = {k: torch.zeros((), dtype=torch.float32, device=flat[0].device)
                for k in keys}
        for i in range(n_micro):
            mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
            with torch.enable_grad():
                req = [p.detach().requires_grad_() for p in flat]
                loss, metrics = loss_fn(unflatten(params, req), cfg, mb, ctx, tuning)
                grads = torch.autograd.grad(loss, req)
            for acc, g in zip(gsum, grads):
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


def _metric_keys(cfg: ArchConfig) -> List[str]:
    keys = ["ce", "z_loss", "loss"]
    if cfg.family == Family.MOE:
        keys += ["drop_fraction", "load_balance", "router_z"]
    return keys


def make_prefill_step(cfg: ArchConfig, ctx: ShardCtx = NOSHARD, *,
                      tuning: Optional[CellTuning] = None) -> Callable:
    """prefill(params, batch) -> (last-token logits (B, Vp), cache).

    ``batch`` holds ``tokens`` and, for the encoder-decoder family,
    ``enc_embeds`` (B, enc_len, d), which ``backbone`` reads.  Only the
    last position goes through the vocab head: the logits are the same as
    the JAX step's ``logits[:, -1]`` without the (B, S, Vp) tensor it
    builds first.  With ``tuning``, float32 parameters are cast to
    ``tuning.compute_dtype`` inside the step, as the JAX step casts them;
    without it they are used as they come."""

    @torch.inference_mode()
    def prefill_step(params, batch):
        p = _compute_params(params, tuning)
        h, cache, _ = backbone(p, cfg, batch, ctx=ctx, mode=PREFILL)
        return head(p, cfg, h[:, -1]), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, ctx: ShardCtx = NOSHARD, *,
                    tuning: Optional[CellTuning] = None) -> Callable:
    """serve_step(params, cache, tokens (B,1)) -> (logits (B,Vp), cache).

    One new token against a KV cache of length max_len; the cache's k/v
    are updated in place and returned.  ``tuning`` as in
    ``make_prefill_step``."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens):
        p = _compute_params(params, tuning)
        h, new_cache, _ = backbone(p, cfg, {"tokens": tokens}, ctx=ctx,
                                   mode=DECODE, cache=cache)
        return head(p, cfg, h[:, -1]), new_cache

    return serve_step


def _compute_params(params, tuning: Optional[CellTuning]):
    if tuning is None:
        return params
    return cast_params(params, getattr(torch, tuning.compute_dtype))
