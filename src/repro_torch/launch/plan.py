"""Cell plans: everything needed to count one (arch x shape) cell on one card.

The port of ``repro.launch.plan``.  A ``CellPlan`` bundles the step
function and a function that makes its abstract arguments: empty tensors of the
cell's full shapes, made under ``FakeTensorMode`` so that nothing is
allocated.  ``launch.dryrun`` counts the step on them (``launch.cost``),
where the JAX package lowers and compiles it; ``chip_smoke.py`` also runs
a cell's step on real tensors of the same shapes.

One card: ``chips`` is 1, and there are no in or out shardings and no
multi-pod mesh (``multi_pod=True`` raises): those wait for the
multi-device slice (ROADMAP queue 1, item 6).  The tuning flags that only
shape a sharding (``seq_parallel_attn``, ``seq_parallel_residual``) are
kept in ``CellTuning`` and change nothing here.  Tokens and labels are
int32, as in the JAX package.  A train cell's step runs the plain
attention and SSD paths (``train.steps.TRAIN_CTX``: the kernels have no
backward); a prefill or decode cell's step runs ``tuning.attention_impl``
and ``tuning.ssm_impl``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.models.config import (
    ArchConfig, CellTuning, Kind, SHAPES, ShapeConfig, cell_is_supported,
    cell_tuning,
)
from repro_torch.models.model import cache_schema
from repro_torch.models.ops import ShardCtx
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import abstract_from_schema
from repro_torch.optim import adamw
from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.tree import leaves, tree_map

# Beyond-paper optimized tuning per architecture family (the JAX package's
# hillclimbed configurations).  ``build_plan(..., optimized=True)`` applies
# them (explicit tuning_overrides still win).
OPTIMIZED_OVERRIDES = {
    # heads % 16 != 0 -> sequence-parallel attention (replicated-attention fix)
    "qwen2-1.5b": {"seq_parallel_attn": True},
    "whisper-large-v3": {"seq_parallel_attn": True},
    "granite-moe-3b-a800m": {"seq_parallel_attn": True,
                             "moe_row_dispatch": True},
    "phi3.5-moe-42b-a6.6b": {"moe_row_dispatch": True},
    # big dense: seq-parallel residual stream (fits + halves TP collectives)
    "nemotron-4-340b": {"seq_parallel_residual": True,
                        "param_dtype": "bfloat16"},
    # full-attention archs with divisible heads: recompute chunk scores
    # instead of stacking S^2 softmax residuals in the backward
    "yi-6b": {"remat_chunk_attn": True},
    "yi-9b": {"remat_chunk_attn": True},
    "llava-next-mistral-7b": {"remat_chunk_attn": True},
}


@dataclass
class CellPlan:
    arch: ArchConfig
    shape: ShapeConfig
    tuning: CellTuning
    ctx: ShardCtx
    step_fn: Callable
    # device -> the step's arguments as empty tensors; call it under
    # FakeTensorMode (a real call allocates the whole cell)
    abstract_args: Callable[[Any], Tuple]
    chips: int
    model_flops: float
    opt_cfg: Optional[adamw.OptimizerConfig] = None
    device: torch.device = torch.device("cuda")


def build_plan(
    arch_name: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    opt_overrides: Optional[Dict] = None,
    tuning_overrides: Optional[Dict] = None,
    optimized: bool = False,
    device=None,
) -> CellPlan:
    """The cell's plan.  ``device`` (None = the card, raising without one)
    is where ``abstract_args`` puts its tensors by default."""
    if multi_pod:
        raise ValueError("multi_pod plans need a mesh: the multi-device slice "
                         "(ROADMAP queue 1, item 6)")
    device = resolve_device(device)
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, why = cell_is_supported(cfg, shape)
    if not ok:
        raise ValueError(f"unsupported cell {arch_name} x {shape_name}: {why}")
    tuning = cell_tuning(cfg, shape)
    if optimized:
        tuning = dataclasses.replace(
            tuning, **OPTIMIZED_OVERRIDES.get(arch_name, {}))
        if shape.kind != Kind.TRAIN:
            # serving flavours stream bf16 weights: decode cells are
            # parameter-bandwidth-bound, so this halves their memory term
            tuning = dataclasses.replace(tuning, param_dtype="bfloat16")
    if tuning_overrides:
        tuning = dataclasses.replace(tuning, **tuning_overrides)

    train = shape.kind == Kind.TRAIN
    ctx = ShardCtx(
        attention_impl="torch" if train else tuning.attention_impl,
        ssm_impl="torch" if train else tuning.ssm_impl,
        moe_row_dispatch=tuning.moe_row_dispatch,
        remat_chunk_attn=tuning.remat_chunk_attn,
    )
    schema = build_schema(cfg)
    param_dtype = getattr(torch, tuning.param_dtype)
    compute_dtype = getattr(torch, tuning.compute_dtype)
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len

    def tokens(dev, length):
        return torch.empty((B, length), dtype=torch.int32, device=dev)

    def frames(batch, dev):
        if cfg.enc_len:
            batch["enc_embeds"] = torch.empty((B, cfg.enc_len, cfg.d_model),
                                              dtype=compute_dtype, device=dev)
        return batch

    def plan(step_fn, build_args, model_flops, opt_cfg=None):
        def abstract_args(dev=None):
            return build_args(torch.device(device if dev is None else dev))

        return CellPlan(cfg, shape, tuning, ctx, step_fn, abstract_args, 1,
                        model_flops, opt_cfg, device)

    if train:
        opt_cfg = adamw.OptimizerConfig(state_dtype=tuning.opt_state_dtype,
                                        **(opt_overrides or {}))

        def train_args(dev):
            params = abstract_from_schema(schema, param_dtype, dev)
            batch = frames({"tokens": tokens(dev, S), "labels": tokens(dev, S)}, dev)
            return params, _abstract_opt(params, opt_cfg), batch

        model_flops = 6.0 * n_active * B * S
        if cfg.enc_len:  # add encoder forward+backward
            model_flops += 6.0 * _encoder_params(cfg) * B * cfg.enc_len
        return plan(make_train_step(cfg, opt_cfg, tuning, ctx), train_args,
                    model_flops, opt_cfg)

    if shape.kind == Kind.PREFILL:
        def prefill_args(dev):
            return (abstract_from_schema(schema, param_dtype, dev),
                    frames({"tokens": tokens(dev, S)}, dev))

        model_flops = 2.0 * n_active * B * S
        if cfg.enc_len:
            model_flops += 2.0 * _encoder_params(cfg) * B * cfg.enc_len
        return plan(make_prefill_step(cfg, ctx, tuning=tuning), prefill_args,
                    model_flops)

    # DECODE: serve_step(params, cache, tokens)
    cs = cache_schema(cfg, B, S, enc_len=cfg.enc_len)

    def decode_args(dev):
        return (abstract_from_schema(schema, param_dtype, dev),
                abstract_from_schema(cs, compute_dtype, dev), tokens(dev, 1))

    return plan(make_serve_step(cfg, ctx, tuning=tuning), decode_args,
                2.0 * n_active * B)


def _abstract_opt(params, opt_cfg: adamw.OptimizerConfig) -> adamw.OptState:
    """Empty optimizer state for ``params``, laid out as ``adamw.init``'s."""
    dt = torch.bfloat16 if opt_cfg.state_dtype == "bfloat16" else torch.float32

    def moment(p):
        return torch.empty(p.shape, dtype=dt, device=p.device)

    def error(p):
        return torch.empty(p.shape if opt_cfg.compress_grads else (),
                           dtype=torch.float32, device=p.device)

    step = torch.empty((), dtype=torch.int32, device=leaves(params)[0].device)
    return adamw.OptState(step=step, mu=tree_map(moment, params),
                          nu=tree_map(moment, params),
                          error=tree_map(error, params))


def _encoder_params(cfg: ArchConfig) -> int:
    """Rough encoder-only parameter count for enc-dec model FLOPs."""
    d, H, hd, ff = cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff
    per = d * H * hd * 2 + 2 * d * cfg.n_kv_heads * hd + 2 * d * ff
    return cfg.n_layers * per
