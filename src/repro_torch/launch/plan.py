"""Cell plans: everything needed to count one (arch x shape x mesh) cell.

The port of ``repro.launch.plan``.  A ``CellPlan`` bundles the step
function and a function that makes its abstract arguments: empty tensors of the
cell's full shapes, made under ``FakeTensorMode`` so that nothing is
allocated.  ``launch.dryrun`` counts the step on them (``launch.cost``),
where the JAX package lowers and compiles it; ``chip_smoke.py`` also runs
a cell's step on real tensors of the same shapes.

Three meshes.  ``multi_pod=None`` (the default) is one card: ``chips`` is
1, no rules and no specs, and the tuning flags that only shape a sharding
(``seq_parallel_attn``, ``seq_parallel_residual``) change nothing.
``multi_pod=False`` is the JAX package's 16x16 ``("data", "model")`` mesh
and ``multi_pod=True`` its 2x16x16 ``("pod", "data", "model")`` mesh
(``build_plan``'s ``multi_pod`` there): ``rules``, the sharded ``ctx``,
``in_specs``/``out_specs`` (spec tuples in the JAX package's layout, a
``PartitionSpec`` as a plain tuple), ``chips`` 256 or 512 and
``compress_grads`` for a multi-pod cell over 5e9 parameters, each as the
JAX package derives them.  A sharded plan's ``abstract_args(mesh=...)``
makes DTensors on that mesh (``launch.mesh.make_production_mesh`` inside
``launch.mesh.fake_world(chips)``) whose local tensors have each rank's
shapes, and its step redistributes its outputs to ``out_specs``, as the
JAX step's ``out_shardings`` do.  Tokens and labels are
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

from torch.distributed.tensor import DTensor

from repro_torch import resolve_device
from repro_torch.configs.registry import get_arch
from repro_torch.launch.mesh import redistribute, spec_to_placements
from repro_torch.models.config import (
    ArchConfig, CellTuning, Kind, SHAPES, ShapeConfig, cell_is_supported,
    cell_tuning,
)
from repro_torch.models.model import cache_schema
from repro_torch.models.ops import ShardCtx
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import (
    ShardingRules, abstract_from_schema, abstract_sharded, default_rules,
    schema_to_pspecs,
)
from repro_torch.optim import adamw
from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.tree import leaves, tree_map

MODEL_AXIS_SIZE = 16
DATA_AXIS_SIZE = 16
PODS = 2

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
    # (device, mesh) -> the step's arguments as empty tensors; call it
    # under FakeTensorMode (a real call allocates the whole cell, or on a
    # mesh each rank's shards).  A sharded plan needs the mesh.
    abstract_args: Callable[..., Tuple]
    chips: int
    model_flops: float
    opt_cfg: Optional[adamw.OptimizerConfig] = None
    device: torch.device = torch.device("cuda")
    rules: Optional[ShardingRules] = None
    multi_pod: Optional[bool] = None      # None: one card
    in_specs: Any = None
    out_specs: Any = None


def _batch_axes(global_batch: int, multi_pod: bool):
    dp = ("pod", "data") if multi_pod else ("data",)
    total = PODS * DATA_AXIS_SIZE if multi_pod else DATA_AXIS_SIZE
    if global_batch % total == 0:
        return dp
    if global_batch % DATA_AXIS_SIZE == 0:
        return ("data",)
    return None  # replicate (e.g. long_500k with B = 1)


def build_plan(
    arch_name: str,
    shape_name: str,
    *,
    multi_pod: Optional[bool] = None,
    opt_overrides: Optional[Dict] = None,
    tuning_overrides: Optional[Dict] = None,
    optimized: bool = False,
    device=None,
) -> CellPlan:
    """The cell's plan on one card (``multi_pod=None``), the 16x16 mesh
    (False) or the 2x16x16 mesh (True).  ``device`` (None = the card,
    raising without one) is where ``abstract_args`` puts its tensors by
    default."""
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
    impls = dict(attention_impl="torch" if train else tuning.attention_impl,
                 ssm_impl="torch" if train else tuning.ssm_impl,
                 moe_row_dispatch=tuning.moe_row_dispatch,
                 remat_chunk_attn=tuning.remat_chunk_attn)
    sharded = multi_pod is not None
    rules = batch_axes = None
    if sharded:
        batch_axes = _batch_axes(shape.global_batch, multi_pod)
        rules = default_rules(
            cfg,
            fsdp_axes=("pod", "data") if multi_pod else ("data",),
            fsdp_total=(PODS if multi_pod else 1) * DATA_AXIS_SIZE,
            model_size=MODEL_AXIS_SIZE,
            batch_axes=batch_axes,
            seq_shard_cache=shape.kind == Kind.DECODE and batch_axes is None,
        )
        ctx = ShardCtx(
            enabled=True, dp=batch_axes, tp="model",
            heads_sharded=rules.rules.get("heads_q") is not None,
            ff_sharded=rules.rules.get("d_ff") is not None,
            seq_parallel_attn=tuning.seq_parallel_attn,
            seq_parallel_residual=tuning.seq_parallel_residual, **impls)
        chips = (PODS if multi_pod else 1) * DATA_AXIS_SIZE * MODEL_AXIS_SIZE
    else:
        ctx = ShardCtx(**impls)
        chips = 1
    schema = build_schema(cfg)
    params_specs = schema_to_pspecs(schema, rules) if sharded else None
    param_dtype = getattr(torch, tuning.param_dtype)
    compute_dtype = getattr(torch, tuning.compute_dtype)
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len

    def empty(shape_, dtype, dev, mesh, spec):
        if mesh is None:
            return torch.empty(shape_, dtype=dtype, device=dev)
        return abstract_sharded(shape_, dtype, dev, mesh, spec)

    def params_of(dev, mesh):
        if mesh is None:
            return abstract_from_schema(schema, param_dtype, dev)
        return _sharded_tree(schema, params_specs, param_dtype, dev, mesh)

    def tokens(dev, mesh, length):
        return empty((B, length), torch.int32, dev, mesh, (batch_axes, None))

    def frames(batch, dev, mesh):
        if cfg.enc_len:
            batch["enc_embeds"] = empty((B, cfg.enc_len, cfg.d_model), compute_dtype,
                                        dev, mesh, (batch_axes, None, None))
        return batch

    def batch_specs(extra):
        specs = {k: (batch_axes, None) for k in extra}
        if cfg.enc_len:
            specs["enc_embeds"] = (batch_axes, None, None)
        return specs

    def plan(step_fn, build_args, model_flops, opt_cfg=None, in_specs=None,
             out_specs=None):
        def abstract_args(dev=None, mesh=None):
            if sharded and mesh is None:
                raise ValueError("a sharded plan's arguments need its mesh "
                                 "(launch.mesh.make_production_mesh)")
            return build_args(torch.device(device if dev is None else dev),
                              mesh if sharded else None)

        if sharded:
            step_fn = _constrained(step_fn, out_specs)
        return CellPlan(cfg, shape, tuning, ctx, step_fn, abstract_args, chips,
                        model_flops, opt_cfg, device, rules, multi_pod,
                        in_specs, out_specs)

    if train:
        opt_cfg = adamw.OptimizerConfig(
            state_dtype=tuning.opt_state_dtype,
            compress_grads=bool(multi_pod and cfg.param_count() > 5e9),
            **(opt_overrides or {}))
        opt_specs = _opt_specs(params_specs, opt_cfg) if sharded else None

        def train_args(dev, mesh):
            params = params_of(dev, mesh)
            batch = frames({"tokens": tokens(dev, mesh, S),
                            "labels": tokens(dev, mesh, S)}, dev, mesh)
            opt = _abstract_opt(params, opt_cfg) if mesh is None else \
                _abstract_opt_sharded(params, opt_specs, opt_cfg, dev, mesh)
            return params, opt, batch

        model_flops = 6.0 * n_active * B * S
        if cfg.enc_len:  # add encoder forward+backward
            model_flops += 6.0 * _encoder_params(cfg) * B * cfg.enc_len
        specs = {}
        if sharded:
            specs = dict(in_specs=(params_specs, opt_specs,
                                   batch_specs(("tokens", "labels"))),
                         out_specs=(params_specs, opt_specs, ()))
        return plan(make_train_step(cfg, opt_cfg, tuning, ctx), train_args,
                    model_flops, opt_cfg, **specs)

    cs = cache_schema(cfg, B, S, enc_len=cfg.enc_len)
    cache_specs = schema_to_pspecs(cs, rules) if sharded else None
    out_specs = ((batch_axes, "model"), cache_specs) if sharded else None

    if shape.kind == Kind.PREFILL:
        def prefill_args(dev, mesh):
            return params_of(dev, mesh), frames({"tokens": tokens(dev, mesh, S)},
                                                dev, mesh)

        model_flops = 2.0 * n_active * B * S
        if cfg.enc_len:
            model_flops += 2.0 * _encoder_params(cfg) * B * cfg.enc_len
        in_specs = (params_specs, batch_specs(("tokens",))) if sharded else None
        return plan(make_prefill_step(cfg, ctx, tuning=tuning), prefill_args,
                    model_flops, in_specs=in_specs, out_specs=out_specs)

    # DECODE: serve_step(params, cache, tokens)
    def decode_args(dev, mesh):
        cache = abstract_from_schema(cs, compute_dtype, dev) if mesh is None \
            else _sharded_tree(cs, cache_specs, compute_dtype, dev, mesh)
        return params_of(dev, mesh), cache, tokens(dev, mesh, 1)

    in_specs = (params_specs, cache_specs, (batch_axes, None)) if sharded else None
    return plan(make_serve_step(cfg, ctx, tuning=tuning), decode_args,
                2.0 * n_active * B, in_specs=in_specs, out_specs=out_specs)


def _sharded_tree(schema, specs, dtype, dev, mesh):
    """The schema's empty DTensors on ``mesh`` (leaf dtype, else ``dtype``)."""
    if isinstance(schema, dict):
        return {k: _sharded_tree(v, specs[k], dtype, dev, mesh)
                for k, v in schema.items()}
    return abstract_sharded(schema.shape, schema.dtype or dtype, dev, mesh, specs)


def _opt_specs(params_specs, opt_cfg: adamw.OptimizerConfig) -> adamw.OptState:
    """The JAX package's ``_abstract_opt`` specs: moments like the
    parameters; the error-feedback residuals too when compressing, else
    replicated scalars."""
    error = params_specs if opt_cfg.compress_grads else \
        _map_specs(lambda _: (), params_specs)
    return adamw.OptState(step=(), mu=params_specs, nu=params_specs, error=error)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def _abstract_opt_sharded(params, opt_specs: adamw.OptState,
                          opt_cfg: adamw.OptimizerConfig, dev, mesh) -> adamw.OptState:
    """``_abstract_opt``'s state as DTensors with ``opt_specs``'s
    placements."""
    dt = torch.bfloat16 if opt_cfg.state_dtype == "bfloat16" else torch.float32

    def walk(p, spec, dtype, scalar=False):
        if isinstance(p, dict):
            return {k: walk(p[k], spec[k], dtype, scalar) for k in p}
        return abstract_sharded(() if scalar else p.shape, dtype, dev, mesh, spec)

    return adamw.OptState(
        step=abstract_sharded((), torch.int32, dev, mesh, ()),
        mu=walk(params, opt_specs.mu, dt), nu=walk(params, opt_specs.nu, dt),
        error=walk(params, opt_specs.error, torch.float32,
                   scalar=not opt_cfg.compress_grads))


def _constrained(step_fn: Callable, out_specs) -> Callable:
    """``step_fn`` whose DTensor outputs are redistributed to ``out_specs``
    (the JAX step's ``out_shardings``)."""
    def step(*args):
        return _place(step_fn(*args), out_specs)

    return step


def _place(tree, specs):
    if isinstance(tree, dict):
        return {k: _place(v, specs if _is_spec(specs) else specs[k])
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [_place(v, specs if _is_spec(specs) else specs[i])
                 for i, v in enumerate(tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    if isinstance(tree, DTensor):
        return redistribute(tree, spec_to_placements(
            specs + (None,) * (tree.ndim - len(specs)), tree.device_mesh))
    return tree


def _is_spec(specs) -> bool:
    """A spec tuple (entries None, axis names or tuples of names), not a
    container of specs."""
    return isinstance(specs, tuple) and not hasattr(specs, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in specs)


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
