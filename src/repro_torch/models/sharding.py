"""Logical-axis sharding: one schema drives parameter shapes, their seeded
initialisation, the abstract parameters of a dry run and their sharding
specs, so init, optimizer state and placements never drift apart.

A schema is a nested dict of ``ParamSchema`` leaves.  Mesh axes:
``("data", "model")`` single-pod, ``("pod", "data", "model")`` multi-pod.
Logical parameter axes map to mesh axes by rules derived per architecture
(divisibility permitting), as in ``repro.models.sharding``.  A spec is a
tuple with one entry per tensor dim (None, an axis name or a tuple of
names), the JAX package's ``PartitionSpec`` as a plain tuple;
``distribute_params`` turns a parameter dict into DTensors with those
placements (``launch.mesh.spec_to_placements``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.launch.mesh import local_shape_and_offset, spec_to_placements

from .config import ArchConfig

MeshAxes = Union[str, Tuple[str, ...], None]


@dataclass(frozen=True)
class ParamSchema:
    """One parameter: shape + logical axis names + init style."""

    shape: Tuple[int, ...]
    logical: Tuple[str, ...]
    init: str = "normal"        # normal | zeros | ones | small_normal | a_log | dt_bias
    dtype: Any = None           # a torch dtype; defaults to the model param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical axes {self.logical}")


@dataclass
class ShardingRules:
    """Map from logical axis name to mesh axes (or None = replicate)."""

    rules: Dict[str, MeshAxes]

    def spec_for(self, logical: Sequence[str]) -> Tuple[MeshAxes, ...]:
        return tuple(self.rules.get(name) for name in logical)


def default_rules(
    cfg: ArchConfig,
    *,
    model_axis: str = "model",
    fsdp_axes: MeshAxes = "data",
    model_size: int = 16,
    fsdp_total: int = 16,
    batch_axes: MeshAxes = ("data",),
    seq_shard_cache: bool = False,
) -> ShardingRules:
    """Derive TP/FSDP rules for an architecture, respecting divisibility
    (``repro.models.sharding.default_rules``, rule for rule).

    * ``heads_q`` shards over the model axis when n_heads divides;
    * ``d_ff``/``d_inner``/``experts`` shard over the model axis;
    * ``d_model`` is the FSDP (ZeRO-3) axis (spanning pod x data when
      multi-pod);
    * vocab is padded to 256 so ``embed_vocab`` always shards;
    * decode caches: ``hd_cache`` shards head_dim over the model axis and
      optionally ``seq`` over data (B=1 long-context cells).
    """
    def fits(n: int, size: int) -> bool:
        return n % size == 0

    rules: Dict[str, MeshAxes] = {
        "layers": None,
        "groups": None,
        "scan": None,
        "d_model": fsdp_axes if fits(cfg.d_model, fsdp_total) else None,
        "embed_vocab": model_axis if fits(cfg.vocab_padded, model_size) else None,
        "heads_q": model_axis if fits(cfg.n_heads, model_size) else None,
        "heads_kv": model_axis if fits(cfg.n_kv_heads, model_size) else None,
        "hd": None,
        # Decode caches carry both a heads_kv and an hd_cache axis; a mesh
        # axis may appear once per spec, so hd_cache only shards when the
        # kv-head axis cannot (GQA with few kv heads).
        "hd_cache": model_axis
        if fits(cfg.hd, model_size) and not fits(cfg.n_kv_heads, model_size)
        else None,
        "d_ff": model_axis if cfg.d_ff and fits(cfg.d_ff, model_size) else None,
        "conv": None,
        "state": None,
        "dt": None,
        "scalar": None,
        "batch": batch_axes,
        "seq": "data" if seq_shard_cache else None,
    }
    if cfg.moe is not None:
        rules["experts"] = (
            model_axis if fits(cfg.moe.n_experts_padded, model_size) else None
        )
        # When experts shard over model, per-expert d_ff stays unsharded.
        if rules["experts"] is not None:
            rules["d_ff"] = None
    if cfg.ssm is not None:
        di = cfg.d_inner
        rules["d_inner"] = model_axis if fits(di, model_size) else None
        nh = di // cfg.ssm.head_dim
        rules["ssm_heads"] = model_axis if fits(nh, model_size) else None
    return ShardingRules(rules)


def schema_to_pspecs(schema, rules: ShardingRules):
    """Map a schema dict to spec tuples, leaf for leaf."""
    return map_schema(lambda ps: rules.spec_for(ps.logical), schema)


def distribute_params(params, specs, mesh):
    """Each tensor of ``params`` as a DTensor on ``mesh`` with the
    placements of its spec (the same dict layout).  A tensor is split from
    the full value every rank holds (``distribute_tensor``); under
    ``FakeTensorMode`` nothing is allocated."""
    if isinstance(params, dict):
        return {k: distribute_params(v, specs[k], mesh) for k, v in params.items()}
    return distribute_tensor(params, mesh, spec_to_placements(specs, mesh))


def abstract_sharded(shape, dtype: torch.dtype, device, mesh, spec):
    """An empty DTensor of global ``shape`` on ``mesh`` with the placements
    of ``spec``, whose local tensor has this rank's shape: under
    ``FakeTensorMode`` nothing is allocated, on real devices only the
    shard.  The counterpart of a ``ShapeDtypeStruct`` with a sharding."""
    placements = spec_to_placements(tuple(spec) + (None,) * (len(shape) - len(spec)),
                                    mesh)
    local, _ = local_shape_and_offset(shape, mesh, placements)
    t = torch.empty(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, n = [], 1
    for size in reversed(tuple(shape)):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def map_schema(fn, schema):
    """Apply ``fn`` to every ParamSchema leaf, keeping the dict structure."""
    if isinstance(schema, ParamSchema):
        return fn(schema)
    return {k: map_schema(fn, v) for k, v in schema.items()}


def _leaf_init(ps: ParamSchema, dt: torch.dtype, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dt, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dt, device=device)
    if ps.init == "a_log":
        # mamba1: A = 1..n per channel; mamba2: A ~ U[1, 16] per head.
        n = ps.shape[-1]
        if len(ps.shape) >= 2 and n > 1:
            a = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                       device=device)).expand(ps.shape)
        else:
            u = torch.rand(ps.shape, generator=gen, device=device)
            a = torch.log(1.0 + 15.0 * u)
        return a.to(dt).contiguous()
    if ps.init == "dt_bias":
        # softplus(dt_bias) ~ U[1e-3, 1e-1] (mamba init)
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = lo + (hi - lo) * torch.rand(ps.shape, generator=gen, device=device)
        dt_ = torch.exp(u)
        return (dt_ + torch.log(-torch.expm1(-dt_))).to(dt)
    fan_in = ps.shape[-2] if len(ps.shape) >= 2 else ps.shape[-1]
    scale = 0.02 if ps.init == "small_normal" else 1.0 / math.sqrt(fan_in)
    w = torch.randn(ps.shape, generator=gen, device=device, dtype=torch.float32)
    return (w * scale).to(dt)


def init_from_schema(seed: int, schema, dtype: torch.dtype,
                     device) -> Dict:
    """Numerically initialise a parameter dict from its schema.

    Draws come from one ``torch.Generator`` on ``device`` seeded with
    ``seed``, leaf by leaf in sorted key order (the order jax flattens a
    dict in).  The values differ from the JAX package's for the same seed;
    tests carry JAX weights across with ``models.convert.params_from_numpy``.
    """
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def walk(node):
        if isinstance(node, ParamSchema):
            return _leaf_init(node, node.dtype or dtype, gen, device)
        return {k: walk(node[k]) for k in sorted(node)}

    return walk(schema)


def abstract_from_schema(schema, dtype: torch.dtype, device) -> Dict:
    """Empty tensors of the schema's shapes and dtypes on ``device``: the
    counterpart of ``repro.models.sharding.abstract_from_schema``'s
    ShapeDtypeStructs.  Call it under ``FakeTensorMode``, where it
    allocates nothing; it draws no random numbers."""
    device = torch.device(device)
    return map_schema(
        lambda ps: torch.empty(ps.shape, dtype=ps.dtype or dtype, device=device),
        schema)
