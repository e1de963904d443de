"""Parameter schema, seeded initialisation on one device, and the abstract
parameters of a dry run.

A schema is a nested dict of ``ParamSchema`` leaves; it drives parameter
shapes and init style.  The mesh rules of ``repro.models.sharding`` wait
for the multi-device slice of the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch


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
