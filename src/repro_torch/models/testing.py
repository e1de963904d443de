"""Reduced same-family configs for CPU smoke tests.

Full configs are only ever exercised via the dry-run (ShapeDtypeStruct, no
allocation); everything numeric runs on these shrunken twins.
"""
from __future__ import annotations

import dataclasses

from .config import ArchConfig, MoEConfig, SSMConfig


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink an architecture, preserving family and structural quirks."""
    kw = dict(
        n_layers=4 if cfg.shared_attn_period == 0 else 5,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab=257,   # deliberately not a multiple of 256 -> exercises padding
        head_dim=16,
    )
    if cfg.moe is not None:
        # capacity_factor 4.0: no capacity drops at smoke-test batch sizes,
        # keeping decode-vs-full-forward consistency exact (drops are
        # batch-shape dependent by design).
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2), n_experts_padded=4,
            capacity_factor=4.0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(
            d_state=8, d_conv=4, expand=2, head_dim=16,
            chunk=8, version=cfg.ssm.version,
        )
    if cfg.shared_attn_period:
        kw["shared_attn_period"] = 2   # 5 layers -> 2 shared applications + 1
    if cfg.enc_len:
        kw["enc_len"] = 16
    return dataclasses.replace(cfg, **kw)
