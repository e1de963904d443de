"""Parameter schemas per architecture family.

A schema is a nested dict of ParamSchema leaves; shapes, logical sharding
axes, and init style are defined once and consumed by init, dry-run
ShapeDtypeStructs, and pjit in_shardings alike.
"""
from __future__ import annotations

from typing import Dict

from .config import ArchConfig, Family, MLPKind
from .sharding import ParamSchema as PS


def _attn_schema(cfg: ArchConfig, L: int | None, cross: bool = False) -> Dict:
    """Attention block; L=None -> unstacked (shared block)."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def shp(*s):
        return (L, *s) if L is not None else s

    def lg(*a):
        return ("layers", *a) if L is not None else a

    out = {
        "ln": PS(shp(d), lg("d_model"), init="ones"),
        "wq": PS(shp(d, H, hd), lg("d_model", "heads_q", "hd")),
        "wk": PS(shp(d, KV, hd), lg("d_model", "heads_kv", "hd")),
        "wv": PS(shp(d, KV, hd), lg("d_model", "heads_kv", "hd")),
        "wo": PS(shp(H, hd, d), lg("heads_q", "hd", "d_model")),
    }
    if cfg.qkv_bias:
        out["bq"] = PS(shp(H, hd), lg("heads_q", "hd"), init="zeros")
        out["bk"] = PS(shp(KV, hd), lg("heads_kv", "hd"), init="zeros")
        out["bv"] = PS(shp(KV, hd), lg("heads_kv", "hd"), init="zeros")
    return out


def _mlp_schema(cfg: ArchConfig, L: int | None) -> Dict:
    d, ff = cfg.d_model, cfg.d_ff

    def shp(*s):
        return (L, *s) if L is not None else s

    def lg(*a):
        return ("layers", *a) if L is not None else a

    out = {"ln": PS(shp(d), lg("d_model"), init="ones")}
    if cfg.mlp == MLPKind.GATED_SILU:
        out["w_gate"] = PS(shp(d, ff), lg("d_model", "d_ff"))
        out["w_up"] = PS(shp(d, ff), lg("d_model", "d_ff"))
        out["w_down"] = PS(shp(ff, d), lg("d_ff", "d_model"))
    else:
        out["w_up"] = PS(shp(d, ff), lg("d_model", "d_ff"))
        out["w_down"] = PS(shp(ff, d), lg("d_ff", "d_model"))
        if cfg.qkv_bias:  # whisper-style biased MLP
            out["b_up"] = PS(shp(ff), lg("d_ff"), init="zeros")
            out["b_down"] = PS(shp(d), lg("d_model"), init="zeros")
    return out


def _moe_schema(cfg: ArchConfig, L: int) -> Dict:
    d, ff, Ep = cfg.d_model, cfg.d_ff, cfg.moe.n_experts_padded
    out = {
        "ln": PS((L, d), ("layers", "d_model"), init="ones"),
        "router": PS((L, d, Ep), ("layers", "d_model", "experts"),
                     init="small_normal"),
        "w_up": PS((L, Ep, d, ff), ("layers", "experts", "d_model", "d_ff")),
        "w_down": PS((L, Ep, ff, d), ("layers", "experts", "d_ff", "d_model")),
    }
    if cfg.mlp == MLPKind.GATED_SILU:
        out["w_gate"] = PS(
            (L, Ep, d, ff), ("layers", "experts", "d_model", "d_ff")
        )
    sff = cfg.moe.shared_d_ff
    if sff:
        out["shared_gate"] = PS((L, d, sff), ("layers", "d_model", "d_ff"))
        out["shared_up"] = PS((L, d, sff), ("layers", "d_model", "d_ff"))
        out["shared_down"] = PS((L, sff, d), ("layers", "d_ff", "d_model"))
    return out


def _mamba1_schema(cfg: ArchConfig, L: int) -> Dict:
    d, di, n, K = cfg.d_model, cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    r = max(1, d // 16)
    return {
        "ln": PS((L, d), ("layers", "d_model"), init="ones"),
        "w_in": PS((L, d, 2 * di), ("layers", "d_model", "d_inner")),
        "conv_w": PS((L, K, di), ("layers", "conv", "d_inner"),
                     init="small_normal"),
        "conv_b": PS((L, di), ("layers", "d_inner"), init="zeros"),
        "w_xproj": PS((L, di, r + 2 * n), ("layers", "d_inner", "dt")),
        "w_dt": PS((L, r, di), ("layers", "dt", "d_inner")),
        "dt_bias": PS((L, di), ("layers", "d_inner"), init="dt_bias"),
        "A_log": PS((L, di, n), ("layers", "d_inner", "state"), init="a_log"),
        "D": PS((L, di), ("layers", "d_inner"), init="ones"),
        "w_out": PS((L, di, d), ("layers", "d_inner", "d_model")),
    }


def _mamba2_schema(cfg: ArchConfig, L: int) -> Dict:
    d, di, n, K = cfg.d_model, cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    nh = di // cfg.ssm.head_dim
    return {
        "ln": PS((L, d), ("layers", "d_model"), init="ones"),
        "wz": PS((L, d, di), ("layers", "d_model", "d_inner")),
        "wx": PS((L, d, di), ("layers", "d_model", "d_inner")),
        "wB": PS((L, d, n), ("layers", "d_model", "state")),
        "wC": PS((L, d, n), ("layers", "d_model", "state")),
        "wdt": PS((L, d, nh), ("layers", "d_model", "ssm_heads")),
        "conv_x_w": PS((L, K, di), ("layers", "conv", "d_inner"),
                       init="small_normal"),
        "conv_x_b": PS((L, di), ("layers", "d_inner"), init="zeros"),
        "conv_B_w": PS((L, K, n), ("layers", "conv", "state"),
                       init="small_normal"),
        "conv_B_b": PS((L, n), ("layers", "state"), init="zeros"),
        "conv_C_w": PS((L, K, n), ("layers", "conv", "state"),
                       init="small_normal"),
        "conv_C_b": PS((L, n), ("layers", "state"), init="zeros"),
        "A_log": PS((L, nh), ("layers", "ssm_heads"), init="a_log"),
        "D": PS((L, nh), ("layers", "ssm_heads"), init="ones"),
        "dt_bias": PS((L, nh), ("layers", "ssm_heads"), init="dt_bias"),
        "out_norm": PS((L, di), ("layers", "d_inner"), init="ones"),
        "w_out": PS((L, di, d), ("layers", "d_inner", "d_model")),
    }


def build_schema(cfg: ArchConfig) -> Dict:
    """Full parameter schema for an architecture."""
    d, Vp, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    schema: Dict = {
        "embed": PS((Vp, d), ("embed_vocab", "d_model"), init="small_normal"),
        "final_norm": PS((d,), ("d_model",), init="ones"),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = PS((d, Vp), ("d_model", "embed_vocab"))

    if cfg.family in (Family.DENSE, Family.VLM):
        schema["layers"] = {
            "attn": _attn_schema(cfg, L),
            "mlp": _mlp_schema(cfg, L),
        }
    elif cfg.family == Family.MOE:
        schema["layers"] = {
            "attn": _attn_schema(cfg, L),
            "moe": _moe_schema(cfg, L),
        }
    elif cfg.family == Family.SSM:
        schema["layers"] = _mamba1_schema(cfg, L)
    elif cfg.family == Family.HYBRID_MOE:
        # per-kind stacks: the mamba2 mixers, the attention mixers (each in
        # ``layer_pattern`` order) and every layer's MoE
        schema["mamba"] = _mamba2_schema(cfg, len(cfg.mamba_layers))
        schema["attn"] = _attn_schema(cfg, len(cfg.attn_layers))
        schema["moe"] = _moe_schema(cfg, L)
    elif cfg.family == Family.HYBRID:
        schema["layers"] = _mamba2_schema(cfg, L)
        schema["shared"] = {
            "attn": _attn_schema(cfg, None),
            "mlp": _mlp_schema(cfg, None),
        }
    elif cfg.family in (Family.ENC_DEC, Family.AUDIO):
        schema["enc_layers"] = {
            "attn": _attn_schema(cfg, L),
            "mlp": _mlp_schema(cfg, L),
        }
        schema["enc_final_norm"] = PS((d,), ("d_model",), init="ones")
        schema["layers"] = {
            "attn": _attn_schema(cfg, L),
            "cross": _attn_schema(cfg, L),
            "mlp": _mlp_schema(cfg, L),
        }
    else:
        raise ValueError(cfg.family)
    return schema
