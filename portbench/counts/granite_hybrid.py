"""The work of one prefill of the configuration that
``reference/granite_hybrid.py`` defines, from its widths alone: what the
per-layer metrics divide by."""
from __future__ import annotations

from typing import List, Tuple

from portbench.yardstick.bounds import attention_work


def _pattern(cfg: dict) -> str:
    return cfg["layer_pattern"][:cfg["n_layers"]]


def attention_calls(cfg: dict, S: int) -> List[Tuple]:
    """The attention calls of one prefill of ``S`` tokens, as arguments of
    ``yardstick.bounds.attention_work`` less the element size: one causal
    call per attention (A) layer."""
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    return [(1, S, S, H, KV, hd, True)] * _pattern(cfg).count("A")


def ssd_calls(cfg: dict, S: int) -> List[Tuple]:
    """The SSD scans of one prefill of ``S`` tokens, (B, S, nh, hp, n) each:
    one per mamba2 (M) layer."""
    hp, n = cfg["ssm_head_dim"], cfg["ssm_d_state"]
    nh = cfg["ssm_expand"] * cfg["d_model"] // hp
    return [(1, S, nh, hp, n)] * _pattern(cfg).count("M")


def prefill_flops(cfg: dict, S: int) -> float:
    """Model FLOPs of one prefill of ``S`` tokens: every weight product of
    the mixers (the mamba2 block's z, x, B, C, dt and output projections;
    the attention block's q, k, v and output projections), the SSD
    recurrence (two multiply-adds a step, head, channel and state element:
    4 S nh hp n), attention over its causal pairs once, the router, each
    token's ``moe_top_k`` experts and the shared expert (three products
    each), and the vocab head at the last position only (the prefill emits
    one token).  Norms, convolutions, softmaxes, gates and the embedding
    lookup are left out, as model FLOPs leave them out; so are the products
    a program spends on tokens an expert was not chosen for."""
    d, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    ff, sff, E = cfg["d_ff"], cfg["moe_shared_d_ff"], cfg["moe_n_experts"]
    n, hp = cfg["ssm_d_state"], cfg["ssm_head_dim"]
    di = cfg["ssm_expand"] * d
    nh = di // hp
    mamba = 2.0 * S * d * (2 * di + 2 * n + nh) + 2.0 * S * di * d + 4.0 * S * nh * hp * n
    attn = 2.0 * S * d * (H + 2 * KV) * hd + 2.0 * S * H * hd * d \
        + attention_work(1, S, S, H, KV, hd, True, 2)[0]
    moe = 2.0 * S * d * E + (cfg["moe_top_k"] * ff + sff) * 3 * 2.0 * S * d
    pattern = _pattern(cfg)
    return pattern.count("M") * mamba + pattern.count("A") * attn \
        + len(pattern) * moe + 2.0 * d * cfg["vocab"]
