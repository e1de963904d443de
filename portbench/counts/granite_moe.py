"""The work of one prefill of the configuration that
``reference/granite_moe.py`` defines, from its widths alone: what the
per-layer metrics divide by."""
from __future__ import annotations

from typing import List, Tuple

from portbench.yardstick.bounds import attention_work


def attention_calls(cfg: dict, S: int) -> List[Tuple]:
    """The attention calls of one prefill of ``S`` tokens, as arguments of
    ``yardstick.bounds.attention_work`` less the element size: one causal
    call per layer."""
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    return [(1, S, S, H, KV, cfg["d_model"] // H, True)] * cfg["n_layers"]


def prefill_flops(cfg: dict, S: int) -> float:
    """Model FLOPs of one prefill of ``S`` tokens: every matrix product of
    the attention block, attention over its causal pairs once, the router,
    each token's ``moe_top_k`` experts (three products each), and the
    vocab head at the last position only (the prefill emits one token).
    Norms, softmaxes, gates and the embedding lookup are left out, as model
    FLOPs leave them out; so are the products a program spends on tokens
    an expert was not chosen for."""
    d, H, KV, ff = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    hd = d // H
    per_layer = 2.0 * S * d * (H + 2 * KV) * hd + 2.0 * S * H * hd * d \
        + attention_work(*attention_calls(cfg, S)[0], 2)[0] \
        + 2.0 * S * d * cfg["moe_n_experts"] + cfg["moe_top_k"] * 3 * 2.0 * S * d * ff
    return cfg["n_layers"] * per_layer + 2.0 * d * cfg["vocab"]
