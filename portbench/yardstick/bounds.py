"""Least device time of a kernel's work, from shapes alone.

Frozen from ``chip_smoke.py::attention_bound_ms``: each input byte read
once and each output byte written once; causal (query, key) pairs counted
once.  Times are in seconds here."""
from __future__ import annotations

from typing import Tuple

from .peaks import Peaks


def attention_work(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
                   causal: bool, elem_bytes: int, q_offset: int = 0
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call: QK^T and PV over the live
    (query, key) pairs (causal: query row i, at position q_offset + i,
    sees q_offset + i + 1 keys); q, k, v read once, the output written
    once."""
    pairs = Sq * q_offset + Sq * (Sq + 1) // 2 if causal else Sq * Sk
    flops = 4.0 * B * H * hd * pairs
    nbytes = elem_bytes * B * hd * (2 * Sq * H + 2 * Sk * KV)
    return flops, float(nbytes)


def attention_bound_s(B, Sq, Sk, H, KV, hd, causal, elem_bytes, peaks: Peaks,
                      q_offset: int = 0) -> float:
    """Least seconds of one attention call: the larger of its operations
    over the rate of its input type (bf16 tensor cores, else float32) and
    its bytes over the memory rate."""
    flops, nbytes = attention_work(B, Sq, Sk, H, KV, hd, causal, elem_bytes, q_offset)
    rate = peaks.bf16_flops if elem_bytes == 2 else peaks.f32_flops
    return max(flops / rate, nbytes / peaks.mem_bytes)
