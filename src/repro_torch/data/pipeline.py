"""Deterministic synthetic token pipeline.

Produces sharded next-token-prediction batches: each host generates only its
own shard (seeded by (step, host_slice)), so the pipeline is
restart-deterministic and elastic — after a re-mesh the shard assignment
function is re-evaluated and the stream continues bit-identically for the
surviving data range.  The "dataset" is a fixed-vocabulary LCG stream with a
learnable structure (token t+1 depends on t), enough for loss-goes-down
validation without external data.

Port of ``repro.data.pipeline``: numpy only, the same
``SeedSequence([seed, step, shard index])`` stream, so every batch equals the
JAX package's bit for bit.  The model step takes its tensors from these
arrays on its own device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    enc_len: int = 0       # enc-dec architectures: frame-embedding length
    d_model: int = 0       # for frontend-stub embeddings


def _sample(rng: np.random.Generator, cfg: DataConfig, n: int) -> np.ndarray:
    """Structured synthetic stream: x_{t+1} = (a * x_t + c + noise) % V."""
    V = cfg.vocab
    a, c = 6364136223846793005 % V or 7, 1442695040888963407 % V or 11
    x = np.empty((n, cfg.seq_len + 1), np.int32)
    x[:, 0] = rng.integers(0, V, size=n)
    noise = (rng.random((n, cfg.seq_len)) < 0.1)
    rand = rng.integers(0, V, size=(n, cfg.seq_len))
    for t in range(cfg.seq_len):
        nxt = (a * x[:, t].astype(np.int64) + c) % V
        x[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt).astype(np.int32)
    return x


def batch_for_step(
    cfg: DataConfig, step: int,
    shard: Tuple[int, int] = (0, 1),
) -> Dict[str, np.ndarray]:
    """Deterministic batch for ``step``; shard=(index, count) selects this
    host's rows.  Reshardable: (0, 1) yields the full global batch."""
    idx, count = shard
    if cfg.global_batch % count:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {count} shards")
    per = cfg.global_batch // count
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, idx])
    )
    x = _sample(rng, cfg, per)
    out = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    if cfg.enc_len:
        out["enc_embeds"] = rng.standard_normal(
            (per, cfg.enc_len, cfg.d_model), dtype=np.float32
        )
    return out


def stream(cfg: DataConfig, start_step: int = 0,
           shard: Tuple[int, int] = (0, 1)) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_for_step(cfg, step, shard)
        step += 1
