"""The general request generator: a cell's ``traffic`` parameters in, the
requests of one run out.

Parameters (``portbench/workloads/<cell>.json``, key ``traffic``):

    loop            "open" (arrivals on a schedule) or "closed" (clients
                    that each send their next request when the last ends)
    rate_per_s      open: mean arrival rate; the run's window of T seconds
                    holds round(rate * T) arrivals
    clients, pool   closed: the number of clients, and of requests drawn
    prompt, output  token counts: {"dist": "lognormal", "median", "sigma",
                    "min", "max"} or {"dist": "uniform", "min", "max"}
                    (inclusive), clipped to [min, max]
    in_flight       closed, optional: true starts every client mid-request,
                    as in a loop that has run for a while: the first
                    ``clients`` requests keep a uniform share, 1 to all,
                    of their output (drawn from ``shape_seed``)
    shape_seed      the seed of the SET of sizes and of gaps between arrivals

Every run of a cell draws the same multiset of prompt lengths, output
lengths and inter-arrival gaps (from ``shape_seed``), so every seed asks
for the same work at the same mean load; the run's ``--seed`` deals them
out in its own order (which prompt comes when, and after which gap) and
draws the token ids (and the driver the weights).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Req:
    index: int
    prompt: np.ndarray          # (S,) int64 token ids
    max_new_tokens: int
    arrival_s: Optional[float]  # open loop: due time from the window's start


def _lengths(spec: dict, count: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        vals = rng.integers(lo, hi + 1, size=count)
    elif spec["dist"] == "lognormal":
        vals = np.rint(spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(count)))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(vals, lo, hi).astype(np.int64)


def count(traffic: dict, seconds: float) -> int:
    """Requests one run draws."""
    if traffic["loop"] == "open":
        return max(1, int(round(traffic["rate_per_s"] * seconds)))
    return int(traffic["pool"])


def requests(traffic: dict, seconds: float, seed: int, vocab: int) -> List[Req]:
    """The run's requests in the order they are sent."""
    n = count(traffic, seconds)
    shapes = np.random.default_rng(int(traffic["shape_seed"]))
    prompt_lens = _lengths(traffic["prompt"], n, shapes)
    output_lens = _lengths(traffic["output"], n, shapes)
    gaps = None
    if traffic["loop"] == "open":
        gaps = shapes.exponential(1.0, size=n)
        gaps *= (n / traffic["rate_per_s"]) / gaps.sum()   # the window's n arrivals
    elif traffic["loop"] != "closed":
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    order = np.random.default_rng([int(seed) % (2 ** 64), 4])
    pick = order.permutation(n)
    prompt_lens, output_lens = prompt_lens[pick], output_lens[pick]
    if gaps is not None:
        gaps = gaps[order.permutation(n)]
    elif traffic.get("in_flight"):
        first = min(int(traffic["clients"]), n)
        share = shapes.random(first)
        output_lens[:first] = np.maximum(1, np.ceil(share * output_lens[:first])).astype(np.int64)
    rng = np.random.default_rng([int(seed) % (2 ** 64), 1])
    arrivals = np.cumsum(gaps) if gaps is not None else [None] * n
    return [Req(i, rng.integers(0, vocab, size=int(s), dtype=np.int64), int(m),
                None if a is None else float(a))
            for i, (s, m, a) in enumerate(zip(prompt_lens, output_lens, arrivals))]
