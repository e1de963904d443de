"""The device trace of a slice of a run, and its reduction.

``DeviceTrace`` traces the device only (``torch.profiler`` with the CUDA
activity alone, as ``repro_torch.obs.profile.profile_window`` does, frozen
here): the profiler adds no per-operator host work.  The host's own
activity comes from spans the driver records on the host clock; one
marker kernel, launched on an idle device when the trace starts, ties the
trace's clock to the host's.  ``reduce`` turns the device operations and
the host spans into the numbers the per-layer metrics read: busy seconds
(the union of the operations' intervals), launches, time by operation
name, and idle time by what the host was doing.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[str, float, float]       # (name, start s, end s), host clock


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self._t_mark = 0.0
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t_mark = time.perf_counter()
        torch.cuda._sleep(1000)                   # the marker: first on the device
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self) -> List[Interval]:
        """Ends the trace; returns the device operations on the host clock."""
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        ops = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in self._prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        self._prof = None
        if not ops:
            return []
        base = ops[0][0]                          # the marker's start
        return [(name, self._t_mark + (s - base) / 1e6, self._t_mark + (e - base) / 1e6)
                for s, e, name in ops[1:]]


def _union_seconds(ivals: Sequence[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(ivals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def reduce(ops: Sequence[Interval], t0: float, t1: float,
           host: Sequence[Interval], top: int = 10) -> Dict:
    """The slice [t0, t1]'s device numbers.

    ``ops``: device operations (kernels, copies, fills), ``host``: the
    host's spans; both on the host clock, clipped to the slice.  An idle
    gap is charged to the host span that covers most of it, or to
    ``"harness"`` where none does."""
    clipped = [(n, max(s, t0), min(e, t1)) for n, s, e in ops if e > t0 and s < t1]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for n, s, e in clipped:
        by_name[n][0] += 1
        by_name[n][1] += e - s
    busy = _union_seconds([(s, e) for _, s, e in clipped])
    idle: Dict[str, float] = defaultdict(float)
    cursor = t0
    spans = sorted((s, e, n) for n, s, e in host)
    starts = [s for s, _, _ in spans]
    for _, s, e in sorted(clipped, key=lambda x: x[1]) + [("", t1, t1)]:
        if s > cursor:
            idle[_covering(spans, starts, cursor, s)] += s - cursor
        cursor = max(cursor, e)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "window_s": t1 - t0,
        "busy_s": busy,
        "launches": len(clipped),
        "by_name": {n: {"count": c, "seconds": sec} for n, (c, sec) in by_name.items()},
        "device_ops": [[short_name(n), sec] for n, (_, sec) in ranked[:top]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top],
    }


_NOISE = ("void ", "at::native::", "(anonymous namespace)::", "std::enable_if<!(false), void>::type ",
          "c10::", "at::", "(at::TensorIteratorBase&)::")


def short_name(name: str, width: int = 120) -> str:
    """A device operation's name without the namespaces and qualifiers that
    every PyTorch kernel shares, cut to ``width``."""
    for noise in _NOISE:
        name = name.replace(noise, "")
    return name[:width]


def _covering(spans, starts, g0: float, g1: float) -> str:
    """The span (host spans do not nest) that covers most of [g0, g1]."""
    best, name = 0.0, "harness"
    for j in range(max(bisect.bisect_right(starts, g0) - 1, 0), len(spans)):
        s, e, n = spans[j]
        if s >= g1:
            break
        over = min(e, g1) - max(s, g0)
        if over > best:
            best, name = over, n
    return name


def kernel_seconds(by_name: Dict[str, Dict], patterns: Sequence[str]) -> Tuple[int, float]:
    """(launches, seconds) of the operations whose name holds any of
    ``patterns``."""
    hits = [v for n, v in by_name.items() if any(p in n for p in patterns)]
    return sum(v["count"] for v in hits), sum(v["seconds"] for v in hits)
