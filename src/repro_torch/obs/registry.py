"""Metrics registry: counters, gauges, histograms with label sets.

The repo grew its telemetry ad hoc — a process-global planner compile
cache (`compile_cache_stats`), per-pipeline ``lowering_stats`` /
``constraint_stats`` dicts, timing fields bolted onto ``TickRecord``.
This module is the one place they re-home onto: named metrics with
optional label sets, cheap enough to update unconditionally on hot
paths (one dict add per event), exportable (Prometheus text, JSONL)
and scopeable.

Metric kinds:

* **counter** — monotonically increasing float (``inc``);
* **gauge**   — last-write-wins float (``gauge``);
* **histogram** — aggregate-only distribution (count/sum/min/max +
  fixed cumulative buckets, Prometheus-style): observing never stores
  raw samples, so a million-tick run costs the same memory as one tick.

``metrics_scope()`` fixes the classic bleed problem of process-global
counters (benchmark section A's compiles leaking into section B's
gate): it snapshots the counter state on entry and serves *deltas*,
without resetting anything — two scopes can overlap and neither
perturbs the other or the globals.

Registry *events* are timestamped point records (name + attributes) —
the structured home for things like scanned-loop fallbacks that used to
be a last-one-wins string attribute.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "DEFAULT_BUCKETS",
    "HistogramData",
    "MetricsRegistry",
    "REGISTRY",
    "metrics_scope",
]

# Generic log-spaced boundaries that cover both sub-millisecond stage
# latencies (seconds) and per-tick emissions (grams) without per-metric
# tuning; override per histogram via ``describe(buckets=...)``.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
    1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
)


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class HistogramData:
    """Aggregate-only histogram: count, sum, min, max + cumulative-at-
    export bucket counts over fixed boundaries."""

    __slots__ = ("count", "sum", "min", "max", "boundaries", "buckets")

    def __init__(self, boundaries: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.boundaries = tuple(boundaries)
        # one slot per boundary + the +Inf overflow slot
        self.buckets = [0] * (len(self.boundaries) + 1)

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self.buckets[bisect.bisect_left(self.boundaries, v)] += 1

    def cumulative(self) -> List[Tuple[str, int]]:
        """``(le, count)`` rows with Prometheus cumulative semantics."""
        out, running = [], 0
        for b, c in zip(self.boundaries, self.buckets):
            running += c
            out.append((repr(b), running))
        out.append(("+Inf", self.count))
        return out


class MetricsRegistry:
    """Counters / gauges / histograms / events behind one ``enabled``
    switch.  All writes are no-ops when disabled — the switch is the
    only per-call cost observability adds to a cold path."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._counters: Dict[Tuple[str, Tuple], float] = {}
        self._gauges: Dict[Tuple[str, Tuple], float] = {}
        self._hists: Dict[Tuple[str, Tuple], HistogramData] = {}
        self._meta: Dict[str, Dict[str, object]] = {}
        self._events: List[Dict[str, object]] = []

    # -- metadata -----------------------------------------------------------

    def describe(self, name: str, kind: str, help: str = "",
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        """Optional metric metadata (export help text, histogram
        boundaries).  Metrics self-register on first write otherwise."""
        meta = self._meta.setdefault(name, {})
        meta["kind"] = kind
        if help:
            meta["help"] = help
        if buckets is not None:
            meta["buckets"] = tuple(buckets)

    def _kind(self, name: str, default: str) -> str:
        return str(self._meta.setdefault(name, {}).setdefault(
            "kind", default))

    # -- writes -------------------------------------------------------------

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        if not self.enabled:
            return
        self._kind(name, "counter")
        key = (name, _label_key(labels))
        self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
        if not self.enabled:
            return
        self._kind(name, "gauge")
        self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        if not self.enabled:
            return
        self._kind(name, "histogram")
        key = (name, _label_key(labels))
        hist = self._hists.get(key)
        if hist is None:
            boundaries = self._meta.get(name, {}).get(
                "buckets", DEFAULT_BUCKETS)
            hist = self._hists[key] = HistogramData(boundaries)
        hist.observe(value)

    def observe_many(self, name: str, values: Iterable[float],
                     labels: Optional[Dict[str, str]] = None) -> None:
        for v in values:
            self.observe(name, v, labels=labels)

    def event(self, name: str, **attrs) -> None:
        """Timestamped point event (structured log record)."""
        if not self.enabled:
            return
        self._events.append(
            {"name": name, "ts": time.time(), **attrs})

    # -- reads --------------------------------------------------------------

    def value(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> float:
        """Current counter or gauge value (0.0 when never written)."""
        key = (name, _label_key(labels))
        if key in self._counters:
            return self._counters[key]
        return self._gauges.get(key, 0.0)

    def histogram(self, name: str,
                  labels: Optional[Dict[str, str]] = None
                  ) -> Optional[HistogramData]:
        return self._hists.get((name, _label_key(labels)))

    @property
    def events(self) -> List[Dict[str, object]]:
        return self._events

    def counters(self) -> Dict[Tuple[str, Tuple], float]:
        return dict(self._counters)

    def gauges(self) -> Dict[Tuple[str, Tuple], float]:
        return dict(self._gauges)

    def histograms(self) -> Dict[Tuple[str, Tuple], HistogramData]:
        return dict(self._hists)

    def meta(self, name: str) -> Dict[str, object]:
        return dict(self._meta.get(name, {}))

    # -- lifecycle ----------------------------------------------------------

    def reset(self) -> None:
        """Drop every metric, event, and registered kind."""
        self._counters.clear()
        self._gauges.clear()
        self._hists.clear()
        self._events.clear()
        self._meta.clear()


class MetricsScope:
    """Delta view of a registry's counters since scope entry.

    Reads are live while the scope is open and frozen at the exit
    snapshot afterwards, so a gate can be asserted after the ``with``
    block without racing later activity.
    """

    def __init__(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self._entry = registry.counters()
        self._exit: Optional[Dict[Tuple[str, Tuple], float]] = None

    def _now(self) -> Dict[Tuple[str, Tuple], float]:
        return self._exit if self._exit is not None \
            else self.registry.counters()

    def delta(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> float:
        key = (name, _label_key(labels))
        return self._now().get(key, 0.0) - self._entry.get(key, 0.0)

    def deltas(self) -> Dict[Tuple[str, Tuple], float]:
        """Every counter that moved inside the scope."""
        now = self._now()
        out = {}
        for key, v in now.items():
            d = v - self._entry.get(key, 0.0)
            if d != 0.0:
                out[key] = d
        return out

    def _close(self) -> None:
        self._exit = self.registry.counters()


# The process-global registry.  Hot-path producers (planner compile
# cache, lowering tiers, constraint engine) write here unconditionally —
# a counter bump is one dict add — while per-run observability (spans,
# ledger, per-tick metrics) rides on an explicitly attached
# ``Observability`` and its own registry.
REGISTRY = MetricsRegistry(enabled=True)


@contextmanager
def metrics_scope(registry: Optional[MetricsRegistry] = None):
    """Scoped *delta* reads over (by default) the global registry —
    the fix for process-global counters bleeding across benchmark
    sections and test runs.  Nothing is reset: overlapping scopes and
    concurrent readers all see consistent numbers.

    The planner compile cache mirrors every call onto the global
    registry (``planner.compile.{calls,hits,misses,time_s}``), so a
    warm-shape gate reads as::

        from repro_torch.core.scheduler import GreenScheduler

        sched = GreenScheduler()
        sched.plan(problem)              # first call of the signature
        with metrics_scope() as scope:
            sched.plan(problem)          # same shape -> a hit
        assert scope.delta("planner.compile.misses") == 0
        assert scope.delta("planner.compile.calls") == 1
    """
    scope = MetricsScope(registry if registry is not None else REGISTRY)
    try:
        yield scope
    finally:
        scope._close()
