"""Unified observability layer: metrics registry, span tracing, and the
per-service emissions ledger.

Three tiers:

* the process-global :data:`REGISTRY` collects cheap wiring counters
  (planner compile cache, lowering tiers, constraint-engine dirty
  accounting) unconditionally — read it with :func:`metrics_scope` to
  get bleed-free deltas;
* the process-global :data:`TRACER` holds the serving engine's and the
  model's spans, off by default: it records while enabled, or while a
  ``torch.profiler`` trace is active (``obs/trace.py``);
* an :class:`Observability` bundle, explicitly attached to a
  ``ContinuumRuntime`` (``obs=Observability()``), turns on per-run
  spans, per-tick metrics, and the emissions ledger.  Detached (the
  default), the runtime pays nothing beyond a few ``perf_counter``
  reads per tick.

``profile.profile_window`` traces one window of work on the device
(``chip_smoke.py`` uses it).

Quickstart::

    from repro_torch.obs import Observability
    obs = Observability()
    runtime = ContinuumRuntime(..., obs=obs)
    result = runtime.run(start, ticks)
    print(obs.report(result))                  # green audit
    print(prometheus_text(obs.registry))       # scrape exposition
    open("spans.jsonl", "w").write(obs.tracer.to_jsonl())
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .export import (
    MetricsServer,
    billing_report,
    events_from_jsonl,
    events_jsonl,
    prometheus_text,
    render_billing,
    render_report,
    serve_metrics,
)
from .ledger import EmissionsLedger, LedgerEntry
from .registry import (
    DEFAULT_BUCKETS,
    HistogramData,
    MetricsRegistry,
    MetricsScope,
    REGISTRY,
    metrics_scope,
)
from .slo import SLO, AlertEvent, SLOEngine
from .trace import TRACER, Span, Tracer
from .tsdb import SeriesRing, TimeSeriesStore
from .watch import DetectorState, WatchConfig, Watchtower

__all__ = [
    "AlertEvent",
    "DEFAULT_BUCKETS",
    "DetectorState",
    "EmissionsLedger",
    "HistogramData",
    "LedgerEntry",
    "MetricsRegistry",
    "MetricsScope",
    "MetricsServer",
    "Observability",
    "REGISTRY",
    "SLO",
    "SLOEngine",
    "SeriesRing",
    "Span",
    "TRACER",
    "TimeSeriesStore",
    "Tracer",
    "WatchConfig",
    "Watchtower",
    "billing_report",
    "events_from_jsonl",
    "events_jsonl",
    "metrics_scope",
    "prometheus_text",
    "render_billing",
    "render_report",
    "serve_metrics",
]


@dataclass
class Observability:
    """Per-run observability bundle: registry + tracer + ledger behind
    one ``enabled`` switch."""

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    tracer: Tracer = field(default_factory=Tracer)
    ledger: EmissionsLedger = field(default_factory=EmissionsLedger)
    enabled: bool = True

    def report(self, result) -> str:
        """Green-audit report for a ``ContinuumResult`` produced under
        this bundle."""
        return render_report(result, ledger=self.ledger,
                             registry=self.registry, tracer=self.tracer)

    def prometheus(self) -> str:
        return prometheus_text(self.registry)
