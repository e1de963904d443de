"""The program's own spans of the traced slice.

``repro_torch.obs.trace.TRACER`` records while a ``torch.profiler`` trace
is active in the process, so the device trace of ``drivers/serve.py``
turns it on for the slice, and for nothing else of the run.  Its spans are on the host clock
the device trace is mapped to.  A program without ``TRACER`` reads as
nothing: every helper returns None, and the metric is left out of the
line.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def recorded() -> Optional[List]:
    """Every span the program recorded, or None where it has no tracer or
    recorded none."""
    try:
        from repro_torch.obs.trace import TRACER
    except ImportError:
        return None
    return list(TRACER.spans) or None


def named(name: str) -> List:
    return [s for s in recorded() or () if s.name == name]


def mean_ms(name: str) -> Optional[float]:
    """Mean milliseconds of the spans named ``name``."""
    got = named(name)
    if not got:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in got) / len(got)


def share_pct(parent: str, prefix: str) -> Optional[float]:
    """Of the time in spans named ``parent``, the share inside their
    descendants whose name starts with ``prefix`` (outermost ones only), in
    percent."""
    spans = recorded()
    if not spans:
        return None
    by_id: Dict[int, object] = {s.span_id: s for s in spans}
    total = sum(s.t1 - s.t0 for s in spans if s.name == parent)
    if total <= 0:
        return None
    inside = 0.0
    for s in spans:
        if not s.name.startswith(prefix):
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != parent and not p.name.startswith(prefix):
            p = by_id.get(p.parent)
        if p is not None and p.name == parent:
            inside += s.t1 - s.t0
    return 100.0 * inside / total
