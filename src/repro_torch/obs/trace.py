"""Span tracer for the per-tick pipeline.

Spans are half-open ``[t0, t1)`` wall-clock intervals with an optional
parent, forming one tree per tick:

    tick
    ├── telemetry.ingest
    ├── constraints
    ├── lower.rebuild
    ├── plan.evaluate        (only on replanned ticks)
    │   └── (whatif plan/price timings live in the registry)
    ├── switch
    └── account

Three ways to record:

* ``with tracer.span("name", **attrs):`` — nested host-side spans for
  the eager path; parents are tracked on a stack.
* ``tracer.add(name, t0, t1, parent=..., **attrs)`` — low-level entry
  for code that already captured ``time.perf_counter()`` timestamps and
  must not restructure its control flow (the eager tick body), or that
  reconstructs timing post-hoc (the fused scan commits whole-trace
  spans after the fused program returns — there are deliberately no
  per-tick host spans inside the fused program).
* ``if tracer.on: tracer.open(name)`` ... ``if tracer.on: tracer.close()``
  — the hot path's form (the serving engine, the model's blocks): off,
  a site costs one flag test, with no context manager, allocation or
  clock read.  Read ``on`` once into a local where a call opens and
  closes several spans, so a change of the gate mid-call cannot unbalance
  the stack.

``TRACER`` is the process-global tracer of the serving engine and the
model's blocks.  It is off by default and records while ``enabled`` is
set, or while a ``torch.profiler`` trace is active in the process: the
engine calls ``TRACER.poll()`` once a tick, which reads the profiler's
state, and ``TRACER.settle()`` when the tick ends, so outside a tick only
the explicit switch counts.  A profiled window thus carries the program's
spans on the host clock the profiler's device events are mapped to.

Serialization is JSONL (one span per line) with an exact round-trip:
``Tracer.from_jsonl(tracer.to_jsonl())`` reproduces every field.
``Tracer.leaves()`` flattens the tree into non-overlapping intervals.
"""
from __future__ import annotations

import heapq
import json
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["Span", "TRACER", "Tracer"]


@dataclass
class Span:
    span_id: int
    name: str
    t0: float
    t1: float
    parent: Optional[int] = None
    attrs: Dict[str, object] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_json(self) -> str:
        return json.dumps({
            "span_id": self.span_id, "name": self.name,
            "t0": self.t0, "t1": self.t1, "parent": self.parent,
            "attrs": self.attrs,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "Span":
        d = json.loads(line)
        return cls(span_id=int(d["span_id"]), name=d["name"],
                   t0=float(d["t0"]), t1=float(d["t1"]),
                   parent=d.get("parent"), attrs=d.get("attrs") or {})


class Tracer:
    """Collects spans while ``on``.  ``enabled`` is the explicit switch and
    sets ``on``; ``poll()`` also turns it on while a ``torch.profiler``
    trace is active.  Off, ``add`` returns -1 and ``span()`` records
    nothing."""

    def __init__(self, enabled: bool = True) -> None:
        self.spans: List[Span] = []
        self._next_id = 0
        # open spans, innermost last: (span_id, name, t0, parent, attrs)
        self._stack: List[tuple] = []
        self.enabled = enabled

    @property
    def enabled(self) -> bool:
        return self._enabled

    @enabled.setter
    def enabled(self, value: bool) -> None:
        self._enabled = bool(value)
        self.on = self._enabled

    def poll(self) -> bool:
        """Turn ``on`` while enabled or while a ``torch.profiler`` trace is
        active in the process, and return it.  Call once per unit of work
        (an engine tick), never at a span site."""
        self.on = self._enabled or torch.autograd._profiler_enabled()
        return self.on

    def settle(self) -> None:
        """End of the polled unit of work: back to the explicit switch."""
        self.on = self._enabled

    def add(self, name: str, t0: float, t1: float,
            parent: Optional[int] = None, **attrs) -> int:
        """Record an already-timed span; returns its id (-1 if
        off) for use as a later span's ``parent``."""
        if not self.on:
            return -1
        sid = self._next_id
        self._next_id += 1
        self.spans.append(Span(span_id=sid, name=name, t0=float(t0),
                               t1=float(t1), parent=parent, attrs=attrs))
        return sid

    def open(self, name: str, t0: Optional[float] = None, **attrs) -> int:
        """Open a span under the innermost open one, from ``t0`` (now by
        default); returns its id.  The caller has tested ``on``."""
        return self._push(name, t0, attrs)

    def _push(self, name: str, t0: Optional[float], attrs: Dict) -> int:
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1][0] if self._stack else None
        self._stack.append((sid, name, time.perf_counter() if t0 is None else t0,
                            parent, attrs))
        return sid

    def close(self, t1: Optional[float] = None, **attrs) -> Span:
        """Close the innermost open span at ``t1`` (now by default), adding
        ``attrs`` to the ones it was opened with, and record it."""
        sid, name, t0, parent, kept = self._stack.pop()
        kept.update(attrs)
        span = Span(span_id=sid, name=name, t0=t0,
                    t1=time.perf_counter() if t1 is None else t1,
                    parent=parent, attrs=kept)
        self.spans.append(span)
        return span

    def then(self, name: str, t: Optional[float] = None, **attrs) -> int:
        """Close the innermost open span at ``t`` (now by default), adding
        ``attrs`` to it, and open its next sibling ``name`` from the same
        instant."""
        t = time.perf_counter() if t is None else t
        self.close(t, **attrs)
        return self.open(name, t)

    def span(self, name: str, **attrs):
        """Context-manager span; nests under the innermost open span and
        yields its id.  Off, a shared no-op context that yields None."""
        if not self.on:
            return _OFF
        return _OpenSpan(self, name, attrs)

    def clear(self) -> None:
        self.spans.clear()
        self._stack.clear()
        self._next_id = 0

    # -- serialization ------------------------------------------------------

    def to_jsonl(self) -> str:
        return "".join(s.to_json() + "\n" for s in self.spans)

    @classmethod
    def from_jsonl(cls, text: str) -> List[Span]:
        return [Span.from_json(line)
                for line in text.splitlines() if line.strip()]

    # -- queries ------------------------------------------------------------

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span_id: int) -> List[Span]:
        return [s for s in self.spans if s.parent == span_id]

    def leaves(self) -> List[Tuple[str, float, float]]:
        """The recorded spans as non-overlapping ``(name, t0, t1)``
        intervals in time order: each instant is charged to the innermost
        span open then (the deepest in the tree; of two as deep, the one
        started later), adjacent pieces of one span merged.  Instants no
        span covers are left out."""
        by_id = {s.span_id: s for s in self.spans}
        depth: Dict[int, int] = {}
        for s in self.spans:
            chain, p = [], s
            while p is not None and p.span_id not in depth:
                chain.append(p)
                p = by_id.get(p.parent) if p.parent is not None else None
            d = depth[p.span_id] if p is not None else -1
            for q in reversed(chain):
                d += 1
                depth[q.span_id] = d
        order = sorted((s for s in self.spans if s.t1 > s.t0), key=lambda s: s.t0)
        bounds = sorted({t for s in order for t in (s.t0, s.t1)})
        out: List[Tuple[str, float, float]] = []
        heap: list = []
        last_id, j = None, 0
        for b, b_next in zip(bounds, bounds[1:]):
            while j < len(order) and order[j].t0 <= b:
                s = order[j]
                heapq.heappush(heap, (-depth[s.span_id], -s.t0, s.span_id, s.t1, s.name))
                j += 1
            while heap and heap[0][3] <= b:
                heapq.heappop(heap)
            if not heap:
                last_id = None
                continue
            sid, name = heap[0][2], heap[0][4]
            if sid == last_id:
                out[-1] = (name, out[-1][1], b_next)
            else:
                out.append((name, b, b_next))
            last_id = sid
        return out


class _OpenSpan:
    __slots__ = ("tracer", "name", "attrs")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict) -> None:
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self) -> int:
        return self.tracer._push(self.name, None, self.attrs)

    def __exit__(self, *exc) -> None:
        self.tracer.close()


_OFF = nullcontext()

# The serving engine's and the model's spans (module docstring).
TRACER = Tracer(enabled=False)
