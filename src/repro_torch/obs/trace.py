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

Two ways to record:

* ``with tracer.span("name", **attrs):`` — nested host-side spans for
  the eager path; parents are tracked on a stack.
* ``tracer.add(name, t0, t1, parent=..., **attrs)`` — low-level entry
  for code that already captured ``time.perf_counter()`` timestamps and
  must not restructure its control flow (the eager tick body), or that
  reconstructs timing post-hoc (the fused scan commits whole-trace
  spans after the fused program returns — there are deliberately no
  per-tick host spans inside the fused program).

Serialization is JSONL (one span per line) with an exact round-trip:
``Tracer.from_jsonl(tracer.to_jsonl())`` reproduces every field.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer"]


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
    """Collects spans; ``enabled=False`` turns every call into a no-op
    (``add`` returns -1, ``span()`` yields without recording)."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.spans: List[Span] = []
        self._next_id = 0
        self._stack: List[int] = []

    def add(self, name: str, t0: float, t1: float,
            parent: Optional[int] = None, **attrs) -> int:
        """Record an already-timed span; returns its id (-1 if
        disabled) for use as a later span's ``parent``."""
        if not self.enabled:
            return -1
        sid = self._next_id
        self._next_id += 1
        self.spans.append(Span(span_id=sid, name=name, t0=float(t0),
                               t1=float(t1), parent=parent, attrs=attrs))
        return sid

    @contextmanager
    def span(self, name: str, **attrs):
        """Context-manager span; nests under the innermost open span."""
        if not self.enabled:
            yield None
            return
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1] if self._stack else None
        t0 = time.perf_counter()
        self._stack.append(sid)
        try:
            yield sid
        finally:
            self._stack.pop()
            self.spans.append(Span(span_id=sid, name=name, t0=t0,
                                   t1=time.perf_counter(),
                                   parent=parent, attrs=attrs))

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
