"""Explainability Generator (Sect. 4.6).

Produces the Explainability Report: a human-readable rationale per retained
constraint plus the estimated range of environmental gain.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from .types import Constraint


@dataclass
class ExplainabilityReport:
    entries: List[str]

    def render(self) -> str:
        return "\n\n".join(self.entries)


def generate_report(constraints: Sequence[Constraint]) -> ExplainabilityReport:
    entries = []
    for c in sorted(constraints, key=lambda c: -c.weight):
        entries.append(c.explanation)
    return ExplainabilityReport(entries)
