"""Constraints Ranker (Sect. 4.5).

w_i = Em_i / max_{c in CK} Em          (Eq. 11)
w_i <- lambda * w_i, lambda = 0.75 if Em_i < F else 1   (Eq. 12)
constraints with w_i < discard (0.1) are removed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence

from .types import Constraint


@dataclass
class ConstraintRanker:
    impact_floor_g: float = 0.0     # F: minimum absolute impact
    attenuation: float = 0.75       # lambda
    discard_below: float = 0.1

    def rank(self, constraints: Sequence[Constraint]) -> List[Constraint]:
        if not constraints:
            return []
        max_em = max(c.impact_g for c in constraints)
        if max_em <= 0:
            return []
        ranked: List[Constraint] = []
        for c in constraints:
            w = c.impact_g / max_em
            if c.impact_g < self.impact_floor_g:
                w *= self.attenuation
            if w < self.discard_below:
                continue
            ranked.append(dataclasses.replace(c, weight=w))
        ranked.sort(key=lambda c: -c.weight)
        return ranked
