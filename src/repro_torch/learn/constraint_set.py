"""Lazy columnar view over a ranked constraint list.

The Eq. 11/12 ranking pass used to finish by *cloning* every kept
constraint object with its tick weight (``clone_constraint`` per row) —
at the 1000x200 grid that is tens of thousands of frozen-dataclass
materializations per tick, and it was the incremental constraint pass's
floor.  :class:`ConstraintSet` keeps the ranking columnar instead:

  ``base``           [C] object  — the cached per-candidate constraint
                                   (weight fields stale, identity fields
                                   authoritative);
  ``weight``         [C] float64 — the Eq. 11 rank weight w_i;
  ``memory_weight``  [C] float64 — the KB memory weight mu_i
                                   (1.0 for fresh constraints);
  ``generated_at``   [C] int64   — the stamping iteration;

in ranked order.  Consumers that only need arrays read the columns (the
scheduler's :func:`~repro_torch.core.lowering.lower_constraints` walks
:meth:`entries` triples; ``len``/truthiness never touch objects); anything
that needs real ``Constraint`` objects — reports, prolog rendering,
tests — materializes them on demand through the sequence protocol, with
memoization so repeated access stays cheap.

Equality against lists/tuples (and other ConstraintSets) compares the
materialized objects, so reference-parity assertions like
``engine_constraints == reference_constraints`` keep working unchanged.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.core.types import Constraint

from .kb_array import clone_constraint


class ConstraintSet(Sequence):
    """Ranked constraints as columns; objects instantiate on demand."""

    __slots__ = ("base", "weight", "memory_weight", "generated_at", "_memo")

    def __init__(self, base, weight, memory_weight, generated_at) -> None:
        self.base = np.asarray(base, dtype=object)
        self.weight = np.asarray(weight, dtype=np.float64)
        self.memory_weight = np.asarray(memory_weight, dtype=np.float64)
        self.generated_at = np.asarray(generated_at, dtype=np.int64)
        self._memo: dict = {}

    @classmethod
    def empty(cls) -> "ConstraintSet":
        return cls(np.zeros(0, object), np.zeros(0), np.zeros(0),
                   np.zeros(0, np.int64))

    @classmethod
    def from_objects(cls, constraints: Sequence[Constraint]) -> "ConstraintSet":
        """Wrap already-materialized constraints (columns read off them)."""
        cs = cls(
            np.asarray(list(constraints), dtype=object),
            [c.weight for c in constraints],
            [c.memory_weight for c in constraints],
            [c.generated_at for c in constraints],
        )
        cs._memo = {i: c for i, c in enumerate(constraints)}
        return cs

    # -- sequence protocol ---------------------------------------------------

    def __len__(self) -> int:
        return int(self.base.size)

    def _make(self, i: int) -> Constraint:
        c = self._memo.get(i)
        if c is None:
            base = self.base[i]
            w = float(self.weight[i])
            mw = float(self.memory_weight[i])
            gat = int(self.generated_at[i])
            if (base.weight == w and base.memory_weight == mw
                    and base.generated_at == gat):
                c = base
            else:
                c = clone_constraint(base, weight=w, memory_weight=mw,
                                     generated_at=gat)
            self._memo[i] = c
        return c

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._make(j) for j in range(*i.indices(len(self)))]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._make(i)

    def __iter__(self) -> Iterator[Constraint]:
        for i in range(len(self)):
            yield self._make(i)

    # -- columnar access -----------------------------------------------------

    def entries(self) -> Iterator[Tuple[Constraint, float, float]]:
        """``(base, weight, memory_weight)`` triples in ranked order,
        without materializing clones.  ``base`` carries the authoritative
        identity fields (kind/service/flavour/node/...); the effective
        penalty is ``weight * memory_weight`` from the columns."""
        return zip(self.base.tolist(), self.weight.tolist(),
                   self.memory_weight.tolist())

    def materialize(self) -> List[Constraint]:
        return [self._make(i) for i in range(len(self))]

    # -- comparisons ---------------------------------------------------------

    def __eq__(self, other):
        if isinstance(other, ConstraintSet):
            return (len(self) == len(other)
                    and self.materialize() == other.materialize())
        if isinstance(other, (list, tuple)):
            return self.materialize() == list(other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash(tuple(self.materialize()))

    def __repr__(self) -> str:
        return f"ConstraintSet({len(self)} constraints)"
