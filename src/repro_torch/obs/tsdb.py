"""Ring-buffered time-series store for the watchtower.

The observability layer exports *snapshots*: the registry holds
current counter/gauge values and the ledger holds per-tick cells, but
nothing keeps an in-memory window of recent history that detectors and
burn-rate evaluators can read without re-walking the ledger.  This
module is that window: fixed-capacity numpy rings keyed by
``(name, labels)``, fed once per tick by :class:`repro_torch.obs.Watchtower`
from the registry and the emissions ledger.

Deliberately tiny and dependency-free: no retention policies, no
downsampling — a bounded ring per series, O(1) append, O(n) windowed
reads.  Values may be scalars or fixed-shape vectors (e.g. ``ci[N]``);
the shape is pinned by the first append.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["SeriesRing", "TimeSeriesStore"]


class SeriesRing:
    """Fixed-capacity ring of (tick, value) samples, oldest evicted first."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._ts: Optional[np.ndarray] = None
        self._vals: Optional[np.ndarray] = None
        self._head = 0          # next write slot
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def append(self, t: int, value) -> None:
        v = np.asarray(value, dtype=np.float64)
        if self._vals is None:
            self._ts = np.zeros(self.capacity, dtype=np.int64)
            self._vals = np.zeros((self.capacity,) + v.shape,
                                  dtype=np.float64)
        elif v.shape != self._vals.shape[1:]:
            raise ValueError(
                f"shape {v.shape} != pinned {self._vals.shape[1:]}")
        self._ts[self._head] = int(t)
        self._vals[self._head] = v
        self._head = (self._head + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)

    def _order(self) -> np.ndarray:
        # indices oldest..newest
        if self._count < self.capacity:
            return np.arange(self._count)
        return (np.arange(self.capacity) + self._head) % self.capacity

    @property
    def ts(self) -> np.ndarray:
        """Tick stamps, oldest..newest."""
        if self._ts is None:
            return np.zeros(0, dtype=np.int64)
        return self._ts[self._order()]

    @property
    def values(self) -> np.ndarray:
        """Values, oldest..newest (``[n]`` or ``[n, ...]``)."""
        if self._vals is None:
            return np.zeros(0, dtype=np.float64)
        return self._vals[self._order()]

    def last(self, n: int) -> np.ndarray:
        """The most recent ``min(n, len)`` values, oldest..newest."""
        v = self.values
        return v[max(0, len(v) - int(n)):]


class TimeSeriesStore:
    """Named series, each a :class:`SeriesRing`; labels pick sub-series."""

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._series: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                           SeriesRing] = {}

    @staticmethod
    def _key(name: str, labels) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        lab = tuple(sorted((str(k), str(v))
                           for k, v in (labels or {}).items()))
        return (str(name), lab)

    def series(self, name: str, labels=None) -> SeriesRing:
        key = self._key(name, labels)
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = SeriesRing(self.capacity)
        return ring

    def record(self, name: str, t: int, value, labels=None) -> None:
        self.series(name, labels).append(t, value)

    def names(self) -> List[str]:
        return sorted({k[0] for k in self._series})

    def window(self, name: str, n: int, labels=None) -> np.ndarray:
        """Last ``n`` values of a series (empty array if unknown)."""
        key = self._key(name, labels)
        ring = self._series.get(key)
        if ring is None:
            return np.zeros(0, dtype=np.float64)
        return ring.last(n)

    def capture_registry(self, t: int, registry) -> None:
        """Snapshot every registry counter and gauge into the store."""
        for key, val in registry.counters().items():
            name, labels = key if isinstance(key, tuple) else (key, ())
            self.record("counter." + str(name), t, val,
                        labels=dict(labels) if labels else None)
        for key, val in registry.gauges().items():
            name, labels = key if isinstance(key, tuple) else (key, ())
            self.record("gauge." + str(name), t, val,
                        labels=dict(labels) if labels else None)
