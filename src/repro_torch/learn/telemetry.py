"""Batched monitoring ingestion: samples -> ring-buffered tensors.

The reference :class:`~repro_torch.core.energy.EnergyEstimator` re-walks the
tick's ``MonitoringData`` sample-by-sample in Python.  ``TelemetryBuffer``
ingests the same samples as three scatter-adds into per-tick tensor rows:

  ``energy_sum / energy_count  [W, SF]`` — Eq. 1 computation-energy sums
      per (service, flavour) key (flat registry, first-occurrence order);
  ``comm_sum / comm_count      [W, L]``  — Eq. 2/13 communication-energy
      sums per (source, source flavour, target) key;
  ``carbon                     [W, N]``  — per-node carbon intensity
      (NaN where the node's CI is unknown at that tick);

where ``W`` is the ring window (ticks kept), and rows recycle oldest-first.
``np.add.at`` accumulates repeated indices in sample order, so the per-key
partial sums — and therefore the Eq. 1/2 mean profiles — are bit-identical
to the estimator's dict walk; ``computation_profiles()`` /
``communication_profiles()`` with ``last=1`` reproduce the estimator's
output for that tick exactly (same values, same key order: the registry
appends keys in first-occurrence order, just like the estimator's dicts).
``last > 1`` pools the ring window into smoothed multi-tick profiles, the
knob the reference path does not have.

Key registries are append-only and grow the ring columns on demand, so an
application whose observed services/flows drift never needs a rebuild.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.energy import K_TRANSMISSION_KWH_PER_GB_2025
from repro_torch.core.types import Infrastructure, MonitoringData


@dataclass
class TelemetryBuffer:
    """Ring-buffered tensor view of the monitoring stream."""

    window: int = 24
    k_kwh_per_gb: float = K_TRANSMISSION_KWH_PER_GB_2025

    # registries: key -> column (append-only, first-occurrence order)
    sf_keys: List[Tuple[str, str]] = field(default_factory=list)
    edge_keys: List[Tuple[str, str, str]] = field(default_factory=list)
    node_ids: List[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._sf_index: Dict[Tuple[str, str], int] = {
            k: i for i, k in enumerate(self.sf_keys)}
        self._edge_index: Dict[Tuple[str, str, str], int] = {
            k: i for i, k in enumerate(self.edge_keys)}
        self._node_index: Dict[str, int] = {
            k: i for i, k in enumerate(self.node_ids)}
        W = self.window
        self.energy_sum = np.zeros((W, len(self.sf_keys)))
        self.energy_count = np.zeros((W, len(self.sf_keys)), np.int64)
        self.comm_sum = np.zeros((W, len(self.edge_keys)))
        self.comm_count = np.zeros((W, len(self.edge_keys)), np.int64)
        self.carbon = np.full((W, len(self.node_ids)), np.nan)
        # ring bookkeeping: which tick occupies each slot (-1 = empty),
        # and the ingestion order (newest last)
        self.slot_tick = np.full(W, -1, np.int64)
        self._order: List[int] = []          # slots, oldest -> newest

    # -- registries ---------------------------------------------------------

    @staticmethod
    def _rows(index: Dict, keys: List, wanted) -> List[int]:
        """Map keys to columns, registering new ones in encounter order
        (growth of the ring columns is deferred to ``_sync``, one pad per
        tick instead of one per key)."""
        out = []
        get = index.get
        for key in wanted:
            r = get(key)
            if r is None:
                r = len(keys)
                index[key] = r
                keys.append(key)
            out.append(r)
        return out

    def _sync(self, name: str, width: int, fill) -> None:
        a = getattr(self, name)
        if a.shape[1] < width:
            pad = np.full((self.window, width - a.shape[1]), fill,
                          dtype=a.dtype)
            setattr(self, name, np.concatenate([a, pad], axis=1))

    # -- ingestion ----------------------------------------------------------

    def ingest(self, t: int, monitoring: MonitoringData,
               infra: Optional[Infrastructure] = None) -> int:
        """Ingest one observation window into a ring slot; returns the slot.

        Re-ingesting the same tick overwrites its slot; otherwise the
        oldest slot is recycled.
        """
        # map samples to columns first (may grow the ring), then scatter
        e_idx = self._rows(self._sf_index, self.sf_keys,
                           ((s.service, s.flavour)
                            for s in monitoring.energy))
        c_idx = self._rows(self._edge_index, self.edge_keys,
                           ((s.source, s.source_flavour, s.target)
                            for s in monitoring.traffic))
        if infra is not None:
            self._rows(self._node_index, self.node_ids,
                       (n.node_id for n in infra.nodes))
        self._sync("energy_sum", len(self.sf_keys), 0)
        self._sync("energy_count", len(self.sf_keys), 0)
        self._sync("comm_sum", len(self.edge_keys), 0)
        self._sync("comm_count", len(self.edge_keys), 0)
        self._sync("carbon", len(self.node_ids), np.nan)

        slot = self._slot_for(t)
        self.energy_sum[slot] = 0.0
        self.energy_count[slot] = 0
        self.comm_sum[slot] = 0.0
        self.comm_count[slot] = 0
        self.carbon[slot] = np.nan
        if e_idx:
            idx = np.asarray(e_idx, np.int64)
            vals = np.fromiter((s.energy_kwh for s in monitoring.energy),
                               np.float64, count=len(e_idx))
            np.add.at(self.energy_sum[slot], idx, vals)
            np.add.at(self.energy_count[slot], idx, 1)
        if c_idx:
            idx = np.asarray(c_idx, np.int64)
            vol = np.fromiter((s.request_volume for s in monitoring.traffic),
                              np.float64, count=len(c_idx))
            size = np.fromiter(
                (s.request_size_gb for s in monitoring.traffic),
                np.float64, count=len(c_idx))
            # same association as the estimator: (volume * size) * k
            np.add.at(self.comm_sum[slot], idx,
                      vol * size * self.k_kwh_per_gb)
            np.add.at(self.comm_count[slot], idx, 1)
        if infra is not None:
            for n in infra.nodes:
                if n.carbon is not None:
                    self.carbon[slot, self._node_index[n.node_id]] = n.carbon
        return slot

    def _slot_for(self, t: int) -> int:
        hit = np.nonzero(self.slot_tick == t)[0]
        if hit.size:
            slot = int(hit[0])
            self._order.remove(slot)
        elif len(self._order) < self.window:
            slot = len(self._order)
        else:
            slot = self._order.pop(0)  # recycle the oldest
        self.slot_tick[slot] = t
        self._order.append(slot)
        return slot

    # -- profile views ------------------------------------------------------

    @property
    def ticks(self) -> List[int]:
        """Ingested ticks, oldest -> newest."""
        return [int(self.slot_tick[s]) for s in self._order]

    def _recent_slots(self, last: int) -> List[int]:
        if not self._order:
            return []
        return self._order[-max(int(last), 1):]

    def computation_profiles(self, last: int = 1):
        """Eq. 1 mean energy per (service, flavour) over the last ``last``
        ingested ticks; ``last=1`` is bit-identical to
        ``EnergyEstimator.computation_profiles`` on that tick's samples."""
        slots = self._recent_slots(last)
        if not slots:
            return {}
        sums = self.energy_sum[slots].sum(axis=0)
        cnts = self.energy_count[slots].sum(axis=0)
        return {k: float(sums[i] / cnts[i])
                for i, k in enumerate(self.sf_keys) if cnts[i]}

    def communication_profiles(self, last: int = 1):
        """Eq. 2 mean communication energy per (source, flavour, target)
        under the Eq. 13 transmission model over the last ``last`` ticks."""
        slots = self._recent_slots(last)
        if not slots:
            return {}
        sums = self.comm_sum[slots].sum(axis=0)
        cnts = self.comm_count[slots].sum(axis=0)
        return {k: float(sums[i] / cnts[i])
                for i, k in enumerate(self.edge_keys) if cnts[i]}

    def carbon_now(self, node_ids=None) -> np.ndarray:
        """``[N]`` latest-ingested carbon intensity per node (NaN where
        never observed)."""
        ids = list(node_ids) if node_ids is not None else self.node_ids
        out = np.full(len(ids), np.nan)
        if not self._order:
            return out
        newest = self._order[-1]
        for j, nid in enumerate(ids):
            r = self._node_index.get(nid)
            if r is not None:
                out[j] = self.carbon[newest, r]
        return out

    def energy_tensor(self, service_ids, flavour_names,
                      last: int = 1) -> np.ndarray:
        """``[S, F]`` Eq. 1 profile tensor in the caller's (service,
        flavour-slot) layout — the shape the constraint engine and the
        scheduler lowering consume.  NaN where a slot was never observed
        in the window."""
        prof = self.computation_profiles(last=last)
        S = len(service_ids)
        F = max((len(f) for f in flavour_names), default=0)
        out = np.full((S, max(F, 1)), np.nan)
        for i, sid in enumerate(service_ids):
            for f, fname in enumerate(flavour_names[i]):
                v = prof.get((sid, fname))
                if v is not None:
                    out[i, f] = v
        return out
