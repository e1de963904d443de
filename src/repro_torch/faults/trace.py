"""Seeded, trace-aligned fault schedules for the continuum runtime.

A :class:`FaultTrace` is the fault analogue of ``CarbonTrace`` /
``WorkloadTrace``: a deterministic, absolutely-indexed schedule (row
``t`` = trace tick ``t``) of the ways the world misbehaves —

* **node outages** — ``alive[T, N]``: a dead node takes its services
  down with it (the runtime evicts and, when enabled, emergency-replans
  the stranded services);
* **carbon-signal blackouts** — ``zone_dark[T, Z]``: a zone's carbon
  feed goes dark; the runtime plans on the last observed value
  (persistence) with staleness-widened scenario ensembles, while
  accounting stays on the TRUE series;
* **telemetry dropouts** — ``telemetry_drop[T]``: the monitoring
  collector returns samples with the same identities but NaN values, so
  the constraint engine's structural key stays stable while every
  fresh-constraint pass comes up empty and the KB decays under its
  existing mu rule;
* **workload spikes** — ``spike[T]``: multiplicative bursts on energy /
  traffic samples (pure value drift — rides the delta-replanning path);
* **capacity derates** — optional ``derate[T, N]``: brownouts that
  scale a node's cpu/ram capacity.  These change the capacity tensors
  mid-trace, which the fused scan treats as constants, so they are the
  one *structural* fault kind: ``run_scanned`` falls back loudly.

Out-of-range ticks are fault-free, so a schedule shorter than the run
simply stops injecting.  All generators are keyed by ``(seed, tag)``
substreams, so traces are reproducible and prefix-stable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["FaultEvent", "FaultTrace", "FAULT_KINDS"]

FAULT_KINDS: Tuple[str, ...] = (
    "node_outage",
    "zone_blackout",
    "telemetry_dropout",
    "workload_spike",
    "capacity_derate",
)


@dataclass(frozen=True)
class FaultEvent:
    """One fault occurrence: ``kind`` (see :data:`FAULT_KINDS`),
    ``target`` (node id, zone, or ``""`` for app-wide faults), the start
    tick, the duration in ticks, and a magnitude (spike multiplier or
    derate floor; 1.0 where it has no meaning)."""

    kind: str
    target: str
    start: int
    hours: int
    magnitude: float = 1.0


@dataclass
class FaultTrace:
    """Absolute-tick fault schedule over a fixed node/zone universe.

    ``node_ids`` must match the infrastructure's node order exactly —
    the runtime validates this at construction so ``alive[t]`` can be
    used directly as the lowering's node-axis mask.
    """

    node_ids: Tuple[str, ...]
    zones: Tuple[str, ...]
    ticks: int
    alive: np.ndarray                      # [T, N] bool
    zone_dark: np.ndarray                  # [T, Z] bool
    telemetry_drop: np.ndarray             # [T] bool
    spike: np.ndarray                      # [T] float (>= 0, 1.0 = none)
    derate: Optional[np.ndarray] = None    # [T, N] float in (0, 1]
    events: Tuple[FaultEvent, ...] = ()
    _stale: np.ndarray = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self.node_ids = tuple(self.node_ids)
        self.zones = tuple(self.zones)
        T, N, Z = int(self.ticks), len(self.node_ids), len(self.zones)
        self.alive = np.asarray(self.alive, bool).reshape(T, N)
        self.zone_dark = np.asarray(self.zone_dark, bool).reshape(T, Z)
        self.telemetry_drop = np.asarray(
            self.telemetry_drop, bool).reshape(T)
        self.spike = np.asarray(self.spike, float).reshape(T)
        if self.derate is not None:
            self.derate = np.asarray(self.derate, float).reshape(T, N)
            if (self.derate <= 0).any() or (self.derate > 1).any():
                raise ValueError("derate factors must be in (0, 1]")
        # consecutive dark ticks per zone, INCLUDING tick t itself
        stale = np.zeros((T, Z), np.int64)
        run = np.zeros(Z, np.int64)
        for t in range(T):
            run = np.where(self.zone_dark[t], run + 1, 0)
            stale[t] = run
        self._stale = stale

    # -- constructors -------------------------------------------------------

    @classmethod
    def none(cls, node_ids: Sequence[str], zones: Sequence[str] = (),
             ticks: int = 0) -> "FaultTrace":
        """A fault-free schedule (useful as an explicit control)."""
        node_ids, zones = tuple(node_ids), tuple(zones)
        T = int(ticks)
        return cls(
            node_ids=node_ids, zones=zones, ticks=T,
            alive=np.ones((T, len(node_ids)), bool),
            zone_dark=np.zeros((T, len(zones)), bool),
            telemetry_drop=np.zeros(T, bool),
            spike=np.ones(T),
        )

    @classmethod
    def from_events(cls, node_ids: Sequence[str], zones: Sequence[str],
                    ticks: int, events: Sequence[FaultEvent]
                    ) -> "FaultTrace":
        """Build the schedule arrays from an explicit event list."""
        node_ids, zones = tuple(node_ids), tuple(zones)
        T, N, Z = int(ticks), len(node_ids), len(zones)
        nidx = {nid: i for i, nid in enumerate(node_ids)}
        zidx = {z: i for i, z in enumerate(zones)}
        alive = np.ones((T, N), bool)
        dark = np.zeros((T, Z), bool)
        drop = np.zeros(T, bool)
        spike = np.ones(T)
        derate = None
        for ev in events:
            lo = max(int(ev.start), 0)
            hi = min(int(ev.start) + int(ev.hours), T)
            if hi <= lo:
                continue
            if ev.kind == "node_outage":
                if ev.target not in nidx:
                    raise ValueError(f"unknown node {ev.target!r}")
                alive[lo:hi, nidx[ev.target]] = False
            elif ev.kind == "zone_blackout":
                if ev.target not in zidx:
                    raise ValueError(f"unknown zone {ev.target!r}")
                dark[lo:hi, zidx[ev.target]] = True
            elif ev.kind == "telemetry_dropout":
                drop[lo:hi] = True
            elif ev.kind == "workload_spike":
                spike[lo:hi] = np.maximum(spike[lo:hi], ev.magnitude)
            elif ev.kind == "capacity_derate":
                if ev.target not in nidx:
                    raise ValueError(f"unknown node {ev.target!r}")
                if derate is None:
                    derate = np.ones((T, N))
                derate[lo:hi, nidx[ev.target]] = np.minimum(
                    derate[lo:hi, nidx[ev.target]], ev.magnitude)
            else:
                raise ValueError(
                    f"unknown fault kind {ev.kind!r} "
                    f"(expected one of {FAULT_KINDS})")
        return cls(node_ids=node_ids, zones=zones, ticks=T, alive=alive,
                   zone_dark=dark, telemetry_drop=drop, spike=spike,
                   derate=derate, events=tuple(events))

    @classmethod
    def generate(cls, node_ids: Sequence[str], zones: Sequence[str],
                 ticks: int, seed: int = 0, earliest: int = 0,
                 node_outages: int = 3,
                 outage_hours: Tuple[int, int] = (4, 12),
                 zone_blackouts: int = 1,
                 blackout_hours: Tuple[int, int] = (6, 24),
                 telemetry_dropouts: int = 1,
                 dropout_hours: Tuple[int, int] = (2, 6),
                 workload_spikes: int = 1,
                 spike_hours: Tuple[int, int] = (2, 8),
                 spike_magnitude: float = 2.5,
                 capacity_derates: int = 0,
                 derate_hours: Tuple[int, int] = (4, 12),
                 derate_floor: float = 0.5) -> "FaultTrace":
        """Seeded random schedule.  Event starts are drawn uniformly in
        ``[earliest, ticks)``; independent ``(seed, tag)`` substreams
        per fault family keep the families prefix-stable under parameter
        changes.  Node outages are re-drawn (up to 64 attempts each)
        rather than allowed to kill every node at once — the continuum
        must stay *degraded*, not vacuously empty."""
        node_ids, zones = tuple(node_ids), tuple(zones)
        T, N, Z = int(ticks), len(node_ids), len(zones)
        lo = min(max(int(earliest), 0), max(T - 1, 0))
        events: List[FaultEvent] = []

        def draw(rng, hours):
            s = int(rng.integers(lo, max(T, lo + 1)))
            h = int(rng.integers(hours[0], hours[1] + 1))
            return s, max(min(h, T - s), 1)

        alive = np.ones((T, N), bool)
        rng = np.random.default_rng((seed, 101))
        for _ in range(node_outages if N else 0):
            for _attempt in range(64):
                s, h = draw(rng, outage_hours)
                n = int(rng.integers(0, N))
                trial = alive.copy()
                trial[s:s + h, n] = False
                if trial.any(axis=1).all():
                    alive = trial
                    events.append(FaultEvent(
                        "node_outage", node_ids[n], s, h))
                    break

        dark = np.zeros((T, Z), bool)
        rng = np.random.default_rng((seed, 211))
        for _ in range(zone_blackouts if Z else 0):
            s, h = draw(rng, blackout_hours)
            z = int(rng.integers(0, Z))
            dark[s:s + h, z] = True
            events.append(FaultEvent("zone_blackout", zones[z], s, h))

        drop = np.zeros(T, bool)
        rng = np.random.default_rng((seed, 307))
        for _ in range(telemetry_dropouts):
            s, h = draw(rng, dropout_hours)
            drop[s:s + h] = True
            events.append(FaultEvent("telemetry_dropout", "", s, h))

        spike = np.ones(T)
        rng = np.random.default_rng((seed, 401))
        for _ in range(workload_spikes):
            s, h = draw(rng, spike_hours)
            spike[s:s + h] = np.maximum(spike[s:s + h], spike_magnitude)
            events.append(FaultEvent(
                "workload_spike", "", s, h, spike_magnitude))

        derate = None
        rng = np.random.default_rng((seed, 503))
        for _ in range(capacity_derates if N else 0):
            s, h = draw(rng, derate_hours)
            n = int(rng.integers(0, N))
            if derate is None:
                derate = np.ones((T, N))
            derate[s:s + h, n] = np.minimum(
                derate[s:s + h, n], derate_floor)
            events.append(FaultEvent(
                "capacity_derate", node_ids[n], s, h, derate_floor))

        return cls(node_ids=node_ids, zones=zones, ticks=T, alive=alive,
                   zone_dark=dark, telemetry_drop=drop, spike=spike,
                   derate=derate, events=tuple(events))

    # -- per-tick accessors (absolute tick; out of range = fault-free) ------

    def _in_range(self, t: int) -> bool:
        return 0 <= t < self.ticks

    def alive_at(self, t: int) -> np.ndarray:
        if self._in_range(t):
            return self.alive[t]
        return np.ones(len(self.node_ids), bool)

    def dropout_at(self, t: int) -> bool:
        return self._in_range(t) and bool(self.telemetry_drop[t])

    def spike_at(self, t: int) -> float:
        return float(self.spike[t]) if self._in_range(t) else 1.0

    def derate_at(self, t: int) -> Optional[np.ndarray]:
        """Per-node capacity factors at ``t``, or None when every node
        runs at full capacity (the common case pays nothing)."""
        if self.derate is None or not self._in_range(t):
            return None
        row = self.derate[t]
        return row if (row != 1.0).any() else None

    def has_derates(self, start: int, ticks: int) -> bool:
        """Any capacity derate inside ``[start, start + ticks)`` — the
        structural-fault probe the fused scan uses to fall back."""
        if self.derate is None:
            return False
        lo = max(int(start), 0)
        hi = min(int(start) + int(ticks), self.ticks)
        return hi > lo and bool((self.derate[lo:hi] != 1.0).any())

    def dark_at(self, t: int) -> np.ndarray:
        if self._in_range(t):
            return self.zone_dark[t]
        return np.zeros(len(self.zones), bool)

    def staleness(self, zone: str, t: int) -> int:
        """Consecutive ticks (including ``t``) the zone's carbon feed
        has been dark; 0 for fresh or unknown zones."""
        if zone not in self.zones or not self._in_range(t):
            return 0
        return int(self._stale[t, self.zones.index(zone)])

    def starting(self, t: int) -> List[FaultEvent]:
        """Fault occurrences whose first tick is ``t``, derived from the
        schedule arrays (so explicitly-constructed traces report the
        same transitions as generated ones).  Used by the obs layer to
        emit exactly one structured event per occurrence."""
        if not self._in_range(t):
            return []
        out: List[FaultEvent] = []

        def run_len(col: np.ndarray) -> int:
            h = 0
            while t + h < self.ticks and col[t + h]:
                h += 1
            return h

        prev_alive = self.alive[t - 1] if t > 0 \
            else np.ones(len(self.node_ids), bool)
        for n in np.nonzero(prev_alive & ~self.alive[t])[0]:
            out.append(FaultEvent(
                "node_outage", self.node_ids[int(n)], t,
                run_len(~self.alive[:, int(n)])))
        prev_dark = self.zone_dark[t - 1] if t > 0 \
            else np.zeros(len(self.zones), bool)
        for z in np.nonzero(~prev_dark & self.zone_dark[t])[0]:
            out.append(FaultEvent(
                "zone_blackout", self.zones[int(z)], t,
                run_len(self.zone_dark[:, int(z)])))
        prev_drop = bool(self.telemetry_drop[t - 1]) if t > 0 else False
        if not prev_drop and bool(self.telemetry_drop[t]):
            out.append(FaultEvent(
                "telemetry_dropout", "", t, run_len(self.telemetry_drop)))
        prev_spike = float(self.spike[t - 1]) if t > 0 else 1.0
        if prev_spike == 1.0 and float(self.spike[t]) != 1.0:
            out.append(FaultEvent(
                "workload_spike", "", t, run_len(self.spike != 1.0),
                float(self.spike[t])))
        if self.derate is not None:
            prev_row = self.derate[t - 1] if t > 0 \
                else np.ones(len(self.node_ids))
            for n in np.nonzero((prev_row == 1.0)
                                & (self.derate[t] != 1.0))[0]:
                out.append(FaultEvent(
                    "capacity_derate", self.node_ids[int(n)], t,
                    run_len(self.derate[:, int(n)] != 1.0),
                    float(self.derate[t, int(n)])))
        return out

    def check_infra(self, infra) -> None:
        """Validate the node universe against an Infrastructure: the
        schedule's node order IS the lowering's node axis."""
        ids = tuple(n.node_id for n in infra.nodes)
        if ids != self.node_ids:
            raise ValueError(
                f"FaultTrace node order {self.node_ids!r} does not match "
                f"the infrastructure {ids!r} — build the schedule from "
                "the same node list the runtime plans over")

    def summary(self) -> dict:
        return {
            "ticks": int(self.ticks),
            "node_outages": sum(
                1 for e in self.events if e.kind == "node_outage"),
            "zone_blackouts": sum(
                1 for e in self.events if e.kind == "zone_blackout"),
            "telemetry_dropouts": sum(
                1 for e in self.events if e.kind == "telemetry_dropout"),
            "workload_spikes": sum(
                1 for e in self.events if e.kind == "workload_spike"),
            "capacity_derates": sum(
                1 for e in self.events if e.kind == "capacity_derate"),
            "dead_node_ticks": int((~self.alive).sum()),
            "dark_zone_ticks": int(self.zone_dark.sum()),
            "dropout_ticks": int(self.telemetry_drop.sum()),
        }
