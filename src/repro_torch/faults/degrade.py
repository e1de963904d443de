"""Degraded-mode views over the carbon and workload traces.

The runtime never reads the raw traces directly when a fault schedule
is attached — it reads these wrappers, which present *what the platform
would actually observe* under the schedule:

* :class:`DegradedCarbon` — zones in blackout report their last
  observed intensity (persistence).  Planning signals (history,
  forecast, scenario ensemble) come from the frozen series, with the
  scenario sigma widened per stale hour so the planner hedges harder
  the longer a feed has been dark.  ``now``/``future_matrix`` delegate
  to the TRUE trace: accounting never lies, and the oracle stays a true
  oracle.
* :class:`DegradedWorkload` — telemetry dropout ticks return samples
  with the SAME identities (services, flavours, edges) but NaN values.
  Identity preservation keeps the constraint engine's structural key
  stable (the fused scan stays native); NaN values make every fresh
  constraint pass come up empty, so KB profiles hold under the
  existing mu-decay instead of ingesting garbage.  Workload spikes
  scale sample values multiplicatively.

Both wrappers are pure functions of the tick — no mutable cross-tick
state — which is what lets the eager and scanned paths share them and
stay bit-identical.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from math import nan
from typing import Callable, List

import numpy as np

from .trace import FaultTrace

__all__ = ["DegradedCarbon", "DegradedWorkload"]


@dataclass
class DegradedCarbon:
    """Carbon trace as observed through zone blackouts.

    ``base`` duck-types :class:`repro_torch.continuum.traces.CarbonTrace`
    (``_series``, ``hours``, ``seed``, ``history_signal``,
    ``forecast_signal``, ``perturb_scenarios``, ``now``,
    ``future_matrix``).  A shadow trace with causally forward-filled
    series backs every *planning* signal; truth backs accounting.
    """

    base: object
    faults: FaultTrace
    widen_per_stale_h: float = 0.05
    _shadow: object = field(init=False, repr=False)

    def __post_init__(self) -> None:
        shadow = type(self.base)(
            regions={}, hours=self.base.hours, seed=self.base.seed)
        for region, series in self.base._series.items():
            shadow._series[region] = series
        for zi, zone in enumerate(self.faults.zones):
            series = self.base._series.get(zone)
            if series is None:
                continue
            observed = np.asarray(series, float).copy()
            dark = self.faults.zone_dark[:, zi]
            hi = min(len(observed), len(dark))
            for t in range(1, hi):
                if dark[t]:
                    # persistence: hold the last value that was observed
                    # (itself possibly held — consecutive dark ticks
                    # freeze at the pre-blackout level)
                    observed[t] = observed[t - 1]
            shadow._series[zone] = observed
        self._shadow = shadow

    # -- trace surface ------------------------------------------------------

    @property
    def hours(self) -> int:
        return self.base.hours

    @property
    def seed(self) -> int:
        return self.base.seed

    def series(self, region: str) -> np.ndarray:
        """The OBSERVED series (frozen through blackouts)."""
        return self._shadow.series(region)

    # planning signals: observed world
    def history_signal(self, t: int) -> Callable:
        return self._shadow.history_signal(t)

    def forecast_signal(self, t: int, horizon: int) -> Callable:
        return self._shadow.forecast_signal(t, horizon)

    def scenario_matrix(self, node_regions: List[str], t: int,
                        horizon: int = 24, B: int = 8) -> np.ndarray:
        """Scenario ensemble around the OBSERVED forecast, with the
        lognormal sigma widened per stale hour for dark zones.  With no
        active blackout this is bit-identical to the base trace's
        ensemble (same seed substream, same scalar-sigma draw)."""
        mat = self._shadow.scenario_matrix(
            node_regions, t, horizon=horizon, B=B)
        stale = np.array(
            [self.faults.staleness(r, t) for r in node_regions], float)
        if not stale.any():
            return mat
        base_vec = np.asarray(mat[0], float)  # branch 0 = persistence mean
        sigma = 0.10 * (1.0 + self.widen_per_stale_h * stale)
        return self.base.perturb_scenarios(base_vec, t, B=B, sigma=sigma)

    # truth: accounting and the oracle
    def now(self, node_regions: List[str], t: int) -> np.ndarray:
        return self.base.now(node_regions, t)

    def future_matrix(self, node_regions: List[str], t: int,
                      horizon: int = 24) -> np.ndarray:
        return self.base.future_matrix(node_regions, t, horizon=horizon)


def _scale_samples(mon, m: float):
    energy = tuple(
        dataclasses.replace(e, energy_kwh=e.energy_kwh * m)
        for e in mon.energy)
    traffic = tuple(
        dataclasses.replace(s, request_volume=s.request_volume * m)
        for s in mon.traffic)
    return dataclasses.replace(mon, energy=energy, traffic=traffic)


def _nanify(mon):
    energy = tuple(
        dataclasses.replace(e, energy_kwh=nan) for e in mon.energy)
    traffic = tuple(
        dataclasses.replace(s, request_volume=nan) for s in mon.traffic)
    return dataclasses.replace(mon, energy=energy, traffic=traffic)


@dataclass
class DegradedWorkload:
    """Workload trace as observed through telemetry dropouts and spikes.

    ``base`` duck-types :class:`repro_torch.continuum.traces.WorkloadTrace`
    (just ``monitoring(t)``).
    """

    base: object
    faults: FaultTrace

    def clean(self, t: int):
        """The true monitoring at ``t`` (spikes applied — spikes are
        real load, not a measurement artefact)."""
        mon = self.base.monitoring(t)
        m = self.faults.spike_at(t)
        return _scale_samples(mon, m) if m != 1.0 else mon

    def monitoring(self, t: int):
        """What the collector delivers: NaN-valued clones of the true
        samples during a dropout, the true samples otherwise."""
        mon = self.clean(t)
        return _nanify(mon) if self.faults.dropout_at(t) else mon

    def stale(self, t: int, window: int = 1) -> bool:
        """True when any tick in the telemetry window ``[t-window+1, t]``
        dropped — the pooled buffer is then contaminated by NaNs and the
        lowering must hold the last clean profiles instead."""
        w = max(int(window), 1)
        return any(self.faults.dropout_at(t - k) for k in range(w))

    def lowering_monitoring(self, t: int, window: int = 1):
        """The monitoring to lower against while stale: the newest tick
        whose whole telemetry window is clean.  If the trace has been
        dropping since the start (no clean tick exists), fall back to
        the true samples at ``t`` — a documented bootstrap, not a hold."""
        w = max(int(window), 1)
        tt = t
        while tt >= 0:
            if not self.stale(tt, w):
                return self.clean(tt)
            tt -= 1
        return self.clean(t)
