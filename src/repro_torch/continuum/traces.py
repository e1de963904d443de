"""Synthetic-but-realistic traces driving the continuum adaptive loop.

Two generators, both deterministic under a seed:

* :class:`CarbonTrace` — hourly grid carbon intensity per region: a daily
  cycle (solar dip in the afternoon / wind trough at night), AR(1) noise,
  and occasional renewable "ramp" events where CI drops sharply for a few
  hours (the temporal variation GreenScale/"Enabling Sustainable Clouds"
  exploit).  Exposes the same ``CarbonSignal`` callables the
  ``EnergyMixGatherer`` consumes for both its historical ``signal`` and its
  ``forecast`` hooks, plus a scenario-ensemble generator feeding the
  batched what-if planner (``ScenarioBatch.ci``).

* :class:`WorkloadTrace` — per-tick :class:`MonitoringData` for an
  application: computation energy follows a diurnal utilisation cycle with
  slow drift and noise; traffic volumes follow the same cycle.

All series are in the paper's units: kWh per observation window for energy,
gCO2eq/kWh for carbon intensity, one tick = one hour.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence

import numpy as np

from repro_torch.core.energy import CarbonSignal
from repro_torch.core.types import (
    Application,
    EnergySample,
    MonitoringData,
    TrafficSample,
)

_CI_FLOOR = 5.0  # gCO2eq/kWh — even hydro grids are never zero


def _parse_timestamp(ts: str):
    """Sortable timestamp: ISO-8601 (Z suffix tolerated) or epoch number;
    falls back to the raw string (lexicographic — correct for the common
    zero-padded exports)."""
    from datetime import datetime

    ts = ts.strip()
    try:
        return datetime.fromisoformat(ts.replace("Z", "+00:00"))
    except ValueError:
        pass
    try:
        return float(ts)
    except ValueError:
        return ts


def _fill_gaps(path: str, zone: str, rows: List) -> List:
    """Linearly interpolate missing observations inside one zone's sorted
    ``(timestamp, ci)`` rows.

    The zone's cadence is the smallest positive timestamp delta (hourly
    for ElectricityMaps, 5-minutely for WattTime); any wider delta that
    is an integer multiple of it is a gap and gets ``m - 1`` evenly
    spaced interpolated rows.  Exact-duplicate timestamps collapse to
    the last row (re-issued export lines).  Fallback string timestamps
    cannot be differenced, so those rows pass through untouched.
    """
    if len(rows) < 2 or isinstance(rows[0][0], str):
        return rows
    deltas = [b[0] - a[0] for a, b in zip(rows, rows[1:])]
    zero = deltas[0] - deltas[0]  # timedelta(0) or 0.0
    step = min((d for d in deltas if d > zero), default=None)
    if step is None:  # every row shares one timestamp
        return rows[-1:]
    out = [rows[0]]
    for (t0, v0), (t1, v1) in zip(rows, rows[1:]):
        if t1 == t0:          # duplicate observation: keep the re-issue
            out[-1] = (t1, v1)
            continue
        m = (t1 - t0) / step
        if abs(m - round(m)) > 1e-6:
            raise ValueError(
                f"{path!r}: zone {zone!r} has a gap of {t1 - t0!s} "
                f"between {t0!s} and {t1!s} that is not a whole number "
                f"of {step!s} steps — cannot interpolate")
        m = int(round(m))
        for i in range(1, m):
            out.append((t0 + i * step, v0 + (v1 - v0) * i / m))
        out.append((t1, v1))
    return out


@dataclass(frozen=True)
class RegionProfile:
    """Shape of one region's carbon-intensity process."""

    base: float               # mean CI, gCO2eq/kWh
    daily_amplitude: float    # half peak-to-trough of the diurnal cycle
    trough_hour: float        # hour-of-day of the daily CI minimum
    noise: float              # AR(1) innovation scale
    ramp_prob: float = 0.0    # per-hour probability a renewable ramp starts
    ramp_depth: float = 0.0   # fractional CI drop while ramping
    ramp_hours: int = 0


# A palette of grid archetypes for examples/benchmarks: a solar-heavy grid
# (clean afternoons), a windy one (clean nights, volatile), a hydro grid
# (clean and flat), and a fossil-heavy one (dirty and flat).
REGION_PRESETS: Dict[str, RegionProfile] = {
    "solar-south": RegionProfile(420.0, 170.0, 13.0, 12.0),
    "wind-north": RegionProfile(310.0, 90.0, 3.0, 28.0, 0.04, 0.55, 7),
    "hydro-west": RegionProfile(95.0, 12.0, 12.0, 4.0),
    "coal-east": RegionProfile(640.0, 35.0, 14.0, 10.0),
}


@dataclass
class CarbonTrace:
    """Seeded hourly carbon-intensity series for a set of regions."""

    regions: Mapping[str, RegionProfile]
    hours: int
    seed: int = 0
    _series: Dict[str, np.ndarray] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        for i, (name, prof) in enumerate(sorted(self.regions.items())):
            # independent streams per component so a longer trace shares
            # its prefix with a shorter one (benchmarks stay comparable
            # across horizon choices)
            rng_ar = np.random.default_rng((self.seed, i, 0))
            rng_ramp = np.random.default_rng((self.seed, i, 1))
            t = np.arange(self.hours)
            cycle = prof.daily_amplitude * np.cos(
                2.0 * np.pi * (t - prof.trough_hour) / 24.0)
            # cos peaks at the trough hour -> subtract to dip there
            ci = prof.base - cycle
            innov = rng_ar.normal(0.0, prof.noise, size=self.hours)
            ar = np.zeros(self.hours)
            for k in range(1, self.hours):
                ar[k] = 0.8 * ar[k - 1] + innov[k]
            ci = ci + ar
            if prof.ramp_prob > 0 and prof.ramp_hours > 0:
                starts = rng_ramp.random(self.hours) < prof.ramp_prob
                drop = np.zeros(self.hours)
                for k in np.nonzero(starts)[0]:
                    drop[k:k + prof.ramp_hours] = np.maximum(
                        drop[k:k + prof.ramp_hours], prof.ramp_depth)
                ci = ci * (1.0 - drop)
            self._series[name] = np.maximum(ci, _CI_FLOOR)

    def series(self, region: str) -> np.ndarray:
        return self._series[region]

    # -- recorded data (ROADMAP "Real carbon data") -------------------------

    @classmethod
    def from_csv(
        cls,
        path: str,
        seed: int = 0,
        aliases: Mapping[str, str] | None = None,
        fill_gaps: bool = True,
    ) -> "CarbonTrace":
        """Recorded carbon trace from an ElectricityMaps/WattTime-style
        CSV export: one row per (timestamp, zone) with the zone's carbon
        intensity in gCO2eq/kWh.

        Column names are sniffed case-insensitively: timestamp from
        ``timestamp``/``datetime``/``date``/``time``, zone from
        ``zone``/``zone_key``/``zone_id``/``zone_name``/``region``, and
        carbon intensity from ``carbon_intensity[_avg]``/
        ``co2_intensity``/``gco2eq_per_kwh``/``gco2_per_kwh``/``ci``.
        Rows are grouped per zone and sorted by timestamp (ISO-8601
        strings or epoch numbers); rows with an empty CI cell are
        skipped.  ``aliases`` maps export zone keys to the region names
        the infrastructure uses (``{"DE-LU": "DE"}``); two distinct
        zones mapping to the same region is an error, not a silent
        merge.  Internal gaps — missing rows between two observations
        of one zone, a routine artefact of ElectricityMaps/WattTime
        exports — are linearly interpolated onto the zone's own cadence
        when ``fill_gaps`` is true (the default; a gap that is not an
        integer number of steps raises instead of guessing, and
        fallback string timestamps — which cannot be differenced — are
        left untouched).  Zones are aligned on
        their latest common start timestamp (ragged exports must not be
        index-aligned: tick t has to mean the same wall-clock hour in
        every region) and then truncated to the shortest common length.

        The result is a regular :class:`CarbonTrace` — the recorded
        series sit behind the exact same ``history_signal`` /
        ``forecast_signal`` / ``scenario_matrix`` interface the
        ``EnergyMixGatherer`` and the adaptive loop consume, so swapping
        synthetic presets for recorded data is a one-line change.
        ``seed`` only drives the (synthetic) scenario-ensemble
        perturbations around the recorded forecast.
        """
        import csv

        by_zone: Dict[str, List] = {}
        with open(path, newline="") as fh:
            reader = csv.DictReader(fh)
            cols = {c.lower().strip(): c for c in reader.fieldnames or ()}

            def pick(cands, what):
                for cand in cands:
                    if cand in cols:
                        return cols[cand]
                raise ValueError(
                    f"{path!r}: no {what} column "
                    f"(headers: {sorted(cols)})")

            t_col = pick(("timestamp", "datetime", "date", "time"),
                         "timestamp")
            z_col = pick(("zone", "zone_key", "zone_id", "zone_name",
                          "region"), "zone")
            ci_col = pick(("carbon_intensity", "carbon_intensity_avg",
                           "carbonintensity", "co2_intensity",
                           "gco2eq_per_kwh", "gco2_per_kwh", "ci"),
                          "carbon-intensity")
            for row in reader:
                ci = row.get(ci_col)
                if ci is None or ci.strip() == "":
                    continue
                by_zone.setdefault(row[z_col].strip(), []).append(
                    (_parse_timestamp(row[t_col]), float(ci)))
        if not by_zone:
            raise ValueError(f"{path!r}: no carbon-intensity rows")

        if aliases:
            renamed: Dict[str, List] = {}
            sources: Dict[str, str] = {}
            for zone, rows in by_zone.items():
                region = aliases.get(zone, zone)
                if region in renamed:
                    raise ValueError(
                        f"{path!r}: zones {sources[region]!r} and "
                        f"{zone!r} both alias to region {region!r} — "
                        "aliases must be one-to-one, not a merge")
                renamed[region] = rows
                sources[region] = zone
            by_zone = renamed

        for zone, rows in by_zone.items():
            try:
                rows.sort(key=lambda r: r[0])
            except TypeError:
                kinds = sorted({type(ts).__name__ for ts, _ in rows})
                raise ValueError(
                    f"{path!r}: zone {zone!r} mixes timestamp formats "
                    f"({', '.join(kinds)}) — use consistent ISO-8601 or "
                    "epoch timestamps") from None
            if fill_gaps:
                by_zone[zone] = _fill_gaps(path, zone, rows)
        # align zones on a common start: ragged exports (zones beginning
        # at different hours) must not be index-aligned, or tick t would
        # compare different wall-clock hours across regions — exactly the
        # cross-region CI comparison the planner exists for
        try:
            start = max(rows[0][0] for rows in by_zone.values())
        except TypeError:
            kinds = sorted({type(rows[0][0]).__name__
                            for rows in by_zone.values()})
            raise ValueError(
                f"{path!r}: zones mix timestamp formats "
                f"({', '.join(kinds)}) — use one format for the whole "
                "file") from None
        series = {}
        for zone, rows in by_zone.items():
            aligned = [v for ts, v in rows if ts >= start]
            if not aligned:
                raise ValueError(
                    f"{path!r}: zone {zone!r} has no rows at or after "
                    f"the common start {start!r}")
            series[zone] = np.array(aligned, dtype=float)
        hours = min(len(s) for s in series.values())
        trace = cls(regions={}, hours=hours, seed=seed)
        for zone, s in series.items():
            trace._series[zone] = s[:hours]
        return trace

    # -- EnergyMixGatherer-compatible signals -------------------------------

    def history_signal(self, t: int) -> CarbonSignal:
        """Grid Carbon Intensity service as of tick ``t`` (newest last)."""
        return lambda region: self._series[region][: t + 1].tolist()

    def forecast_signal(self, t: int, horizon: int = 24) -> CarbonSignal:
        """Level-corrected persistence forecast (hour 0 = now), pluggable
        as ``EnergyMixGatherer.forecast``: replay the last daily cycle,
        blended toward the CURRENT level with geometrically decaying
        weight so ramps that started today are visible at short lead
        times (plain persistence would be blind to them until tomorrow).
        """

        def fc(region: str) -> List[float]:
            s = self._series[region]
            level = float(s[min(t, len(s) - 1)])
            out = []
            for h in range(horizon):
                src = t + h - 24
                cyc = float(s[max(src, 0)]) if src < t else level
                w = 0.7 ** h
                out.append(w * level + (1.0 - w) * cyc)
            return out

        return fc

    # -- scenario ensembles for the batched what-if planner -----------------

    def scenario_matrix(
        self,
        node_regions: Sequence[str],
        t: int,
        horizon: int = 24,
        B: int = 8,
    ) -> np.ndarray:
        """``[B, N]`` plausible mean CI per node over the next ``horizon``.

        Branch 0 is the pure persistence forecast; the other branches
        perturb it with region-correlated multiplicative noise and phase
        jitter, modelling forecast uncertainty.  Deterministic given
        ``(seed, t)`` so adaptive-loop runs are reproducible.
        """
        fc = self.forecast_signal(t, horizon)
        # one forecast per REGION, broadcast to nodes (many nodes share a
        # region; this sits on the per-tick replanning hot path)
        per_region = {r: float(np.mean(fc(r))) for r in set(node_regions)}
        base = np.array([per_region[r] for r in node_regions])
        return self.perturb_scenarios(base, t, B)

    def perturb_scenarios(
        self,
        base: np.ndarray,
        t: int,
        B: int = 8,
        sigma=0.10,
    ) -> np.ndarray:
        """``[B, N]`` ensemble around an arbitrary ``[N]`` base forecast:
        branch 0 is the base itself, branches 1.. apply multiplicative
        lognormal noise with the given ``sigma`` — a scalar, or a per-node
        array (degraded-mode planning widens the sigma of nodes whose
        carbon feed has gone stale).  Same ``(seed, 7919, t)`` substream
        as :meth:`scenario_matrix`, which delegates here."""
        base = np.asarray(base, dtype=float)
        rng = np.random.default_rng((self.seed, 7919, t))
        out = np.empty((B, len(base)))
        out[0] = base
        for b in range(1, B):
            scale = rng.lognormal(mean=0.0, sigma=sigma, size=len(base))
            out[b] = np.maximum(base * scale, _CI_FLOOR)
        return out

    def future_matrix(
        self, node_regions: Sequence[str], t: int, horizon: int = 24
    ) -> np.ndarray:
        """``[1, N]`` TRUE mean CI over the next horizon (oracle branch)."""
        per_region = {}
        for region in set(node_regions):
            s = self._series[region][t: t + horizon]
            per_region[region] = float(np.mean(s)) if len(s) else _CI_FLOOR
        return np.array([per_region[r] for r in node_regions])[None, :]

    def now(self, node_regions: Sequence[str], t: int) -> np.ndarray:
        """``[N]`` instantaneous CI at tick ``t`` (for emissions accounting)."""
        per_region = {r: self._series[r][t] for r in set(node_regions)}
        return np.array([per_region[r] for r in node_regions])


@dataclass
class WorkloadTrace:
    """Per-tick monitoring data with diurnal utilisation + drift + noise.

    Computation energy of (service, flavour) at tick t:
      ``base * (1 + swing*sin(2*pi*(t - peak)/24)) * (1 + drift*t) * noise``
    where ``base`` comes from the flavour's ``energy_kwh`` (if enriched) or
    scales with its CPU requirement.  Traffic request volumes follow the
    same cycle.
    """

    app: Application
    seed: int = 0
    peak_hour: float = 14.0
    swing: float = 0.3
    drift_per_h: float = 0.0005
    noise: float = 0.02
    samples_per_window: int = 4
    base_kwh_per_cpu: float = 0.05
    gb_per_link_h: float = 40.0

    def utilisation(self, t: int, rng: np.random.Generator) -> float:
        cyc = 1.0 + self.swing * np.sin(
            2.0 * np.pi * (t - self.peak_hour) / 24.0)
        u = cyc * (1.0 + self.drift_per_h * t) \
            * (1.0 + rng.normal(0.0, self.noise))
        return float(max(u, 0.05))

    def monitoring(self, t: int) -> MonitoringData:
        rng = np.random.default_rng((self.seed, t))
        energy: List[EnergySample] = []
        traffic: List[TrafficSample] = []
        for svc in self.app.services:
            for fl in svc.flavours:
                base = fl.energy_kwh if fl.energy_kwh is not None \
                    else fl.requirements.cpu * self.base_kwh_per_cpu
                for _ in range(self.samples_per_window):
                    u = self.utilisation(t, rng)
                    energy.append(EnergySample(
                        svc.component_id, fl.name, base * u, t=t))
        for link in self.app.links:
            src = self.app.service(link.source)
            fname = src.flavours_order[0] if src.flavours_order else ""
            for _ in range(self.samples_per_window):
                u = self.utilisation(t, rng)
                traffic.append(TrafficSample(
                    source=link.source, source_flavour=fname,
                    target=link.target,
                    request_volume=self.gb_per_link_h * u,
                    request_size_gb=1.0, t=t))
        return MonitoringData(energy=tuple(energy), traffic=tuple(traffic))
