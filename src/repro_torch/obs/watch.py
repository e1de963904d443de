"""Green watchtower: streaming detectors + SLO evaluation + arming.

The obs layer (registry / spans / ledger / exporters) records what
happened; this module *watches* it happen.  A :class:`Watchtower`
attached to a :class:`repro_torch.continuum.ContinuumRuntime` (or
``FleetRuntime``) consumes each committed tick and runs:

* **EWMA z-score detectors** on the truth carbon-intensity vector
  ``ci[N]`` and on per-service selected energy ``placed * E[s, f]``
  — sudden grid spikes and energy-profile drift;
* a **CUSUM detector** on the per-tick emissions total (standardized
  by its own EWMA mean/var) — slow ledger drift single-tick z-scores
  miss;
* **liveness / freshness edges** — a node leaving the fault alive-mask,
  a carbon zone going dark, telemetry turning stale (absence of data is
  itself an observable);
* the **SLO engine** (:mod:`repro_torch.obs.slo`) — carbon budgets,
  intensity ceilings, churn limits with multi-window burn-rate alerts.

All alerts are :class:`repro_torch.obs.slo.AlertEvent` records appended to
``watch.alerts`` and mirrored as registry events when a registry is
attached.

**Two modes.**  In ``observe`` mode the watchtower is a pure read-only
tap: decisions are bit-identical with or without it, on both the eager
and the fused-scan path.  In ``arm`` mode, alerts named in
``arm_on`` flag their carbon zone for *evacuation* — the runtime then
masks the zone's nodes unavailable for ``evacuate_hold_h`` ticks
starting next tick, which evicts stranded services and triggers the
same emergency-replan machinery a ``FaultTrace`` outage does.  Armed
feedback needs the eager tick loop, so ``run_scanned`` falls back with
``FallbackReason.WATCH_ARMED`` when armed.

**Riding the fused scan.**  On ``run_scanned``
(``repro_torch.continuum.megaloop``) the EWMA/CUSUM/budget recursions run
*inside* the device scan over the staged trace: the
detector state travels in the scan carry as one nested tuple (lane
order fixed by :meth:`Watchtower.scan_carry`) and each tick stacks one
row of pre-threshold statistics (:meth:`scan row <Watchtower.commit_scan>`
order: ``(z_ci[N], z_e[S], u, cpos_pre, cneg_pre, n_before,
budget)``).  Thresholding, liveness/freshness replay, and SLO
evaluation happen post-scan in :meth:`Watchtower.commit_scan` using the
SAME host code the eager path uses — so the alert stream matches the
eager run tick for tick while decisions stay bit-identical to a
detached scan.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .slo import SLO, AlertEvent, SLOEngine
from .tsdb import TimeSeriesStore

__all__ = ["WatchConfig", "DetectorState", "Watchtower"]


@dataclass(frozen=True)
class WatchConfig:
    """Detector thresholds + arming policy."""

    ewma_alpha: float = 0.2       # EWMA smoothing for means/variances
    eps: float = 1e-9             # variance floor inside the z denominator
    z_ci: float = 8.0             # |z| threshold, carbon-intensity stream
    z_energy: float = 2.5         # |z| threshold, per-service energy stream
    warmup: int = 12              # ticks of state before z/CUSUM alerts arm
    cusum_k: float = 0.5          # CUSUM slack (in sigma units)
    cusum_h: float = 25.0         # CUSUM decision threshold
    mode: str = "observe"         # "observe" (read-only) | "arm" (feedback)
    arm_on: Tuple[str, ...] = ("ci_anomaly",)
    evacuate_hold_h: int = 4      # ticks a flagged zone stays evacuated
    history: int = 512            # tsdb ring capacity

    def __post_init__(self):
        if self.mode not in ("observe", "arm"):
            raise ValueError("mode must be 'observe' or 'arm'")
        if not (0.0 < self.ewma_alpha < 1.0):
            raise ValueError("ewma_alpha must be in (0, 1)")


def _ewma_update(mean, var, x, alpha, eps):
    """One EWMA mean/variance step; returns (z, mean', var').

    Op order is the contract: the in-scan lanes in
    ``continuum.megaloop`` compute the same expressions in the same
    order so eager and post-scan statistics agree.
    """
    d = x - mean
    z = d / np.sqrt(var + eps)
    mean2 = mean + alpha * d
    var2 = (1.0 - alpha) * (var + alpha * d * d)
    return z, mean2, var2


class DetectorState:
    """Numpy mirror of the in-scan detector carry (see lane order in
    :meth:`Watchtower.scan_carry`)."""

    __slots__ = ("N", "S", "ci_mean", "ci_var", "e_mean", "e_var",
                 "g_mean", "g_var", "cpos", "cneg", "n", "budget")

    def __init__(self, N: int, S: int):
        self.N, self.S = int(N), int(S)
        self.ci_mean = np.zeros(N, dtype=np.float64)
        self.ci_var = np.zeros(N, dtype=np.float64)
        self.e_mean = np.zeros(S, dtype=np.float64)
        self.e_var = np.zeros(S, dtype=np.float64)
        self.g_mean = 0.0
        self.g_var = 0.0
        self.cpos = 0.0
        self.cneg = 0.0
        self.n = 0
        self.budget = 0.0

    def carry(self) -> Tuple:
        """State as the scan-carry lane tuple (all float64)."""
        return (self.ci_mean.copy(), self.ci_var.copy(),
                self.e_mean.copy(), self.e_var.copy(),
                np.float64(self.g_mean), np.float64(self.g_var),
                np.float64(self.cpos), np.float64(self.cneg),
                np.float64(self.n), np.float64(self.budget))

    def load(self, carry: Sequence) -> None:
        """Adopt a final scan carry back into host state."""
        (ci_m, ci_v, e_m, e_v, g_m, g_v, cpos, cneg, n, budget) = carry
        self.ci_mean = np.asarray(ci_m, dtype=np.float64).copy()
        self.ci_var = np.asarray(ci_v, dtype=np.float64).copy()
        self.e_mean = np.asarray(e_m, dtype=np.float64).copy()
        self.e_var = np.asarray(e_v, dtype=np.float64).copy()
        self.g_mean = float(g_m)
        self.g_var = float(g_v)
        self.cpos = float(cpos)
        self.cneg = float(cneg)
        self.n = int(round(float(n)))
        self.budget = float(budget)


class Watchtower:
    """Per-run watcher; attach via ``ContinuumRuntime(watch=...)``."""

    def __init__(self, config: Optional[WatchConfig] = None,
                 slos: Sequence[SLO] = (),
                 store: Optional[TimeSeriesStore] = None):
        self.config = config or WatchConfig()
        self.slo = SLOEngine(slos)
        self.store = store or TimeSeriesStore(capacity=self.config.history)
        self.alerts: List[AlertEvent] = []
        self._state: Optional[DetectorState] = None
        self._prev_alive: Optional[np.ndarray] = None
        self._dark_prev: set = set()
        self._stale_prev: bool = False
        self._rings = None            # _feed_store ring cache
        self._slo_rings: List = []
        # zone -> (from_tick, until_tick) evacuation windows (armed mode)
        self._evac: Dict[str, Tuple[int, int]] = {}

    # -- mode / state ------------------------------------------------------

    @property
    def armed(self) -> bool:
        return self.config.mode == "arm"

    @property
    def budget_spent_g(self) -> float:
        """Run-level gCO2 consumed so far (emissions + migration fees)."""
        return self._state.budget if self._state is not None else 0.0

    def _ensure_state(self, N: int, S: int) -> DetectorState:
        st = self._state
        if st is None or st.N != N or st.S != S:
            st = self._state = DetectorState(N, S)
        return st

    # -- arming ------------------------------------------------------------

    def evacuated_zones(self, t: int) -> set:
        return {z for z, (a, b) in self._evac.items() if a <= t < b}

    def evacuation_mask(self, t: int, node_zones) -> Optional[np.ndarray]:
        """Per-node keep-mask (True = available) for tick ``t``; ``None``
        when no zone is under evacuation."""
        ez = self.evacuated_zones(t)
        if not ez:
            return None
        return np.array([z not in ez for z in node_zones], dtype=bool)

    # -- shared threshold / replay code (eager AND post-scan) --------------

    def _flag(self, t, n_before, z_ci, z_e, cpos_pre, cneg_pre,
              node_ids, node_zones, service_ids) -> List[AlertEvent]:
        cfg = self.config
        if int(n_before) < cfg.warmup:
            return []
        alerts: List[AlertEvent] = []
        for i in np.nonzero(np.abs(z_ci) >= cfg.z_ci)[0]:
            alerts.append(AlertEvent(
                t=t, name="ci_anomaly", source="ewma", severity="page",
                target=str(node_ids[i]),
                zone=str(node_zones[i]) if node_zones is not None else "",
                value=float(z_ci[i]), threshold=cfg.z_ci,
                detail="carbon-intensity EWMA z-score"))
        for s in np.nonzero(np.abs(z_e) >= cfg.z_energy)[0]:
            alerts.append(AlertEvent(
                t=t, name="energy_anomaly", source="ewma",
                target=str(service_ids[s]),
                value=float(z_e[s]), threshold=cfg.z_energy,
                detail="per-service energy EWMA z-score"))
        peak = max(float(cpos_pre), float(cneg_pre))
        if peak > cfg.cusum_h:
            alerts.append(AlertEvent(
                t=t, name="emissions_drift", source="cusum",
                value=peak, threshold=cfg.cusum_h,
                detail="CUSUM on per-tick emissions total"))
        return alerts

    def _liveness(self, t, alive, node_ids, node_zones) -> List[AlertEvent]:
        if alive is None:
            return []
        alive = np.asarray(alive, dtype=bool)
        prev = self._prev_alive
        if prev is None or prev.shape != alive.shape:
            prev = np.ones_like(alive)
        down = prev & ~alive
        self._prev_alive = alive
        return [AlertEvent(
            t=t, name="node_down", source="liveness", severity="page",
            target=str(node_ids[i]),
            zone=str(node_zones[i]) if node_zones is not None else "",
            value=1.0, threshold=1.0,
            detail="node left the alive mask")
            for i in np.nonzero(down)[0]]

    def _freshness(self, t, dark_zones, telemetry_stale) -> List[AlertEvent]:
        alerts: List[AlertEvent] = []
        dz = set(dark_zones)
        for z in sorted(dz - self._dark_prev):
            alerts.append(AlertEvent(
                t=t, name="feed_stale", source="freshness", target=z,
                zone=z, value=1.0, threshold=1.0,
                detail="carbon feed dark for zone"))
        self._dark_prev = dz
        stale = bool(telemetry_stale)
        if stale and not self._stale_prev:
            alerts.append(AlertEvent(
                t=t, name="telemetry_stale", source="freshness",
                value=1.0, threshold=1.0,
                detail="monitoring window contaminated; lowering holds "
                       "last clean profiles"))
        self._stale_prev = stale
        return alerts

    def _apply(self, t, alerts: List[AlertEvent], registry) -> None:
        self.alerts.extend(alerts)
        for a in alerts:
            if registry is not None:
                registry.event("alert." + a.name, **a.as_attrs())
                registry.inc("watch.alerts", labels={"name": a.name})
            if self.armed and a.name in self.config.arm_on and a.zone:
                cur = self._evac.get(a.zone)
                from_t = t + 1 if cur is None else min(cur[0], t + 1)
                until = max(t + 1 + self.config.evacuate_hold_h,
                            cur[1] if cur else 0)
                self._evac[a.zone] = (from_t, until)
                if registry is not None:
                    registry.event("watch.evacuate_zone", tick=t,
                                   zone=a.zone, from_tick=from_t,
                                   until_tick=until, alert=a.name)

    def _feed_store(self, t, rec, ci, ci_mean, budget) -> None:
        # Ring objects are resolved once and appended to directly — the
        # store feed runs every tick inside the eager loop, so the
        # per-record key construction would dominate the watch cost.
        rings = self._rings
        if rings is None:
            s = self.store
            rings = self._rings = [
                s.series("tick.emissions_g"), s.series("tick.migration_g"),
                s.series("tick.migrations"), s.series("ci.mean"),
                s.series("ci.now"), s.series("watch.budget_g")]
            self._slo_rings = [
                (slo.name, s.series("slo.burn_fast", labels={"slo": slo.name}),
                 s.series("slo.burn_slow", labels={"slo": slo.name}))
                for slo in self.slo.slos]
        em, mg, mi, cm, cn, bu = rings
        em.append(t, rec.emissions_g)
        mg.append(t, rec.migration_g)
        mi.append(t, float(rec.migrations))
        cm.append(t, ci_mean)
        cn.append(t, ci)
        bu.append(t, budget)
        for name, fast_ring, slow_ring in self._slo_rings:
            fast, slow = self.slo.burn_rates(name)
            fast_ring.append(t, fast)
            slow_ring.append(t, slow)

    # -- eager path --------------------------------------------------------

    def observe_tick(self, t, rec, low, placed, fcur, ci_now, *,
                     alive=None, dark_zones=(), telemetry_stale=False,
                     node_zones=None, registry=None) -> List[AlertEvent]:
        """Ingest one committed eager tick; returns the alerts it fired.

        ``placed``/``fcur`` are the post-plan assignment arrays (``None``
        before adoption), ``ci_now`` the *truth* per-node intensity the
        accounting used, ``alive`` the raw fault alive-mask (pre any
        watch evacuation) — so detectors see the same streams on every
        path.
        """
        cfg = self.config
        ci = np.asarray(ci_now, dtype=np.float64)
        E = np.asarray(low.E, dtype=np.float64)
        S = E.shape[0]
        st = self._ensure_state(ci.shape[0], S)

        if placed is None:
            e_sel = np.zeros(S, dtype=np.float64)
        else:
            e_sel = np.asarray(placed) * E[np.arange(S), np.asarray(fcur)]

        n_before = st.n
        z_ci, st.ci_mean, st.ci_var = _ewma_update(
            st.ci_mean, st.ci_var, ci, cfg.ewma_alpha, cfg.eps)
        z_e, st.e_mean, st.e_var = _ewma_update(
            st.e_mean, st.e_var, e_sel, cfg.ewma_alpha, cfg.eps)
        g = rec.emissions_g
        d_g = g - st.g_mean
        u = d_g / np.sqrt(st.g_var + cfg.eps)
        st.g_mean = st.g_mean + cfg.ewma_alpha * d_g
        st.g_var = (1.0 - cfg.ewma_alpha) * (
            st.g_var + cfg.ewma_alpha * d_g * d_g)
        cpos_pre = max(0.0, st.cpos + u - cfg.cusum_k)
        cneg_pre = max(0.0, st.cneg - u - cfg.cusum_k)
        fired = cpos_pre > cfg.cusum_h or cneg_pre > cfg.cusum_h
        st.cpos = 0.0 if fired else cpos_pre
        st.cneg = 0.0 if fired else cneg_pre
        st.budget = st.budget + (rec.emissions_g + rec.migration_g)
        st.n = n_before + 1

        ci_mean = float(np.mean(ci))
        alerts = self._flag(t, n_before, z_ci, z_e, cpos_pre, cneg_pre,
                            low.node_ids, node_zones, low.service_ids)
        alerts += self._liveness(t, alive, low.node_ids, node_zones)
        alerts += self._freshness(t, dark_zones, telemetry_stale)
        alerts += self.slo.observe(
            t, consumption_g=rec.emissions_g + rec.migration_g,
            ci_mean=ci_mean, migrations=int(rec.migrations))
        self._apply(t, alerts, registry)
        self._feed_store(t, rec, ci, ci_mean, st.budget)
        if registry is not None:
            self.store.capture_registry(t, registry)
        return alerts

    # -- fleet path --------------------------------------------------------

    def observe_fleet_tick(self, t, records, ci_now,
                           registry=None) -> List[AlertEvent]:
        """Feed per-tenant + fleet-level SLOs from one fleet tick.

        Per-tenant budget ``spent`` accumulates each tenant's
        ``emissions_g + migration_g`` in tick order — the same ordered
        float reduction ``billing_report`` runs over that tenant's
        ledger entries, whose per-tick values are bit-equal to the
        records by the ledger parity contract, so SLO spend is
        bit-equal to the tenant's bill.
        """
        ci_mean = float(np.mean(np.asarray(ci_now, dtype=np.float64)))
        alerts: List[AlertEvent] = []
        total = 0.0
        migs = 0
        for name, rec in records.items():
            alerts.extend(self.slo.observe(
                t, consumption_g=rec.emissions_g + rec.migration_g,
                ci_mean=ci_mean, migrations=int(rec.migrations),
                tenant=name))
            total += rec.emissions_g + rec.migration_g
            migs += int(rec.migrations)
        alerts.extend(self.slo.observe(
            t, consumption_g=total, ci_mean=ci_mean, migrations=migs,
            tenant=""))
        self._apply(t, alerts, registry)
        self.store.record("fleet.consumption_g", t, total)
        return alerts

    # -- fused-scan interop ------------------------------------------------

    def scan_consts(self) -> Tuple:
        """Dynamic detector constants handed to the fused scan program."""
        cfg = self.config
        return (np.float64(cfg.ewma_alpha), np.float64(cfg.eps),
                np.float64(cfg.cusum_k), np.float64(cfg.cusum_h))

    def scan_carry(self, N: int, S: int) -> Tuple:
        """Initial detector carry lanes:
        ``(ci_mean[N], ci_var[N], e_mean[S], e_var[S], g_mean, g_var,
        cpos, cneg, n, budget)`` — all float64."""
        return self._ensure_state(N, S).carry()

    def commit_scan(self, runtime, st, records, wys, wcarry, start,
                    obs=None) -> List[AlertEvent]:
        """Materialize alerts from a completed fused scan.

        ``wys`` is the stacked per-tick row ``(z_ci[T,N], z_e[T,S],
        u[T], cpos_pre[T], cneg_pre[T], n_before[T], budget[T])`` and
        ``wcarry`` the final detector carry.  Thresholding, liveness /
        freshness edges and SLO evaluation replay through the SAME
        methods the eager path uses, in the same per-tick order.
        """
        z_ci, z_e, _u, cpos_pre, cneg_pre, n_before, _budget = (
            np.asarray(a) for a in wys)
        cfg = runtime.config
        faults = cfg.faults
        registry = obs.registry if obs is not None else None
        node_ids = st.lows[0].node_ids
        service_ids = st.lows[0].service_ids
        node_zones = runtime._node_regions
        state = self._ensure_state(len(node_ids), len(service_ids))
        # The budget is re-accumulated HERE, not read off the scan lane:
        # a compiler may contract the lane's mul-add chain differently from the
        # committed per-tick values, perturbing the last ulp — the host
        # ordered sum over bit-identical records is the billing contract.
        bud = state.budget
        fired: List[AlertEvent] = []
        for k, rec in enumerate(records):
            t = start + k
            alerts = self._flag(t, int(n_before[k]), z_ci[k], z_e[k],
                                float(cpos_pre[k]), float(cneg_pre[k]),
                                node_ids, node_zones, service_ids)
            alive_k = st.alive[k] if faults is not None else None
            alerts += self._liveness(t, alive_k, node_ids, node_zones)
            dark: Tuple[str, ...] = ()
            stale = False
            if faults is not None:
                dmask = faults.dark_at(t)
                dark = tuple(z for z, d in zip(faults.zones, dmask) if d)
                stale = bool(runtime._workload_view.stale(
                    t, cfg.telemetry_window))
            alerts += self._freshness(t, dark, stale)
            ci_mean = float(np.mean(st.ci_now[k]))
            alerts += self.slo.observe(
                t, consumption_g=rec.emissions_g + rec.migration_g,
                ci_mean=ci_mean, migrations=int(rec.migrations))
            self._apply(t, alerts, registry)
            bud = bud + (rec.emissions_g + rec.migration_g)
            self._feed_store(t, rec, st.ci_now[k], ci_mean, bud)
            fired.extend(alerts)
        state.load(wcarry)
        state.budget = bud
        if registry is not None:
            self.store.capture_registry(start + len(records) - 1, registry)
        return fired

    # -- reporting ---------------------------------------------------------

    def report(self) -> Dict[str, object]:
        by_name: Dict[str, int] = {}
        for a in self.alerts:
            by_name[a.name] = by_name.get(a.name, 0) + 1
        return {
            "alerts": len(self.alerts),
            "by_name": by_name,
            "budget_spent_g": self.budget_spent_g,
            "slos": {
                s.name: {"spent_g": (self.slo.spent(s.name)
                                     if s.kind == "carbon_budget" else None),
                         "burn": self.slo.burn_rates(s.name)}
                for s in self.slo.slos},
            "evacuations": dict(self._evac),
        }
