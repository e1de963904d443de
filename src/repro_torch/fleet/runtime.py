"""FleetRuntime: the adaptive continuum loop at multi-tenant scale.

One :class:`~repro_torch.continuum.loop.ContinuumRuntime` drives one
application.  The fleet runtime drives A of them over the SAME
infrastructure and carbon trace: each tick it runs every app's
constraint pipeline (profiles, KB, constraints — per-app state), bundles
the resulting problems into a :class:`FleetProblem`, replans the whole
fleet in one ``plan_many`` call (waterfill coupling by default, so
tenants can't jointly over-commit a node), and then applies the
EXISTING per-app hysteresis gate — switch only when the expected saving
beats migration+restart cost plus the hysteresis margin — before
accounting each app's ACTIVE assignment under the tick's true carbon
intensities.

Multi-tenant billing rides on the shared observability ledger: every
app's tick entry is recorded with its tenant tag (``app=name``), so
``repro_torch.obs.billing_report`` decomposes the fleet's total gCO2 into
per-tenant comp/comm/migration bills whose addends are bit-equal to the
per-tick accounted emissions.

Planning runs on ``device``: the CUDA card unless the caller names
another (``device="cpu"``); every tenant's pipeline runs there too.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..continuum.loop import (
    ContinuumResult,
    ContinuumRuntime,
    RuntimeConfig,
    TickRecord,
)
from ..continuum.traces import CarbonTrace, WorkloadTrace
from ..continuum.whatif import (
    WhatIfPlanner,
    assignment_arrays,
    plan_assignment,
)
from ..core.lowering import lowered_emissions, mask_unavailable
from ..core.pipeline import GreenConstraintPipeline
from ..faults import PlacementViolation, check_placement
from ..core.problem import BucketSpec
from ..core.scheduler import (
    COMPILE_CACHE,
    GreenScheduler,
    SchedulerConfig,
)
from ..core.types import Application, Infrastructure
from ..obs import Observability

from .planner import plan_many
from .problem import (
    CapacityReport,
    FleetProblem,
    FleetStats,
    accumulate_loads,
    empty_capacity_report,
)

__all__ = ["FleetApp", "FleetRuntime", "FleetRunResult", "FleetTickRecord"]


@dataclass
class FleetApp:
    """One tenant: an application with its own workload trace and
    waterfilling priority (higher plans first)."""

    name: str
    app: Application
    workload: WorkloadTrace
    priority: float = 0.0


@dataclass
class FleetTickRecord:
    """One fleet tick: every tenant's :class:`TickRecord` plus the
    shared-capacity accounting of the ACTIVE (post-hysteresis)
    assignments and of the tick's candidate plans."""

    t: int
    records: Dict[str, TickRecord]
    capacity: CapacityReport          # active assignments
    planned_capacity: CapacityReport  # this tick's plan_many candidates
    plan_stats: FleetStats
    compiles: int = 0                 # first-seen planner signatures

    @property
    def emissions_g(self) -> float:
        return sum(r.emissions_g for r in self.records.values())

    @property
    def migration_g(self) -> float:
        return sum(r.migration_g for r in self.records.values())

    @property
    def violations(self) -> int:
        return self.capacity.violations


@dataclass
class FleetRunResult:
    """``FleetRuntime.run`` output: fleet-level tick records plus one
    per-tenant :class:`ContinuumResult` (same schema as a single-app
    run, so every existing reporting/serialization path applies
    per tenant)."""

    ticks: List[FleetTickRecord]
    results: Dict[str, ContinuumResult]

    @property
    def total_emissions_g(self) -> float:
        return sum(r.total_emissions_g for r in self.results.values())

    def summary(self) -> Dict[str, float]:
        return {
            "ticks": len(self.ticks),
            "apps": len(self.results),
            "total_emissions_g": self.total_emissions_g,
            "migration_emissions_g": sum(
                fr.migration_g for fr in self.ticks),
            "violations": sum(fr.violations for fr in self.ticks),
            "switches": sum(
                r.switched for fr in self.ticks
                for r in fr.records.values()),
        }


def _default_scheduler(config: RuntimeConfig,
                       device: Optional[str]) -> GreenScheduler:
    bucket = config.bucket if config.bucket is not None else BucketSpec()
    return GreenScheduler(SchedulerConfig(
        emission_weight=1.0, bucket=bucket), device=device)


@dataclass
class FleetRuntime:
    """Drive A tenants' adaptive loops with one fleet replan per tick."""

    apps: List[FleetApp]
    infra: Infrastructure
    carbon: CarbonTrace
    config: RuntimeConfig = field(default_factory=RuntimeConfig)
    coupling: str = "waterfill"
    scheduler: Optional[GreenScheduler] = None
    obs: Optional[Observability] = field(default=None, repr=False)
    # Green watchtower: per-tenant SLOs (slo.tenant == the FleetApp
    # name) are priced off each tenant's accounted per-tick totals —
    # the same values the shared ledger bills, so SLO budget spend is
    # bit-equal to billing_report's per-tenant sums.
    watch: Optional[object] = field(default=None, repr=False)
    max_batch: int = 256
    # where the default scheduler and every tenant's pipeline run: the
    # card by default, the CPU only with device="cpu"
    device: Optional[str] = None

    def __post_init__(self) -> None:
        names = [fa.name for fa in self.apps]
        if len(set(names)) != len(names):
            raise ValueError(f"fleet app names must be unique: {names!r}")
        if self.scheduler is None:
            self.scheduler = _default_scheduler(self.config, self.device)
        self._node_regions = [
            n.region or n.node_id for n in self.infra.nodes]
        # One ContinuumRuntime per tenant as the per-app state holder:
        # its pipeline owns the profiles/KB/lowering caches, its
        # ``current`` the incumbent assignment, and its hysteresis_gate
        # the switch rule — the fleet runtime only replaces the REPLAN
        # step with the batched plan_many call.  With a fault schedule
        # each per-app runtime also carries the degraded carbon/workload
        # views, which the fleet tick reads through.
        self._runtimes: Dict[str, ContinuumRuntime] = {
            fa.name: ContinuumRuntime(
                app=fa.app, infra=self.infra, carbon=self.carbon,
                workload=fa.workload, config=self.config,
                pipeline=GreenConstraintPipeline(device=self.device),
                planner=WhatIfPlanner(GreenScheduler(
                    SchedulerConfig(emission_weight=1.0),
                    device=self.device)))
            for fa in self.apps}
        # post-plan invariant violations across all tenants (the
        # capacity check runs on the SUMMED multi-tenant loads)
        self.placement_violations: List[PlacementViolation] = []

    def runtime(self, name: str) -> ContinuumRuntime:
        return self._runtimes[name]

    def tick(self, t: int) -> FleetTickRecord:
        cfg = self.config
        obs = self.obs if (self.obs is not None and self.obs.enabled) \
            else None
        misses0 = COMPILE_CACHE.misses

        # 1+2. per-tenant ingestion + constraint pipeline -> one problem
        # per app, warm-started from its incumbent.  With a fault
        # schedule the ingestion goes through each runtime's degraded
        # views, dead/derated nodes are masked out of every tenant's
        # lowering, and stranded services are evicted (re-placement is
        # an emergency that bypasses the per-app hysteresis gate).
        faults = cfg.faults
        alive = faults.alive_at(t) if faults is not None else None
        derate = faults.derate_at(t) if faults is not None else None
        problems = []
        outs = []
        evicted: Dict[str, int] = {}
        emergency: Dict[str, bool] = {}
        for fa in self.apps:
            rt = self._runtimes[fa.name]
            rt.pipeline.gatherer.signal = \
                rt._carbon_view.history_signal(t)
            rt.pipeline.gatherer.forecast = rt._carbon_view.forecast_signal(
                t, cfg.horizon_h)
            mon = rt._workload_view.monitoring(t)
            out = rt.pipeline.run(fa.app, self.infra, mon,
                                  use_kb=cfg.use_kb)
            if faults is not None \
                    and rt._workload_view.stale(t, cfg.telemetry_window):
                out = rt._held_output(out, t)
            problem = rt.pipeline.problem_for(out)
            evicted[fa.name] = 0
            emergency[fa.name] = False
            if faults is not None:
                low = problem.lowering
                if not alive.all() or derate is not None:
                    low = mask_unavailable(low, alive, derate=derate)
                    problem = problem.with_lowering(low)
                if rt.current:
                    nidx = low.node_index()
                    stranded = [
                        sid for sid, (_fl, nid) in rt.current.items()
                        if not alive[nidx[nid]]]
                    for sid in stranded:
                        del rt.current[sid]
                    if stranded:
                        evicted[fa.name] = len(stranded)
                        emergency[fa.name] = cfg.emergency_replan
                if (cfg.emergency_replan and not emergency[fa.name]
                        and derate is not None and rt.current):
                    pl, fc, nc = assignment_arrays(low, rt.current)
                    if check_placement(low, pl, fc, nc, alive=alive, t=t):
                        emergency[fa.name] = True
            if cfg.warm_start and rt.current is not None:
                problem = problem.with_warm_start(rt.current)
            problems.append(problem)
            outs.append(out)

        # 3. one batched fleet replan (coupled capacity per ``coupling``)
        t_plan0 = time.perf_counter()
        fleet = FleetProblem(
            apps=tuple(problems),
            names=tuple(fa.name for fa in self.apps),
            priority=tuple(fa.priority for fa in self.apps),
            coupling=self.coupling)
        fresult = plan_many(fleet, self.scheduler,
                            max_batch=self.max_batch)
        replan_s = time.perf_counter() - t_plan0
        ci_now = self.carbon.now(self._node_regions, t)

        # 4+5. per-tenant hysteresis gate + accounting under the true CI.
        # An emergency anywhere forces the WHOLE fleet's coupled plan:
        # plan_many's candidates are only jointly capacity-feasible as a
        # set, so letting one tenant's flap damping hold its incumbent
        # while another evacuates onto the coupled plan could overcommit
        # a node.  Atomic adoption keeps the invariant; every forced
        # move is still billed in full.
        fleet_force = any(emergency.values())
        if fleet_force:
            for fa in self.apps:
                emergency[fa.name] = True
        records: Dict[str, TickRecord] = {}
        cpu_load = np.zeros(len(self._node_regions))
        ram_load = np.zeros(len(self._node_regions))
        viols_before = len(self.placement_violations)
        for i, fa in enumerate(self.apps):
            rt = self._runtimes[fa.name]
            low = problems[i].lowering
            pres = fresult.results[i]
            plan = pres.plans[0]
            warm_rejected = any(
                "warm start rejected" in n for n in plan.notes)
            switched = False
            migrations = restarts = 0
            charged_moved = charged_flapped = 0
            migration_g = 0.0
            expected_saving = 0.0
            mig_cells: Tuple = ()
            if plan.feasible:
                cand = plan_assignment(plan)
                saving = 0.0
                if rt.current is not None and cand != rt.current:
                    # expected saving under the tick's MONITORED signal
                    # (low.ci): candidate emissions are exactly the
                    # planner's per-app value, the incumbent re-priced
                    # on the same lowering
                    cur_g = lowered_emissions(
                        low, *assignment_arrays(low, rt.current))
                    saving = (cur_g - float(pres.emissions_g[0])) \
                        * cfg.horizon_h
                    expected_saving = saving
                initial = rt.current is None
                (switched, migrations, restarts, migration_g,
                 mig_cells) = rt.hysteresis_gate(
                    cand, saving, want_cells=obs is not None,
                    force=emergency[fa.name])
                if switched and not initial:
                    charged_moved = migrations
                    charged_flapped = restarts
            emissions = 0.0
            placed = fcur = ncur = None
            viols: List[PlacementViolation] = []
            if rt.current:
                placed, fcur, ncur = assignment_arrays(low, rt.current)
                emissions = lowered_emissions(
                    low, placed, fcur, ncur, ci=ci_now)
                accumulate_loads(low, placed, fcur, ncur,
                                 cpu_load, ram_load)
                if cfg.validate_placements:
                    # liveness per tenant here; capacity runs once on
                    # the SUMMED loads after every tenant is accounted
                    viols = check_placement(
                        low, placed, fcur, ncur,
                        alive=alive if faults is not None else None,
                        t=t, cpu_load=np.zeros(low.N),
                        ram_load=np.zeros(low.N))
                    self.placement_violations.extend(viols)
            records[fa.name] = TickRecord(
                t=t, emissions_g=emissions, migration_g=migration_g,
                migrations=migrations, replanned=True, switched=switched,
                expected_saving_g=expected_saving,
                n_constraints=len(outs[i].constraints),
                warm_start_rejected=warm_rejected, restarts=restarts,
                replan_s=replan_s, evicted=evicted[fa.name],
                emergency=emergency[fa.name], violations=len(viols))
            if obs is not None:
                obs.ledger.record(
                    t, low, placed, fcur, ncur, ci_now,
                    zones=self._node_regions,
                    moved=charged_moved, flapped=charged_flapped,
                    migration_fee_g=cfg.migration_g,
                    restart_fee_g=cfg.restart_g,
                    mig_cells=mig_cells, app=fa.name)

        if problems:
            ref = problems[0].lowering
            if cfg.validate_placements:
                # shared-capacity invariant on the SUMMED tenant loads,
                # against the (possibly derated) capacity tensors
                zs = np.zeros(ref.S, np.int64)
                self.placement_violations.extend(check_placement(
                    ref, np.zeros(ref.S, bool), zs, zs, t=t,
                    cpu_load=cpu_load, ram_load=ram_load))
            capacity = CapacityReport(
                node_ids=tuple(n.node_id for n in self.infra.nodes),
                cpu_load=cpu_load, ram_load=ram_load,
                cpu_cap=np.asarray(ref.cpu_cap, dtype=float),
                ram_cap=np.asarray(ref.ram_cap, dtype=float))
        else:
            capacity = empty_capacity_report()
        if obs is not None and faults is not None and self.apps:
            # one fault-event record per tick for the whole fleet
            self._runtimes[self.apps[0].name]._record_fault_events(
                obs, t, sum(evicted.values()), any(emergency.values()),
                self.placement_violations[viols_before:])
        if self.watch is not None and self.apps:
            self.watch.observe_fleet_tick(
                t, records, ci_now,
                registry=obs.registry if obs is not None else None)
        return FleetTickRecord(
            t=t, records=records, capacity=capacity,
            planned_capacity=fresult.capacity,
            plan_stats=fresult.stats,
            compiles=COMPILE_CACHE.misses - misses0)

    def run(self, start: int, ticks: int) -> FleetRunResult:
        saved = {
            name: (rt.pipeline.gatherer.signal,
                   rt.pipeline.gatherer.forecast)
            for name, rt in self._runtimes.items()}
        try:
            frecs = [self.tick(t) for t in range(start, start + ticks)]
        finally:
            # don't leak the trace's closures into later uses of the
            # per-app pipelines (mirrors ContinuumRuntime.run)
            for name, rt in self._runtimes.items():
                (rt.pipeline.gatherer.signal,
                 rt.pipeline.gatherer.forecast) = saved[name]
        results = {
            fa.name: ContinuumResult(
                ticks=[fr.records[fa.name] for fr in frecs],
                final_assignment=dict(
                    self._runtimes[fa.name].current or {}))
            for fa in self.apps}
        return FleetRunResult(ticks=frecs, results=results)
