"""ContinuumRuntime: the discrete-time adaptive loop that closes Fig. 1.

Each tick (= one observation window, one hour):

  1. ingest monitoring data (WorkloadTrace) and the grid carbon signal
     (CarbonTrace) — the Energy Mix Gatherer's ``signal``/``forecast``
     hooks are re-pointed at the trace's state as of the tick;
  2. run the GreenConstraintPipeline: profiles are re-estimated, the KB is
     enriched (Eq. 10 memory weights decay for constraints that stop being
     regenerated), constraints are re-ranked, and the output is folded
     into ONE :class:`~repro_torch.core.problem.PlacementProblem` (the lowering
     cached across ticks by the pipeline);
  3. replan: a forecast ensemble is stacked onto the problem as a
     ``ScenarioBatch`` and priced in ONE float64 planner call over the
     branch axis (``WhatIfPlanner.evaluate``, on the scheduler's device:
     the card by default); the search is WARM-STARTED from the
     previous assignment (verified against the capacity/subnet masks,
     reject-and-rebuild on infeasible);
  4. switch only when it pays: expected savings over the horizon must
     exceed the switching cost — migration cost per relocated service
     PLUS an in-place-restart cost per flavour-only change (damping: a
     flavour flip restarts the service even when it stays on its node, so
     near-tied flavours must justify the restart instead of oscillating
     tick-to-tick) — plus a hysteresis threshold; otherwise the incumbent
     assignment is kept;
  5. account: actual emissions of the ACTIVE assignment under the tick's
     true carbon intensities, plus migration/restart emissions when
     switching.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Tuple

from repro_torch.core.lowering import (
    ScenarioBatch,
    lowered_emissions,
    mask_unavailable,
)
from repro_torch.core.pipeline import GreenConstraintPipeline
from repro_torch.core.problem import BucketSpec
from repro_torch.faults import (
    DegradedCarbon,
    DegradedWorkload,
    FaultTrace,
    PlacementViolation,
    check_placement,
)
from repro_torch.core.scheduler import (
    COMPILE_CACHE,
    GreenScheduler,
    SchedulerConfig,
)
from repro_torch.core.types import Application, Infrastructure
from repro_torch.obs import Observability, Watchtower

from .traces import CarbonTrace, WorkloadTrace
from .whatif import (
    WhatIfPlanner,
    assignment_arrays,
    ensemble_emissions,
    plan_assignment,
)


@dataclass
class RuntimeConfig:
    # Expectation window for what-if pricing.  Deliberately SHORT of a full
    # day: a 24h mean averages the diurnal cycle away and makes every
    # placement look time-invariant; a few hours preserves the temporal
    # carbon variation the loop is meant to exploit.
    horizon_h: int = 6
    scenarios: int = 8         # forecast branches per tick (B)
    replan_every: int = 1      # ticks between replans (1 = every tick)
    hysteresis_g: float = 10.0  # extra expected saving required to switch
    migration_g: float = 2.0   # gCO2eq charged per relocated service
    # gCO2eq charged per flavour-only change (in-place restart).  The
    # migration model treats flavour flips on an unchanged node as free
    # moves, so without this near-tied flavours oscillate tick-to-tick.
    restart_g: float = 0.5
    warm_start: bool = True
    use_whatif: bool = True    # batched ensemble vs single-forecast plan
    oracle: bool = False       # price the TRUE future window (upper bound)
    use_kb: bool = True
    # Per-tick delta fast path: rebuild the lowering by ci/E array
    # substitution when only profiles drifted (False = full re-lowering
    # every tick — the benchmark baseline).
    delta_replanning: bool = True
    # Shape buckets for the what-if planner: pad problem shapes to bucket
    # boundaries so drifting shapes (services appearing / leaving,
    # ensembles resizing) share one planner signature.  The eager torch
    # planner compiles nothing, so padding only costs here (it is kept for
    # parity with the JAX package's configuration).
    bucket: Optional[BucketSpec] = None
    # Auto-derive the bucket grid from observed shape traffic: after this
    # many replans, ``BucketSpec.from_observed`` picks waste-minimizing
    # boundaries from the shapes the loop actually saw and swaps them into
    # the planner (0 = off; ignored when ``bucket`` is set explicitly).
    auto_bucket_after: int = 0
    # Profile estimation window (ticks): 1 = instantaneous estimates from
    # this tick's monitoring alone; >1 pools the last W observation
    # windows through the TelemetryBuffer ring (smoother profiles, less
    # constraint churn).  Threaded through the pipeline per tick.
    telemetry_window: int = 1
    # -- fault tolerance ----------------------------------------------------
    # Seeded fault schedule (:class:`repro_torch.faults.FaultTrace`).  None
    # (the default) keeps every fault-handling branch off the hot path.  When
    # set, the runtime plans through degraded views (persistence carbon
    # for dark zones, NaN-held telemetry during dropouts), masks dead
    # nodes out of the lowering, and evicts stranded services.
    faults: Optional[FaultTrace] = None
    # Services stranded on a dead node trigger a same-tick replan that
    # bypasses the hysteresis margin — migration cost is still billed,
    # the gate just can't veto the evacuation.
    emergency_replan: bool = True
    # Post-plan invariant validator (``repro_torch.faults.validator``): every
    # committed assignment must place services on live nodes within
    # capacity; violations are recorded, counted and surfaced as obs
    # events (never silently dropped).
    validate_placements: bool = True
    # Scenario-sigma widening per stale hour for zones whose carbon feed
    # is dark: sigma = 0.10 * (1 + widen * staleness).
    fault_sigma_widen: float = 0.05


@dataclass
class TickRecord:
    t: int
    emissions_g: float          # active assignment under the tick's true CI
    migration_g: float          # migration + restart charge paid this tick
    migrations: int             # services relocated this tick
    replanned: bool
    switched: bool
    expected_saving_g: float    # forecast saving that justified the switch
    n_constraints: int
    warm_start_rejected: bool
    restarts: int = 0           # flavour-only (in-place) changes this tick
    # Replanning telemetry: wall time of the problem REBUILD alone
    # (``problem_for`` — what the delta fast path accelerates), of the
    # whole replan (rebuild + what-if pricing), how the lowering was
    # obtained ("cache_hit" | "delta" | "full"), and planner signatures
    # first seen during this tick's replan (``PlannerCompileCache``
    # misses: the torch planner compiles nothing).
    rebuild_s: float = 0.0
    replan_s: float = 0.0
    lowering_path: str = "none"
    compiles: int = 0
    # Constraint-pass telemetry (the generate -> enrich -> rank stage):
    # wall time of the pipeline's constraint pass, and — on the array
    # engine — how many candidate cells were re-scored this tick
    # (== the full grid on a rebuild/full pass, only the dirty
    # profile/CI slabs in incremental mode; -1 on the reference path,
    # which has no dirty accounting).
    constraint_s: float = 0.0
    dirty_candidates: int = -1
    # Fused-loop telemetry: amortized per-tick wall time of a fused trace
    # replay (``run_scanned``: stage + scan over T; 0.0 on the eager tick).
    tick_fused_s: float = 0.0
    # Fault-handling telemetry: services evicted from dead nodes this
    # tick, whether that triggered an emergency (gate-bypassing) replan,
    # and post-plan invariant violations found by the validator.
    evicted: int = 0
    emergency: bool = False
    violations: int = 0


class FallbackReason(str, Enum):
    """Closed set of fused-replay (``run_scanned``) -> eager fallback
    reasons.  A fallback replays the eager loop on the same device.

    The str mixin keeps every member ``==`` its stable reason string, so
    existing matches on ``last_scanned_fallback`` keep working; context
    that used to be interpolated into the message (engine name, tensor
    name, the stale-assignment exception) now travels in
    ``FallbackEvent.detail``.  ``megaloop._Fallback`` only accepts
    members of this enum — a new fallback path MUST add its reason here,
    which is what makes the set closed and documentable.
    """

    # configuration the fused program cannot express
    ENGINE_NOT_ARRAY = "constraint engine is not 'array'"
    NO_SCHEDULER_CONFIG = "planner exposes no scheduler config"
    BUCKETED_PLANNER = "bucketed planner shapes are not replayed fused"
    NON_NATIVE_MODULE = \
        "non-native library module needs the per-tick delegate pass"
    DEGENERATE_SHAPE = "degenerate problem shape (S or N is 0)"
    STALE_ASSIGNMENT = "current assignment is stale"
    # structural drift mid-trace (the scan stages fixed shapes/tensors)
    ENGINE_KEY_DRIFT = "engine structural key drifted mid-trace"
    LOWERING_STRUCTURE_DRIFT = "lowering structure drifted mid-trace"
    LOWERED_TENSOR_DRIFT = "lowered tensor drifted mid-trace"
    DENSE_LINK_DRIFT = "dense link mask drifted mid-trace"
    SPARSE_EDGE_DRIFT = "sparse edge set drifted mid-trace"
    AFFINITY_SLOT_COLLISION = "affinity penalty slots have multiple writers"
    AVOID_SLOT_COLLISION = "avoid penalty slots have multiple writers"
    # structural FAULT kinds: node outages / blackouts / dropouts /
    # spikes ride the scan natively, but capacity derates rewrite the
    # staged capacity tensors and must fall back loudly
    FAULT_CAPACITY_DERATE = \
        "capacity-derate faults change capacity tensors mid-trace"
    # an ARMED watchtower feeds alerts back into planning (zone
    # evacuations) — a data-dependent control flow the staged scan
    # cannot express; observe-mode watchers ride the scan natively
    WATCH_ARMED = "armed watchtower feedback needs the eager tick loop"

    def __str__(self) -> str:  # "FallbackReason.X" would leak into logs
        return self.value


@dataclass
class FallbackEvent:
    """One ``run_scanned`` -> eager fallback, with its trigger context.

    ``runtime.scanned_fallbacks`` accumulates these (append-only across
    runs); ``runtime.last_scanned_fallback`` stays the most-recent
    reason string for backwards compatibility — it used to be silently
    overwritten on repeated mid-trace drift, which is exactly what the
    event list fixes.
    """

    tick: int                 # trace tick the fallback triggered at
    reason: str               # FallbackReason member (== its stable string)
    detail: str = ""          # e.g. digest of the structural key that drifted


@dataclass
class ContinuumResult:
    ticks: List[TickRecord]
    final_assignment: Dict[str, Tuple[str, str]]

    @property
    def total_emissions_g(self) -> float:
        return sum(r.emissions_g + r.migration_g for r in self.ticks)

    @property
    def total_migrations(self) -> int:
        return sum(r.migrations for r in self.ticks)

    def summary(self) -> Dict[str, float]:
        return {
            "ticks": len(self.ticks),
            "total_emissions_g": self.total_emissions_g,
            "operational_emissions_g": sum(r.emissions_g for r in self.ticks),
            "migration_emissions_g": sum(r.migration_g for r in self.ticks),
            "migrations": self.total_migrations,
            "restarts": sum(r.restarts for r in self.ticks),
            "switches": sum(r.switched for r in self.ticks),
            "replans": sum(r.replanned for r in self.ticks),
        }

    def to_jsonl(self, path: Optional[str] = None) -> str:
        """Serialize the full tick telemetry as JSONL: one header line
        (schema tag + final assignment) followed by one ``TickRecord``
        object per line.  Floats use JSON's shortest-round-trip repr, so
        ``from_jsonl(to_jsonl())`` reproduces every record bit-for-bit.
        Writes to ``path`` when given; always returns the text."""
        header = {
            "schema": "continuum-result/v1",
            "ticks": len(self.ticks),
            "final_assignment": {
                sid: list(fn)
                for sid, fn in sorted(self.final_assignment.items())},
        }
        lines = [json.dumps(header, sort_keys=True)]
        lines.extend(json.dumps(dataclasses.asdict(r), sort_keys=True)
                     for r in self.ticks)
        text = "\n".join(lines) + "\n"
        if path is not None:
            with open(path, "w") as fh:
                fh.write(text)
        return text

    @classmethod
    def from_jsonl(cls, source: str) -> "ContinuumResult":
        """Rebuild a result from :meth:`to_jsonl` output — ``source`` is
        either the JSONL text itself or a path to a dumped file."""
        if "\n" not in source and os.path.exists(source):
            with open(source) as fh:
                source = fh.read()
        lines = [ln for ln in source.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty continuum-result JSONL")
        header = json.loads(lines[0])
        if header.get("schema") != "continuum-result/v1":
            raise ValueError(
                f"unexpected schema {header.get('schema')!r} "
                "(expected 'continuum-result/v1')")
        ticks = [TickRecord(**json.loads(ln)) for ln in lines[1:]]
        final = {sid: tuple(fn)
                 for sid, fn in header["final_assignment"].items()}
        return cls(ticks=ticks, final_assignment=final)

    def render_report(self, ledger=None, registry=None,
                      tracer=None) -> str:
        """Green-audit text report (see ``repro_torch.obs.render_report``);
        the optional ledger/registry/tracer add attribution, fallback
        events, and stage-latency rollups."""
        from repro_torch.obs import render_report as _render
        return _render(self, ledger=ledger, registry=registry,
                       tracer=tracer)


def _migration_cells(old: Dict[str, Tuple[str, str]],
                     new: Dict[str, Tuple[str, str]],
                     mig_fee: float, restart_fee: float
                     ) -> Tuple[Tuple[str, str, str, float], ...]:
    """Per-service charge cells of one switch, mirroring ``_moved`` /
    ``_flapped``: one ``migration_g`` cell per relocated or removed
    service (charged at its new cell; removals at the old one), one
    ``restart_g`` cell per in-place flavour flip."""
    cells = []
    for sid, (fl, nid) in new.items():
        if sid not in old or old[sid][1] != nid:
            cells.append((sid, fl, nid, mig_fee))
        elif old[sid][0] != fl:
            cells.append((sid, fl, nid, restart_fee))
    for sid, (fl, nid) in old.items():
        if sid not in new:
            cells.append((sid, fl, nid, mig_fee))
    return tuple(cells)


@dataclass
class ContinuumRuntime:
    """Drives the adaptive loop over synchronized carbon/workload traces."""

    app: Application
    infra: Infrastructure            # nodes carry regions, NOT carbon
    carbon: CarbonTrace
    workload: WorkloadTrace
    config: RuntimeConfig = field(default_factory=RuntimeConfig)
    pipeline: GreenConstraintPipeline = field(
        default_factory=GreenConstraintPipeline)
    planner: WhatIfPlanner = field(default_factory=lambda: WhatIfPlanner(
        GreenScheduler(SchedulerConfig(emission_weight=1.0))))
    # Per-run observability bundle (registry + tracer + emissions
    # ledger).  None (the default) keeps the loop at its uninstrumented
    # cost: the tick pays a few perf_counter reads.
    obs: Optional[Observability] = field(default=None, repr=False)
    # Green watchtower (repro_torch.obs.watch): streaming anomaly detectors +
    # SLO burn-rate evaluation over each committed tick.  None keeps the
    # loop watch-free; in "observe" mode decisions are bit-identical
    # with or without it (pure tap); in "arm" mode alerts can evacuate
    # carbon zones through the fault/emergency machinery.
    watch: Optional[Watchtower] = field(default=None, repr=False)

    current: Optional[Dict[str, Tuple[str, str]]] = None
    last_result: Optional[object] = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self._node_regions = [
            n.region or n.node_id for n in self.infra.nodes]
        # the runtime drives the pipeline tick-to-tick (it already owns
        # the gatherer's signal/forecast hooks), so the delta knob is
        # applied directly; the PLANNER may be shared/injected, so a
        # bucket override swaps in a fresh scheduler+config instead of
        # mutating the caller's (bucket=None leaves the planner's own
        # configuration untouched)
        self.pipeline.delta_substitution = self.config.delta_replanning
        self.pipeline.telemetry_window = self.config.telemetry_window
        # why run_scanned last fell back to the eager loop (None = it
        # didn't, or none has run); scanned_fallbacks is the full
        # structured history
        self.last_scanned_fallback: Optional[str] = None
        self.scanned_fallbacks: List[FallbackEvent] = []
        # fault wiring: with a schedule attached, every PLANNING signal
        # is read through the degraded views (the raw traces keep backing
        # accounting/oracle truth inside the views); without one the
        # views ARE the raw traces, so the fault-free path is unchanged.
        # The views themselves are built lazily by the _carbon_view /
        # _workload_view properties so that reassigning runtime.carbon /
        # runtime.workload mid-life (tests do) stays supported.
        if self.config.faults is not None:
            self.config.faults.check_infra(self.infra)
        self._fault_views: Dict[str, object] = {}
        # post-plan invariant violations (repro_torch.faults.validator),
        # append-only across ticks — the fault benchmark gates on this
        # staying empty
        self.placement_violations: List[PlacementViolation] = []
        if self.config.bucket is not None:
            self._apply_bucket(self.config.bucket)
        # auto-bucket warmup: observed (S, F, N, L, B) shapes per replan
        self._observed_shapes: List[Tuple] = []
        self.auto_bucket: Optional[BucketSpec] = None

    @property
    def _carbon_view(self):
        """The carbon trace the PLANNER reads: the raw trace without a
        fault schedule, else a cached :class:`DegradedCarbon` rebuilt
        whenever ``self.carbon``/``config.faults`` are repointed."""
        faults = self.config.faults
        if faults is None:
            return self.carbon
        view = self._fault_views.get("carbon")
        if (view is None or view.base is not self.carbon
                or view.faults is not faults):
            view = DegradedCarbon(
                self.carbon, faults,
                widen_per_stale_h=self.config.fault_sigma_widen)
            self._fault_views["carbon"] = view
        return view

    @property
    def _workload_view(self):
        """Workload twin of :attr:`_carbon_view`."""
        faults = self.config.faults
        if faults is None:
            return self.workload
        view = self._fault_views.get("workload")
        if (view is None or view.base is not self.workload
                or view.faults is not faults):
            view = DegradedWorkload(self.workload, faults)
            self._fault_views["workload"] = view
        return view

    def _apply_bucket(self, spec: BucketSpec) -> None:
        """Swap a bucketed scheduler into the (possibly shared/injected)
        planner without mutating the caller's config."""
        sched = self.planner.scheduler
        self.planner = dataclasses.replace(
            self.planner,
            scheduler=GreenScheduler(
                dataclasses.replace(sched.config, bucket=spec),
                device=sched.device))

    def tick(self, t: int) -> TickRecord:
        """One adaptive-loop iteration.  Repoints the pipeline gatherer's
        signal/forecast hooks at the trace's state as of ``t``; ``run``
        restores them afterwards (callers driving ``tick`` directly on a
        shared pipeline should do the same)."""
        cfg = self.config
        obs = self.obs if (self.obs is not None and self.obs.enabled) \
            else None
        # Stage timestamps are captured unconditionally (a perf_counter
        # read is ~50 ns); spans materialize from them only when an
        # Observability bundle is attached.
        t_tick0 = time.perf_counter()
        # 1. monitoring + carbon ingestion: the gatherer reads the signal
        # as of this tick (window mean -> node.carbon, persistence
        # forecast).  With a fault schedule these views are the DEGRADED
        # world: dark zones report persistence, dropout ticks deliver
        # NaN-valued samples with stable identities.
        self.pipeline.gatherer.signal = self._carbon_view.history_signal(t)
        self.pipeline.gatherer.forecast = self._carbon_view.forecast_signal(
            t, cfg.horizon_h)
        mon = self._workload_view.monitoring(t)
        t_ingest1 = time.perf_counter()

        # 2. constraints + enriched problem (KB decay happens inside); one
        # PlacementProblem per tick, lowering cached by the pipeline (the
        # delta fast path array-substitutes ci/E when only profiles moved)
        out = self.pipeline.run(self.app, self.infra, mon,
                                use_kb=cfg.use_kb)
        faults = cfg.faults
        if faults is not None \
                and self._workload_view.stale(t, cfg.telemetry_window):
            # telemetry dropout: the engine above already saw the NaN
            # samples (fresh constraints come up empty, KB mu-decays),
            # but the LOWERING must not price NaN profiles — hold the
            # last clean window's profiles instead
            out = self._held_output(out, t)
        t_cons1 = time.perf_counter()
        cstats = getattr(self.pipeline, "constraint_stats", None) or {}
        constraint_s = float(cstats.get("constraint_s", 0.0))
        dirty_candidates = int(cstats.get("rescored", -1))
        stats0 = dict(self.pipeline.lowering_stats)
        misses0 = COMPILE_CACHE.misses
        t_replan0 = time.perf_counter()
        problem = self.pipeline.problem_for(out)
        rebuild_s = time.perf_counter() - t_replan0
        low = problem.lowering
        stats1 = self.pipeline.lowering_stats
        if stats1["delta_substitutions"] > stats0["delta_substitutions"]:
            lowering_path = "delta"
        elif stats1["cache_hits"] > stats0["cache_hits"]:
            lowering_path = "cache_hit"
        else:
            lowering_path = "full"

        # fault-handling stage: mask dead/derated nodes out of the
        # lowering via the availability path, evict stranded services,
        # and decide whether this tick is an emergency
        alive = None
        evicted = 0
        emergency = False
        derate = None
        fault_alive = None          # raw fault mask (pre watch feedback)
        watch = self.watch
        if faults is not None:
            fault_alive = faults.alive_at(t)
            derate = faults.derate_at(t)
            alive = fault_alive
        if watch is not None and watch.armed:
            # armed watchtower feedback: zones flagged for evacuation are
            # masked out exactly like dead fault nodes — stranded services
            # are evicted and replaced through the emergency machinery
            keep = watch.evacuation_mask(t, self._node_regions)
            if keep is not None:
                alive = keep if alive is None else (alive & keep)
        if alive is not None:
            if not alive.all() or derate is not None:
                low = mask_unavailable(low, alive, derate=derate)
                problem = problem.with_lowering(low)
            if self.current:
                nidx = low.node_index()
                stranded = [
                    sid for sid, (_fl, nid) in self.current.items()
                    if not alive[nidx[nid]]]
                if stranded:
                    # a dead node takes its services down with it: the
                    # incumbent shrinks NOW (accounting must not bill a
                    # dead node), and re-placement is an emergency
                    evicted = len(stranded)
                    for sid in stranded:
                        del self.current[sid]
                    emergency = cfg.emergency_replan
            if (cfg.emergency_replan and not emergency
                    and derate is not None and self.current):
                # brownout: the incumbent survived but may no longer fit
                # the derated capacities — that too forces a replan
                pl, fc, nc = assignment_arrays(low, self.current)
                if check_placement(low, pl, fc, nc, alive=alive, t=t):
                    emergency = True

        replanned = (t % max(cfg.replan_every, 1) == 0) \
            or self.current is None or emergency
        switched = False
        migrations = 0
        restarts = 0
        # charged move/restart counts: zero unless the hysteresis rule
        # actually switched away from an existing assignment (the initial
        # rollout relocates everything but is not charged)
        charged_moved = 0
        charged_flapped = 0
        mig_cells: Tuple = ()
        migration_g = 0.0
        expected_saving = 0.0
        warm_rejected = False
        plan_stats = None
        t_plan0 = t_plan1 = time.perf_counter()

        if replanned:
            if cfg.oracle:
                # the oracle stays a TRUE oracle: the degraded view
                # delegates future_matrix to the raw trace
                ci_b = self._carbon_view.future_matrix(
                    self._node_regions, t, cfg.horizon_h)
            else:
                ci_b = self._carbon_view.scenario_matrix(
                    self._node_regions, t, cfg.horizon_h,
                    cfg.scenarios if cfg.use_whatif else 1)
            tick_problem = problem.with_scenarios(ScenarioBatch(ci=ci_b))
            if cfg.warm_start and self.current is not None:
                tick_problem = tick_problem.with_warm_start(self.current)
            # auto-bucket warmup: record this replan's shape; once the
            # window is full, derive waste-minimizing bucket boundaries
            # from the observed shape traffic and bucket the planner
            # (shape collection stops once the bucket is derived — or
            # never starts when auto-bucketing is off)
            if (cfg.auto_bucket_after and cfg.bucket is None
                    and self.auto_bucket is None):
                self._observed_shapes.append((
                    low.S, low.F, low.N,
                    low.comm.n_links if low.comm.kind == "sparse"
                    else None,
                    tick_problem.B))
                if len(self._observed_shapes) >= cfg.auto_bucket_after:
                    self.auto_bucket = BucketSpec.from_observed(
                        self._observed_shapes)
                    self._apply_bucket(self.auto_bucket)
            t_plan0 = time.perf_counter()
            result = self.planner.evaluate(tick_problem)
            t_plan1 = time.perf_counter()
            self.last_result = result
            plan_stats = result.plan_stats
            cand_plan = result.best_plan
            warm_rejected = any(
                "warm start rejected" in n for n in cand_plan.notes)

            if cand_plan.feasible:
                cand = plan_assignment(cand_plan)
                saving = 0.0
                if self.current is not None and cand != self.current:
                    saving = (self._expected_g(low, result, self.current)
                              - result.best_expected_g) * cfg.horizon_h
                    expected_saving = saving
                initial = self.current is None
                (switched, migrations, restarts, migration_g,
                 mig_cells) = self.hysteresis_gate(
                    cand, saving, want_cells=obs is not None,
                    force=emergency)
                if switched and not initial:
                    charged_moved = migrations
                    charged_flapped = restarts
        replan_s = time.perf_counter() - t_replan0
        compiles = COMPILE_CACHE.misses - misses0

        # 5. accounting under the TRUE instantaneous carbon intensity
        t_acct0 = time.perf_counter()
        emissions = 0.0
        placed = fcur = ncur = ci_now = None
        if self.current:
            placed, fcur, ncur = assignment_arrays(low, self.current)
            ci_now = self.carbon.now(self._node_regions, t)
            emissions = lowered_emissions(
                low, placed, fcur, ncur, ci=ci_now)
        # post-plan invariants: the committed assignment must sit on live
        # nodes within (possibly derated) capacity
        violations: List[PlacementViolation] = []
        if cfg.validate_placements and self.current:
            violations = check_placement(
                low, placed, fcur, ncur, alive=alive, t=t)
            self.placement_violations.extend(violations)
        rec = TickRecord(
            t=t, emissions_g=emissions, migration_g=migration_g,
            migrations=migrations, replanned=replanned, switched=switched,
            expected_saving_g=expected_saving,
            n_constraints=len(out.constraints),
            warm_start_rejected=warm_rejected,
            restarts=restarts, rebuild_s=rebuild_s, replan_s=replan_s,
            lowering_path=lowering_path, compiles=compiles,
            constraint_s=constraint_s, dirty_candidates=dirty_candidates,
            evicted=evicted, emergency=emergency,
            violations=len(violations))
        if obs is not None:
            t_end = time.perf_counter()
            tr = obs.tracer
            tid = tr.add("tick", t_tick0, t_end, t=t)
            tr.add("telemetry.ingest", t_tick0, t_ingest1, parent=tid)
            tr.add("constraints", t_ingest1, t_cons1, parent=tid,
                   path=str(cstats.get("path", "")))
            tr.add("lower.rebuild", t_replan0, t_replan0 + rebuild_s,
                   parent=tid, path=lowering_path)
            if replanned:
                tr.add("plan.evaluate", t_plan0, t_plan1, parent=tid)
                tr.add("switch", t_plan1, t_acct0, parent=tid,
                       switched=switched)
            tr.add("account", t_acct0, t_end, parent=tid)
            self._record_tick_metrics(obs, rec, t_end - t_tick0,
                                      plan_stats)
            if faults is not None:
                self._record_fault_events(obs, t, evicted, emergency,
                                          violations)
            obs.ledger.record(
                t, low, placed, fcur, ncur, ci_now,
                zones=self._node_regions,
                moved=charged_moved, flapped=charged_flapped,
                migration_fee_g=cfg.migration_g,
                restart_fee_g=cfg.restart_g,
                mig_cells=mig_cells)
        if watch is not None:
            if ci_now is None:
                ci_now = self.carbon.now(self._node_regions, t)
            dark: Tuple[str, ...] = ()
            stale = False
            if faults is not None:
                dmask = faults.dark_at(t)
                dark = tuple(
                    z for z, d in zip(faults.zones, dmask) if d)
                stale = bool(self._workload_view.stale(
                    t, cfg.telemetry_window))
            watch.observe_tick(
                t, rec, low, placed, fcur, ci_now,
                alive=fault_alive, dark_zones=dark,
                telemetry_stale=stale, node_zones=self._node_regions,
                registry=obs.registry if obs is not None else None)
        return rec

    def _held_output(self, out, t: int):
        """Telemetry-dropout hold: rebuild the LOWERING inputs (enriched
        app + Eq. 1/2 profiles) from the newest monitoring whose whole
        telemetry window is clean, via the estimator's direct path.  The
        constraint engine keeps the NaN view (fresh constraints empty,
        KB held under mu-decay); only the priced tensors are held."""
        monf = self._workload_view.lowering_monitoring(
            t, self.config.telemetry_window)
        est = self.pipeline.estimator
        return dataclasses.replace(
            out,
            app=est.enrich(self.app, monf),
            computation=est.computation_profiles(monf),
            communication=est.communication_profiles(monf))

    def _record_fault_events(self, obs: Observability, t: int,
                             evicted: int, emergency: bool,
                             violations: List[PlacementViolation]) -> None:
        """Exactly one structured registry event per fault occurrence
        (at its start tick), per emergency replan, and per invariant
        violation."""
        reg = obs.registry
        for ev in self.config.faults.starting(t):
            reg.event("fault." + ev.kind, tick=t, target=ev.target,
                      hours=ev.hours, magnitude=ev.magnitude)
            reg.inc("fault.injected", labels={"kind": ev.kind})
        if evicted:
            reg.inc("runtime.evictions", evicted)
        if emergency:
            reg.event("fault.emergency_replan", tick=t, stranded=evicted)
            reg.inc("runtime.emergency_replans")
        for v in violations:
            reg.event("fault.invariant_violation", tick=t, kind=v.kind,
                      service=v.service, node=v.node, detail=v.detail)
            reg.inc("fault.invariant_violations")

    def _record_tick_metrics(self, obs: Observability, rec: TickRecord,
                             tick_s: float, plan_stats) -> None:
        """Mirror one TickRecord onto the attached registry."""
        reg = obs.registry
        reg.inc("runtime.ticks")
        if rec.replanned:
            reg.inc("runtime.replans")
        if rec.switched:
            reg.inc("runtime.switches")
        if rec.migrations:
            reg.inc("runtime.migrations", rec.migrations)
        if rec.restarts:
            reg.inc("runtime.restarts", rec.restarts)
        if rec.warm_start_rejected:
            reg.inc("runtime.warm_start_rejected")
        if rec.compiles:
            reg.inc("runtime.tick_compiles", rec.compiles)
        reg.inc("lowering.path", labels={"path": rec.lowering_path})
        if rec.dirty_candidates >= 0:
            reg.gauge("engine.dirty_candidates", rec.dirty_candidates)
        reg.observe("stage.constraint_s", rec.constraint_s)
        reg.observe("stage.rebuild_s", rec.rebuild_s)
        reg.observe("stage.replan_s", rec.replan_s)
        reg.observe("stage.tick_s", tick_s)
        reg.observe("tick.emissions_g", rec.emissions_g)
        if plan_stats is not None:
            labels = plan_stats.metric_labels()
            m = plan_stats.to_metrics()
            reg.observe("planner.plan_s", m["planner.plan_s"],
                        labels=labels)
            if m["planner.compiled"]:
                reg.inc("planner.compiled", labels=labels)
                reg.observe("planner.compile_s", m["planner.compile_s"],
                            labels=labels)
            reg.gauge("planner.batch", m["planner.batch"], labels=labels)

    def run(self, start: int, ticks: int) -> ContinuumResult:
        gatherer = self.pipeline.gatherer
        saved = (gatherer.signal, gatherer.forecast)
        try:
            records = [self.tick(t) for t in range(start, start + ticks)]
        finally:
            # don't leak the trace's closures into later non-continuum
            # uses of a shared pipeline (e.g. GreenPlacement.place)
            gatherer.signal, gatherer.forecast = saved
        return ContinuumResult(ticks=records,
                               final_assignment=dict(self.current or {}))

    def run_scanned(self, start: int, ticks: int) -> ContinuumResult:
        """``run`` as one staged pass over the trace and one device scan:
        the constraint pass, KB evolution and lowering tiers are staged
        host-side in exact numpy arithmetic; the decision tick (warm-start
        validation, the branch planner, ensemble pricing, hysteresis
        switch, emissions) runs on the scheduler's device over the staged
        tensors.  Decisions, emissions and the learned KB match the eager
        loop; unsupported traces fall back to ``run`` (reason recorded in
        ``last_scanned_fallback``)."""
        from .megaloop import run_scanned as _run_scanned
        return _run_scanned(self, start, ticks)

    def hysteresis_gate(
        self, cand: Dict[str, Tuple[str, str]], saving_g: float,
        want_cells: bool = False, force: bool = False,
    ) -> Tuple[bool, int, int, float, Tuple]:
        """Step 4 — the switch-only-when-it-pays rule, shared by the eager
        tick and the fleet runtime's per-app gate.  Applies ``cand``
        against ``self.current`` given the expected ``saving_g`` over the
        horizon and returns ``(switched, migrations, restarts,
        migration_g, mig_cells)``; mutates ``self.current`` on a switch.

        The initial rollout (no incumbent) always adopts the candidate:
        every service counts as a migration but nothing is charged.  The
        oracle skips the hysteresis margin (its forecast is exact) but
        still pays — and must justify — migration/restart cost.

        ``force`` is the emergency-replan override: the candidate is
        adopted regardless of the saving-vs-cost comparison (evacuating
        a dead node must never lose to flap damping), but migration and
        restart costs are still counted and billed in full.
        """
        cfg = self.config
        if self.current is None:
            self.current = cand
            return True, len(cand), 0, 0.0, ()
        if cand == self.current:
            return False, 0, 0, 0.0, ()
        moved = self._moved(self.current, cand)
        flapped = self._flapped(self.current, cand)
        cost = cfg.migration_g * moved + cfg.restart_g * flapped
        hyst = 0.0 if cfg.oracle else cfg.hysteresis_g
        if force or saving_g > cost + hyst:
            cells = _migration_cells(
                self.current, cand, cfg.migration_g, cfg.restart_g) \
                if want_cells else ()
            self.current = cand
            return True, moved, flapped, cost, cells
        return False, 0, 0, 0.0, ()

    @staticmethod
    def _moved(old: Dict[str, Tuple[str, str]],
               new: Dict[str, Tuple[str, str]]) -> int:
        """Services whose hosting node changes (flavour-only changes are
        in-place restarts, priced separately by ``_flapped``)."""
        return sum(
            1 for sid, (_, nid) in new.items()
            if sid not in old or old[sid][1] != nid
        ) + sum(1 for sid in old if sid not in new)

    @staticmethod
    def _flapped(old: Dict[str, Tuple[str, str]],
                 new: Dict[str, Tuple[str, str]]) -> int:
        """Services that stay on their node but change flavour — in-place
        restarts, charged ``restart_g`` each so near-tied flavours don't
        oscillate for free."""
        return sum(
            1 for sid, (fl, nid) in new.items()
            if sid in old and old[sid][1] == nid and old[sid][0] != fl
        )

    def _expected_g(self, low, result, assign) -> float:
        """Expected per-window emissions of an assignment across the
        tick's forecast ensemble."""
        em = ensemble_emissions(
            low, [assignment_arrays(low, assign)], result.scenarios)
        return float(em.mean())
