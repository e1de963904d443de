"""End-to-end Green-aware Constraint Generator (Fig. 1).

Wires together: Energy Mix Gatherer -> Energy Estimator -> Constraint
Generator -> KB Enricher -> Constraints Ranker -> Explainability Generator
-> Constraint Adapter.  One call = one iteration of the adaptive loop.

``run`` also surfaces the enriched descriptions and the Eq. 1/2 energy
profiles on its output; ``problem_for`` folds a run's output into the one
artefact the planner consumes (:class:`~repro_torch.core.problem.
PlacementProblem`), reusing one lowering across iterations of the adaptive
loop when the application/infrastructure shape is unchanged; and ``plan``
closes the loop: constraints -> array-native scheduler -> deployment plan.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .. import resolve_device
from . import adapter
from .energy import EnergyEstimator, EnergyMixGatherer
from .explain import ExplainabilityReport, generate_report
from .generator import ConstraintGenerator
from .kb import KBEnricher, KnowledgeBase
from .library import ConstraintLibrary
from .lowering import LoweredProblem, lower, substitute_profiles
from ..obs.registry import REGISTRY as _REGISTRY
from .problem import PlacementProblem
from .ranker import ConstraintRanker
from .scheduler import GreenScheduler, SchedulerConfig
from .types import (
    Application,
    Constraint,
    DeploymentPlan,
    Infrastructure,
    MonitoringData,
)


def _structural_key(out: "GeneratorOutput") -> Tuple:
    """Identity of everything the delta fast path does NOT rebuild.

    Exactly the structural inputs :func:`~repro_torch.core.lowering.lower`
    reads into mask/capacity tensors — service identities, mandatory
    flags, flavour slots and their requirements, subnet requirements,
    node identities/costs/capabilities — plus the communication EDGE SET
    (keys only).  Deliberately excluded: every estimator/gatherer-
    enriched VALUE (flavour ``energy_kwh``, node ``carbon`` and its
    forecast, per-edge communication energies) — when two ticks agree on
    this key they may still differ in ``ci[N]``, ``E[S, F]``, and edge
    energies, exactly the value tensors
    :func:`~repro_torch.core.lowering.substitute_profiles` swaps in.  Built as
    plain tuples (not stripped dataclass copies): this key is computed
    every tick of the adaptive loop, on the replanning hot path.
    """
    return (
        tuple(
            (s.component_id, s.must_deploy, s.flavours_order,
             s.requirements,
             tuple((f.name, f.requirements) for f in s.flavours))
            for s in out.app.services),
        tuple(
            (n.node_id, n.cost_per_cpu_hour, n.capabilities)
            for n in out.infra.nodes),
        tuple(sorted(out.communication)),
    )


@dataclass
class GeneratorOutput:
    constraints: Sequence[Constraint]      # ranked, weighted, filtered
    # Enriched artefacts threaded through so downstream consumers (the
    # scheduler, the launch layer) don't re-derive them per iteration.
    app: Optional[Application] = None              # energy-enriched
    infra: Optional[Infrastructure] = None         # carbon-enriched
    computation: Dict[Tuple[str, str], float] = field(default_factory=dict)
    communication: Dict[Tuple[str, str, str], float] = field(
        default_factory=dict)
    # Explainability artefacts are derived lazily: the hot continuum loop
    # consumes only the constraint columns, so per-tick report/prolog/dict
    # rendering (one object walk each) would be pure overhead there.
    _report: Optional[ExplainabilityReport] = field(
        default=None, repr=False, compare=False)
    _prolog: Optional[str] = field(default=None, repr=False, compare=False)
    _dicts: Optional[list] = field(default=None, repr=False, compare=False)

    @property
    def report(self) -> ExplainabilityReport:
        if self._report is None:
            self._report = generate_report(self.constraints)
        return self._report

    @property
    def prolog(self) -> str:
        if self._prolog is None:
            self._prolog = adapter.to_prolog(self.constraints)
        return self._prolog

    @property
    def dicts(self) -> list:
        if self._dicts is None:
            self._dicts = adapter.to_dicts(self.constraints)
        return self._dicts

    def render(self) -> str:
        return self.prolog


@dataclass
class GreenConstraintPipeline:
    library: ConstraintLibrary = field(default_factory=ConstraintLibrary.default)
    estimator: EnergyEstimator = field(default_factory=EnergyEstimator)
    gatherer: EnergyMixGatherer = field(default_factory=EnergyMixGatherer)
    ranker: ConstraintRanker = field(default_factory=ConstraintRanker)
    enricher: KBEnricher = field(default_factory=KBEnricher)
    kb: KnowledgeBase = field(default_factory=KnowledgeBase)
    alpha: float = 0.8
    flavour_scope: str = "current"
    tau_scope: str = "candidates"
    # Constraint pass implementation:
    #   "array"     — the array-native ConstraintEngine (repro_torch.learn):
    #                 vectorized Eq. 3-12 with dirty-mask incremental
    #                 re-scoring, bit-identical to the reference trio;
    #   "reference" — the legacy ConstraintGenerator + KBEnricher +
    #                 ConstraintRanker object walk;
    #   "parity"    — run BOTH and assert the outputs are identical
    #                 (the debugging/validation path).
    engine: str = "array"
    iteration: int = 0
    # Per-tick delta fast path: when consecutive ticks differ only in
    # ci[N] / E[S, F] values (same structure, same masks), rebuild the
    # lowering by array-substitution into the cached one instead of a
    # full re-lower.  Disable to force a full lower() on every profile
    # drift (benchmark baseline / debugging).
    delta_substitution: bool = True
    # One-slot lowering cache: ``(full_key, structural_key, lowering)``.
    # The full key (PlacementProblem.cache_key) covers every lowered
    # value, so an exact match reuses the lowering object untouched; the
    # structural key covers everything EXCEPT the drifting ci/E profiles,
    # so a structural-only match takes the substitution fast path.
    # Constraints are part of neither: they ride on the problem, not the
    # lowering.
    _lowering_cache: Optional[
        Tuple[tuple, Optional[tuple], LoweredProblem]] = field(
        default=None, repr=False, compare=False)
    # Observability: how each problem_for call resolved its lowering.
    lowering_stats: Dict[str, int] = field(
        default_factory=lambda: {
            "cache_hits": 0, "delta_substitutions": 0, "full_lowers": 0},
        repr=False, compare=False)
    # Observability: the last run's constraint pass — path taken, wall
    # time, and (array engine) candidate/dirty/reuse counters.
    constraint_stats: Dict[str, object] = field(
        default_factory=dict, repr=False, compare=False)
    _engine: Optional[object] = field(
        default=None, repr=False, compare=False)
    _engine_sig: Optional[tuple] = field(
        default=None, repr=False, compare=False)
    _shadow_kb: Optional[KnowledgeBase] = field(
        default=None, repr=False, compare=False)
    # Profile estimation window (ticks): 1 = instantaneous estimates from
    # this run's monitoring alone (the estimator's direct path, bit-
    # identical to the historical behaviour); >1 pools the last W
    # observation windows through a TelemetryBuffer ring before the
    # constraint pass sees them.
    telemetry_window: int = 1
    _telemetry: Optional[object] = field(
        default=None, repr=False, compare=False)
    # Where ``plan``'s default scheduler runs: the CUDA card by default
    # (raising when there is none), the CPU only with ``device="cpu"``.
    device: Optional[str] = None

    def run(
        self,
        app: Application,
        infra: Infrastructure,
        monitoring: MonitoringData,
        use_kb: bool = True,
    ) -> GeneratorOutput:
        self.iteration += 1
        infra = self.gatherer.enrich(infra)
        app = self.estimator.enrich(app, monitoring)
        computation = self.estimator.computation_profiles(monitoring)
        communication = self.estimator.communication_profiles(monitoring)
        if self.telemetry_window > 1:
            from repro_torch.learn.telemetry import TelemetryBuffer
            buf = self._telemetry
            if buf is None or buf.window != self.telemetry_window:
                buf = TelemetryBuffer(window=self.telemetry_window)
                self._telemetry = buf
            buf.ingest(self.iteration, monitoring, infra)
            computation = buf.computation_profiles(
                last=self.telemetry_window)
            communication = buf.communication_profiles(
                last=self.telemetry_window)

        t0 = time.perf_counter()
        if self.engine == "reference":
            ranked = self._reference_pass(
                app, infra, monitoring, computation, communication,
                use_kb, self._reference_kb())
            self.constraint_stats = {
                "path": "reference",
                "constraint_s": time.perf_counter() - t0,
            }
            _REGISTRY.observe("stage.constraint_s",
                              self.constraint_stats["constraint_s"])
        elif self.engine in ("array", "parity"):
            eng = self._ensure_engine()
            if self.engine == "parity" and self._shadow_kb is None:
                # snapshot the reference KB BEFORE the engine mutates its
                # own: both passes must decay this tick's mu exactly once
                # (self.kb is an ArrayKB here — _ensure_engine converted
                # it — and to_kb() materializes an independent copy; the
                # shadow must never alias the live KB)
                self._shadow_kb = self.kb.to_kb()
            res = eng.run(app, infra, computation, communication,
                          self.iteration, use_kb=use_kb)
            ranked = res.constraints
            s = res.stats
            self.constraint_stats = {
                "path": self.engine,
                "constraint_s": time.perf_counter() - t0,
                "mode": s.mode, "candidates": s.candidates,
                "rescored": s.rescored, "instantiated": s.instantiated,
                "reused": s.reused, "fresh": s.fresh,
                "retrieved": s.retrieved, "constraints": s.constraints,
            }
            _REGISTRY.observe("stage.constraint_s",
                              self.constraint_stats["constraint_s"])
            _REGISTRY.inc("engine.dirty_candidates", s.rescored)
            _REGISTRY.gauge("engine.candidates", s.candidates)
            if self.engine == "parity":
                ref = self._reference_pass(
                    app, infra, monitoring, computation, communication,
                    use_kb, self._shadow())
                if ranked != ref:
                    raise AssertionError(
                        "array constraint engine diverged from the "
                        f"reference trio at iteration {self.iteration}: "
                        f"{len(ranked)} vs {len(ref)} constraints")
        else:
            raise ValueError(
                f"unknown constraint engine {self.engine!r} "
                "(expected 'array', 'reference', or 'parity')")
        return GeneratorOutput(
            constraints=ranked,
            app=app,
            infra=infra,
            computation=computation,
            communication=communication,
        )

    # -- constraint-pass plumbing -------------------------------------------

    def _reference_pass(self, app, infra, monitoring, computation,
                        communication, use_kb, kb) -> List[Constraint]:
        """The legacy Sect. 4.3-4.5 object walk (ConstraintGenerator +
        KBEnricher + ConstraintRanker) against the given KnowledgeBase."""
        generator = ConstraintGenerator(
            library=self.library,
            estimator=self.estimator,
            alpha=self.alpha,
            flavour_scope=self.flavour_scope,
            tau_scope=self.tau_scope,
        )
        fresh = generator.generate(app, infra, monitoring, self.iteration)
        if use_kb:
            merged = self.enricher.update(
                kb, fresh, computation, communication, infra,
                self.iteration)
        else:
            merged = fresh
        return self.ranker.rank(merged)

    def _engine_config_sig(self) -> tuple:
        return (id(self.library), self.alpha, self.flavour_scope,
                self.tau_scope, self.ranker.impact_floor_g,
                self.ranker.attenuation, self.ranker.discard_below,
                self.enricher.decay, self.enricher.forget,
                self.enricher.valid)

    def _ensure_engine(self):
        """Lazily build (or refresh) the array ConstraintEngine.  The
        pipeline's KB is converted to an :class:`~repro_torch.learn.kb_array.
        ArrayKB` in place — it exposes the same read API (``kb.sk[key]``,
        ``kb.ck[key].mu``, ``save``/``load``), so existing callers keep
        working against ``pipeline.kb``."""
        from repro_torch.learn import ArrayKB, ConstraintEngine

        sig = self._engine_config_sig()
        eng = self._engine
        if eng is not None and self._engine_sig == sig \
                and eng.kb is self.kb:
            return eng
        if isinstance(self.kb, KnowledgeBase):
            self.kb = ArrayKB.from_kb(self.kb)
        self._engine = ConstraintEngine(
            library=self.library,
            kb=self.kb,
            alpha=self.alpha,
            flavour_scope=self.flavour_scope,
            tau_scope=self.tau_scope,
            impact_floor_g=self.ranker.impact_floor_g,
            attenuation=self.ranker.attenuation,
            discard_below=self.ranker.discard_below,
            decay=self.enricher.decay,
            forget=self.enricher.forget,
            valid=self.enricher.valid,
        )
        self._engine_sig = sig
        return self._engine

    def _reference_kb(self) -> KnowledgeBase:
        """KB for the pure-reference path: convert back from an ArrayKB
        if a previous array run switched the representation."""
        if not isinstance(self.kb, KnowledgeBase):
            self.kb = self.kb.to_kb()
            self._engine = None
        return self.kb

    def _shadow(self) -> KnowledgeBase:
        """The parity path's reference KnowledgeBase — snapshotted in
        ``run`` before the engine's pass (so each side decays the tick's
        mu exactly once) and evolved in lockstep afterwards."""
        assert self._shadow_kb is not None, \
            "parity shadow KB must be snapshotted before the engine pass"
        return self._shadow_kb

    def plan(
        self,
        app: Application,
        infra: Infrastructure,
        monitoring: MonitoringData,
        scheduler: Optional[GreenScheduler] = None,
        use_kb: bool = True,
        initial: Optional[Dict[str, Tuple[str, str]]] = None,
    ) -> Tuple[DeploymentPlan, GeneratorOutput]:
        """One full adaptive-loop iteration: constraints + deployment plan.

        ``initial`` warm-starts the scheduler's local search from a
        previous assignment (verified, reject-and-rebuild on infeasible).
        Without a ``scheduler``, the green profile plans on ``device``.
        """
        if scheduler is None:
            resolve_device(self.device)     # fail before the constraint pass
            scheduler = GreenScheduler(SchedulerConfig.green(),
                                       device=self.device)
        out = self.run(app, infra, monitoring, use_kb=use_kb)
        problem = self.problem_for(out)
        if initial is not None:
            problem = problem.with_warm_start(initial)
        return scheduler.plan(problem).plan, out

    def problem_for(self, out: GeneratorOutput,
                    backend: str = "auto") -> PlacementProblem:
        """Fold one pipeline iteration into a :class:`PlacementProblem`.

        Three resolution tiers, cheapest first (counted in
        ``lowering_stats``):

        1. *cache hit* — the lowering inputs are value-identical to the
           cached tick: reuse the lowering object untouched;
        2. *delta substitution* — only ``ci[N]`` / ``E[S, F]`` moved
           (same structure, same masks): array-substitute the drifting
           profiles into the cached lowering
           (:func:`~repro_torch.core.lowering.substitute_profiles`, O(S*F + N)
           instead of the full object walk);
        3. *full lower* — anything structural changed.

        The problem's constraints always come fresh from ``out`` — KB
        memory decay re-weights them every tick without touching the
        lowering.
        """
        key = (backend, PlacementProblem.cache_key(out))
        cache = self._lowering_cache
        if cache is not None and cache[0] == key:
            low = cache[2]
            self.lowering_stats["cache_hits"] += 1
            _REGISTRY.inc("lowering.path", labels={"path": "cache_hit"})
        else:
            skey = (backend, _structural_key(out)) \
                if self.delta_substitution else None
            if cache is not None and skey is not None and cache[1] == skey:
                low = substitute_profiles(
                    cache[2], out.app, out.infra, out.computation,
                    out.communication)
                self.lowering_stats["delta_substitutions"] += 1
                _REGISTRY.inc("lowering.path", labels={"path": "delta"})
            else:
                low = lower(out.app, out.infra, out.computation,
                            out.communication, backend=backend)
                self.lowering_stats["full_lowers"] += 1
                _REGISTRY.inc("lowering.path", labels={"path": "full"})
            self._lowering_cache = (key, skey, low)
        # Pass the constraints through as-is: a lazy ConstraintSet stays
        # columnar all the way into lower_constraints (no per-constraint
        # clone), and PlacementProblem.__post_init__ keeps it un-tupled.
        return PlacementProblem(lowering=low, constraints=out.constraints)
