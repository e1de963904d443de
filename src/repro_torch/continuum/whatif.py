"""Batched what-if planning over carbon-forecast scenarios.

Stacks B forecast branches into a ``ScenarioBatch`` on a
:class:`~repro_torch.core.problem.PlacementProblem` and prices ALL of them in
one float64 planner call over the branch axis, through the single scheduler
entrypoint
(``GreenScheduler.plan(problem)``), then selects the plan with the lowest
EXPECTED emissions across the whole ensemble — branch b's plan is optimal
for forecast b, but the selected plan must hedge against every branch, so
each candidate is re-priced under all B forecasts (float64 numpy on the
host, in the JAX package's order, so the expected emissions carry the same
bits) before the argmin.

``evaluate_sequential`` is the reference path — B separate single-branch
``plan`` calls over per-scenario lowerings — kept for the equivalence
tests and the batched-vs-sequential benchmark.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.lowering import LoweredProblem, ScenarioBatch
from repro_torch.core.problem import PlacementProblem, PlanStats
from repro_torch.core.scheduler import GreenScheduler, SchedulerConfig
from repro_torch.core.types import Constraint, DeploymentPlan
from repro_torch.obs.registry import REGISTRY as _REGISTRY


def assignment_arrays(
    low: LoweredProblem, assign: Dict[str, Tuple[str, str]]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map a service -> (flavour, node) assignment to lowered index arrays
    ``(placed, fcur, ncur)`` for tensor-side pricing."""
    S = low.S
    placed = np.zeros(S, dtype=bool)
    fcur = np.zeros(S, dtype=np.int64)
    ncur = np.zeros(S, dtype=np.int64)
    sidx, nidx = low.service_index(), low.node_index()
    for sid, (fname, nid) in assign.items():
        s = sidx[sid]
        placed[s] = True
        fcur[s] = low.flavour_names[s].index(fname)
        ncur[s] = nidx[nid]
    return placed, fcur, ncur


def plan_assignment(plan: DeploymentPlan) -> Dict[str, Tuple[str, str]]:
    return {p.service: (p.flavour, p.node) for p in plan.placements}


@dataclass
class WhatIfResult:
    """B branch plans + the cross-ensemble emission matrix."""

    plans: List[DeploymentPlan]
    scenarios: ScenarioBatch
    # emissions_g[i, j] — plan of branch i priced under forecast branch j
    emissions_g: np.ndarray
    # expected_g[i] — mean over forecast branches (inf for infeasible plans)
    expected_g: np.ndarray
    best_index: int
    # compile-cache / timing telemetry of the one batched plan call (None
    # on the sequential reference path, which makes B separate calls)
    plan_stats: Optional[PlanStats] = None

    @property
    def best_plan(self) -> DeploymentPlan:
        return self.plans[self.best_index]

    @property
    def best_expected_g(self) -> float:
        return float(self.expected_g[self.best_index])


def ensemble_emissions(
    low: LoweredProblem,
    assignments: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    scenarios: ScenarioBatch,
) -> np.ndarray:
    """``[P, B]`` — emissions of each of P assignments under each of B
    forecast branches, as one broadcasted tensor op (the O(P*B) Python
    loop over ``lowered_emissions`` dominates what-if wall time otherwise).
    """
    ci_b, E_b, _ = scenarios.materialize(low)
    P, B, S = len(assignments), scenarios.B, low.S
    if P == 0:
        return np.zeros((0, B))
    placed = np.stack([a[0] for a in assignments])        # [P, S]
    fcur = np.stack([a[1] for a in assignments])
    ncur = np.stack([a[2] for a in assignments])
    s_ix = np.arange(S)
    # computation: E_b[j, s, fcur[p, s]] * ci_b[j, ncur[p, s]]
    Esel = np.asarray(E_b)[:, s_ix[None, :], fcur]        # [B, P, S]
    cisel = ci_b[:, ncur]                                 # [B, P, S]
    comp = (placed[None] * Esel * cisel).sum(-1).T        # [P, B]
    # communication: plan-dependent energy x branch mean CI — the pairwise
    # term comes from the lowering's comm backend (dense or COO)
    commE = low.comm.pairwise_energy(placed, fcur, ncur)  # [P]
    return comp + commE[:, None] * ci_b.mean(axis=1)[None, :]


def _score(
    low: LoweredProblem,
    plans: List[DeploymentPlan],
    scenarios: ScenarioBatch,
    arrays: Optional[Sequence[Tuple]] = None,
    plan_stats: Optional[PlanStats] = None,
) -> WhatIfResult:
    feas = [i for i, p in enumerate(plans) if p.feasible]
    em = np.full((len(plans), scenarios.B), np.inf)
    if feas:
        if arrays is None:
            arrays = [assignment_arrays(low, plan_assignment(p))
                      for p in plans]
        em[feas] = ensemble_emissions(
            low, [arrays[i] for i in feas], scenarios)
    expected = em.mean(axis=1)
    best = int(np.argmin(expected))
    return WhatIfResult(plans=plans, scenarios=scenarios, emissions_g=em,
                        expected_g=expected, best_index=best,
                        plan_stats=plan_stats)


def _coerce_problem(problem: PlacementProblem, scenarios, constraints,
                    initial) -> PlacementProblem:
    """Fold the keyword convenience overrides into the problem.  (The
    pre-PlacementProblem ``evaluate(LoweredProblem, ...)`` form was
    removed; pass a problem and attach the batch with
    ``problem.with_scenarios``.)"""
    if isinstance(problem, LoweredProblem):
        raise TypeError(
            "WhatIfPlanner.evaluate takes a PlacementProblem (wrap the "
            "lowering: PlacementProblem(lowering=low).with_scenarios("
            "batch)); the bare-LoweredProblem form was removed")
    if scenarios is not None:
        problem = problem.with_scenarios(scenarios)
    if constraints is not None:
        problem = problem.with_constraints(constraints)
    if initial is not None:
        problem = problem.with_warm_start(initial)
    return problem


@dataclass
class WhatIfPlanner:
    """Prices forecast ensembles; carbon-aware scheduler config by default
    (the green profile's objective is CI-blind — the what-if branches only
    diverge when the emission term is priced in).  The default scheduler
    plans on the card and raises without one; inject
    ``GreenScheduler(..., device="cpu")`` to plan on the CPU."""

    scheduler: GreenScheduler = field(default_factory=lambda: GreenScheduler(
        SchedulerConfig(emission_weight=1.0)))

    def evaluate(
        self,
        problem: PlacementProblem,
        scenarios: Optional[ScenarioBatch] = None,
        constraints: Optional[Sequence[Constraint]] = None,
        initial: Optional[Dict[str, Tuple[str, str]]] = None,
    ) -> WhatIfResult:
        """One planner call plans every branch; returns the scored result.

        The problem must carry a ``ScenarioBatch`` (attach one with
        ``problem.with_scenarios``; the keyword is a convenience override).
        """
        problem = _coerce_problem(problem, scenarios, constraints, initial)
        if problem.scenarios is None:
            raise ValueError(
                "what-if evaluation needs problem.scenarios (a "
                "ScenarioBatch of forecast branches)")
        t0 = time.perf_counter()
        result = self.scheduler.plan(problem)
        t1 = time.perf_counter()
        arrays = [result.arrays(b) for b in range(result.B)]
        scored = _score(problem.lowering, result.plans, problem.scenarios,
                       arrays=arrays, plan_stats=result.stats)
        # Stage split for the tick pipeline: the batched plan call vs the
        # cross-ensemble re-pricing that follows it.
        _REGISTRY.observe("stage.plan_s", t1 - t0)
        _REGISTRY.observe("stage.price_s", time.perf_counter() - t1)
        return scored

    def evaluate_sequential(
        self,
        problem: PlacementProblem,
        scenarios: Optional[ScenarioBatch] = None,
        constraints: Optional[Sequence[Constraint]] = None,
        initial: Optional[Dict[str, Tuple[str, str]]] = None,
    ) -> WhatIfResult:
        """Reference path: re-plan each branch separately (B single-branch
        ``plan`` calls over per-scenario lowerings) — what the adaptive
        loop would have to do without the scenario axis."""
        problem = _coerce_problem(problem, scenarios, constraints, initial)
        if problem.scenarios is None:
            raise ValueError("what-if evaluation needs problem.scenarios")
        low, scen = problem.lowering, problem.scenarios
        ci_b, E_b, order_b = scen.materialize(low)
        plans: List[DeploymentPlan] = []
        arrays: List[Tuple] = []
        for b in range(scen.B):
            # thread the branch's greedy order too: when E varies, the
            # base lowering's order (keyed on the base profiles) would
            # diverge from what the batched planner uses
            low_b = dataclasses.replace(
                low, ci=ci_b[b], mean_ci=float(ci_b[b].mean()),
                E=np.asarray(E_b[b]), order=np.asarray(order_b[b]))
            res = self.scheduler.plan(
                dataclasses.replace(problem, lowering=low_b, scenarios=None))
            plans.append(res.plan)
            arrays.append(res.arrays(0))
        return _score(low, plans, scen, arrays=arrays)
