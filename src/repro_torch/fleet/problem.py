"""FleetProblem: many applications competing for one infrastructure.

The paper plans one application at a time; the fleet layer expresses the
"planner as a service" scale story: A tenants, each an independent
:class:`~repro_torch.core.problem.PlacementProblem`, sharing the SAME
continuum nodes.  ``plan_many`` pads every app into the pow2 bucket grid
and plans whole shape-groups as one ``plan_branches`` call over an
``[A, ...]`` app axis; a :class:`FleetProblem` is the immutable input
bundle — the app list plus the coupling policy for the shared node
capacity:

* ``"none"``       — apps are planned independently (each sees the full
  node capacity).  Bit-identical to sequential per-app ``plan`` calls
  whenever the arithmetic is exact; over-commit is *reported*, not
  prevented.
* ``"waterfill"``  — sequential waterfilling by priority: a host loop
  over the apps where each app plans against the capacity REMAINING
  after higher-priority apps.  Never over-commits by construction.
* ``"price"``      — Lagrangian price iteration: a few rounds of the
  batched uncoupled call with per-node shadow prices on CPU/RAM folded
  into the penalty tensors, prices raised on over-committed nodes
  between rounds.  Keeps the full ``[A]`` parallelism but only
  discourages — does not forbid — over-commit; residual violations are
  reported on the result.

This module is numpy on the host; it is the JAX package's
``repro.fleet.problem``, so reports and stats compare field for field.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..core.problem import PlacementProblem, PlanResult

__all__ = [
    "COUPLINGS",
    "CapacityReport",
    "FleetProblem",
    "FleetResult",
    "FleetStats",
]

COUPLINGS = ("none", "waterfill", "price")

# float-noise guard for violation *counting* (the waterfilling planner
# itself uses exact <= comparisons in-program; this only affects how
# reported loads are compared against capacities)
_CAP_EPS = 1e-9


@dataclass(frozen=True)
class FleetProblem:
    """A tenants on shared infrastructure: the ``plan_many`` input.

    Every app must be lowered against the SAME node set (validated on
    construction: node ids and every infrastructure-side tensor must
    match) and carry no scenario batch (the fleet axis replaces the
    branch axis; B=1 per app).  ``priority`` orders the waterfilling
    scan — higher plans first, ties keep list order; it defaults to list
    order (first app first).
    """

    apps: Tuple[PlacementProblem, ...]
    names: Tuple[str, ...] = ()
    priority: Tuple[float, ...] = ()
    coupling: str = "none"
    price_rounds: int = 4
    price_step: float = 1.0

    def __post_init__(self) -> None:
        apps = tuple(self.apps)
        object.__setattr__(self, "apps", apps)
        names = tuple(self.names) if self.names else tuple(
            f"app{i}" for i in range(len(apps)))
        if len(names) != len(apps):
            raise ValueError(
                f"{len(names)} names for {len(apps)} apps")
        if len(set(names)) != len(names):
            raise ValueError(f"fleet app names must be unique: {names!r}")
        object.__setattr__(self, "names", names)
        prio = tuple(float(p) for p in self.priority) if self.priority \
            else (0.0,) * len(apps)
        if len(prio) != len(apps):
            raise ValueError(
                f"{len(prio)} priorities for {len(apps)} apps")
        object.__setattr__(self, "priority", prio)
        if self.coupling not in COUPLINGS:
            raise ValueError(
                f"unknown coupling {self.coupling!r} "
                f"(expected one of {COUPLINGS})")
        for name, p in zip(names, apps):
            if p.scenarios is not None:
                raise ValueError(
                    f"fleet app {name!r} carries a ScenarioBatch; "
                    "plan_many batches over the APP axis (B=1 per app) — "
                    "drop the scenarios with problem.with_scenarios(None)")
        self._validate_shared_infra()

    def _validate_shared_infra(self) -> None:
        """Apps compete for the same nodes, so every infrastructure-side
        tensor must be identical across the fleet — otherwise capacity
        coupling (and the shared-tensor batching) would be meaningless."""
        if len(self.apps) < 2:
            return
        ref = self.apps[0].lowering
        for name, p in zip(self.names[1:], self.apps[1:]):
            low = p.lowering
            if low.node_ids != ref.node_ids:
                raise ValueError(
                    f"fleet app {name!r} is lowered against different "
                    "nodes than the first app — all apps must share one "
                    "Infrastructure")
            for f in ("ci", "cost", "cpu_cap", "ram_cap", "avail_cap"):
                if not np.array_equal(getattr(low, f), getattr(ref, f)):
                    raise ValueError(
                        f"fleet app {name!r}: infrastructure tensor "
                        f"{f!r} differs from the first app's — all apps "
                        "must share one Infrastructure state")

    @property
    def A(self) -> int:
        return len(self.apps)

    def __len__(self) -> int:
        return len(self.apps)

    def waterfill_order(self) -> List[int]:
        """App indices in planning order: descending priority, stable on
        ties (list order)."""
        return sorted(range(self.A), key=lambda i: -self.priority[i])


@dataclass
class CapacityReport:
    """Post-plan accounting of the shared node capacity.

    ``cpu_load``/``ram_load`` sum every feasible app's placed
    requirements per node; ``violations`` counts nodes whose total load
    exceeds capacity (what uncoupled planning can produce when apps
    race for the same nodes, and what waterfilling guarantees to be
    zero)."""

    node_ids: Tuple[str, ...]
    cpu_load: np.ndarray   # [N] fleet-total CPU load
    ram_load: np.ndarray   # [N]
    cpu_cap: np.ndarray    # [N]
    ram_cap: np.ndarray    # [N]

    @property
    def cpu_excess(self) -> np.ndarray:
        return np.maximum(self.cpu_load - self.cpu_cap, 0.0)

    @property
    def ram_excess(self) -> np.ndarray:
        return np.maximum(self.ram_load - self.ram_cap, 0.0)

    @property
    def violated_nodes(self) -> np.ndarray:
        """[N] bool — node over-committed on CPU or RAM."""
        return ((self.cpu_load > self.cpu_cap + _CAP_EPS)
                | (self.ram_load > self.ram_cap + _CAP_EPS))

    @property
    def violations(self) -> int:
        return int(self.violated_nodes.sum())

    def summary(self) -> Dict[str, float]:
        denom_c = float(self.cpu_cap.sum()) or 1.0
        denom_r = float(self.ram_cap.sum()) or 1.0
        return {
            "violations": float(self.violations),
            "cpu_excess": float(self.cpu_excess.sum()),
            "ram_excess": float(self.ram_excess.sum()),
            "cpu_utilization": float(self.cpu_load.sum()) / denom_c,
            "ram_utilization": float(self.ram_load.sum()) / denom_r,
        }


@dataclass
class FleetStats:
    """Telemetry of one ``plan_many`` call."""

    groups: int = 0            # distinct (backend, padded-shape) groups
    calls: int = 0             # batched planner calls (chunks)
    compiles: int = 0          # first-seen program signatures this call
    plan_time_s: float = 0.0   # wall time inside the planner calls
    price_rounds: int = 0      # Lagrangian rounds actually run
    sharded: bool = False      # the app axis split over the group's ranks
    devices: int = 1
    apps: int = 0
    padded_apps: int = 0       # phantom-app rows planned and dropped

    def to_dict(self) -> Dict[str, float]:
        return {
            "groups": self.groups, "calls": self.calls,
            "compiles": self.compiles, "plan_time_s": self.plan_time_s,
            "price_rounds": self.price_rounds,
            "sharded": float(self.sharded), "devices": self.devices,
            "apps": self.apps, "padded_apps": self.padded_apps,
        }


@dataclass
class FleetResult:
    """What ``plan_many`` returns: one B=1 :class:`PlanResult` per app
    (same order as ``fleet.apps``) plus fleet-level accounting."""

    fleet: FleetProblem
    results: List[PlanResult]
    emissions_g: np.ndarray      # [A] per-app grams (inf where infeasible)
    capacity: CapacityReport
    coupling: str
    stats: FleetStats = field(default_factory=FleetStats)

    @property
    def A(self) -> int:
        return len(self.results)

    def __len__(self) -> int:
        return len(self.results)

    def result(self, name: str) -> PlanResult:
        try:
            i = self.fleet.names.index(name)
        except ValueError:
            raise KeyError(
                f"unknown fleet app {name!r} "
                f"(have {self.fleet.names!r})") from None
        return self.results[i]

    @property
    def feasible(self) -> np.ndarray:
        """[A] bool — app's plan is feasible."""
        return np.array([r.plans[0].feasible for r in self.results],
                        dtype=bool)

    @property
    def total_emissions_g(self) -> float:
        """Fleet-total grams over feasible apps (the per-app addends are
        ``emissions_g`` — the same values per-tenant billing sums)."""
        em = self.emissions_g
        return float(em[np.isfinite(em)].sum())

    def assignments(self) -> Dict[str, Dict[str, Tuple[str, str]]]:
        """name -> service -> (flavour, node) for every feasible app."""
        out = {}
        for name, r in zip(self.fleet.names, self.results):
            if r.plans[0].feasible:
                out[name] = r.assignment(0)
        return out

    def infeasible_apps(self) -> List[str]:
        return [name for name, r in zip(self.fleet.names, self.results)
                if not r.plans[0].feasible]


def accumulate_loads(low, placed: np.ndarray, fcur: np.ndarray,
                     ncur: np.ndarray, cpu_load: np.ndarray,
                     ram_load: np.ndarray) -> None:
    """Add one assignment's placed per-node CPU/RAM requirements into the
    fleet load accumulators, in place."""
    placed = np.asarray(placed, dtype=bool)
    if low.S == 0 or not placed.any():
        return
    N = cpu_load.shape[0]
    sel_cpu = np.take_along_axis(low.cpu_req, fcur[:, None], axis=1)[:, 0]
    sel_ram = np.take_along_axis(low.ram_req, fcur[:, None], axis=1)[:, 0]
    cpu_load += np.bincount(
        ncur[placed], weights=sel_cpu[placed], minlength=N)
    ram_load += np.bincount(
        ncur[placed], weights=sel_ram[placed], minlength=N)


def empty_capacity_report() -> CapacityReport:
    z = np.zeros(0)
    return CapacityReport((), z.copy(), z.copy(), z.copy(), z.copy())


def fleet_capacity_report(
    fleet: FleetProblem,
    results: List[PlanResult],
) -> CapacityReport:
    """Sum every feasible app's placed per-node loads against the shared
    capacities (infeasible apps deploy nothing and consume nothing)."""
    if not fleet.apps:
        return empty_capacity_report()
    ref = fleet.apps[0].lowering
    N = ref.N
    cpu_load = np.zeros(N)
    ram_load = np.zeros(N)
    for p, r in zip(fleet.apps, results):
        if not r.plans[0].feasible:
            continue
        accumulate_loads(p.lowering, *r.arrays(0), cpu_load, ram_load)
    return CapacityReport(
        node_ids=ref.node_ids, cpu_load=cpu_load, ram_load=ram_load,
        cpu_cap=np.asarray(ref.cpu_cap, dtype=float),
        ram_cap=np.asarray(ref.ram_cap, dtype=float))
