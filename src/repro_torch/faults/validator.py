"""Post-plan placement invariants under faults.

After every committed tick — eager, scanned, and fleet — the runtime
asserts two invariants over the ACTIVE assignment:

* **liveness** — no service sits on a node the fault schedule marks
  dead at that tick;
* **capacity** — per-node cpu/ram load (summed over every tenant's
  placed services) stays within the lowering's (possibly derated)
  capacity, up to a relative float tolerance.

Violations are collected as :class:`PlacementViolation` records (never
silently dropped): the runtime stores them, the obs registry gets one
structured event each, and the fault-recovery benchmark gates on the
count being exactly zero.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PlacementViolation",
    "PlacementInvariantError",
    "check_placement",
    "check_assignment",
    "assert_valid",
]


@dataclass(frozen=True)
class PlacementViolation:
    """One broken invariant: ``kind`` is ``"dead_node"`` (service-level)
    or ``"over_capacity"`` (node-level, ``service == ""``)."""

    t: int
    kind: str
    service: str
    node: str
    detail: str = ""


class PlacementInvariantError(AssertionError):
    """Raised by :func:`assert_valid` — an infeasible placement was
    COMMITTED, which the fault-handling stage must never allow."""

    def __init__(self, violations: Sequence[PlacementViolation]):
        self.violations = tuple(violations)
        lines = [f"{len(self.violations)} placement invariant "
                 "violation(s):"]
        lines += [f"  t={v.t} {v.kind} service={v.service!r} "
                  f"node={v.node!r} {v.detail}" for v in self.violations]
        super().__init__("\n".join(lines))


def check_placement(
    low,
    placed: np.ndarray,
    fcur: np.ndarray,
    ncur: np.ndarray,
    alive: Optional[np.ndarray] = None,
    t: int = -1,
    cpu_load: Optional[np.ndarray] = None,
    ram_load: Optional[np.ndarray] = None,
    rtol: float = 1e-9,
) -> List[PlacementViolation]:
    """Validate one tensor-form assignment against a lowering.

    ``alive`` is the tick's ``[N]`` liveness mask (None = all live).
    ``cpu_load``/``ram_load`` let a caller pass pre-accumulated MULTI-
    tenant loads (the fleet path) — the capacity check then runs on
    those totals instead of this assignment's own load.
    """
    placed = np.asarray(placed, dtype=bool)
    fcur = np.asarray(fcur, dtype=np.int64)
    ncur = np.asarray(ncur, dtype=np.int64)
    out: List[PlacementViolation] = []

    if alive is not None:
        alive = np.asarray(alive, dtype=bool)
        dead = placed & ~alive[ncur]
        for s in np.nonzero(dead)[0]:
            out.append(PlacementViolation(
                t=t, kind="dead_node",
                service=low.service_ids[int(s)],
                node=low.node_ids[int(ncur[s])],
                detail="service assigned to a node that is down"))

    if cpu_load is None or ram_load is None:
        cpu_load = np.zeros(low.N)
        ram_load = np.zeros(low.N)
        sel = np.nonzero(placed)[0]
        if sel.size:
            np.add.at(cpu_load, ncur[sel], low.cpu_req[sel, fcur[sel]])
            np.add.at(ram_load, ncur[sel], low.ram_req[sel, fcur[sel]])
    cpu_cap = np.asarray(low.cpu_cap, dtype=float)
    ram_cap = np.asarray(low.ram_cap, dtype=float)
    tol_cpu = rtol * np.maximum(np.abs(cpu_cap), 1.0)
    tol_ram = rtol * np.maximum(np.abs(ram_cap), 1.0)
    for n in np.nonzero(cpu_load > cpu_cap + tol_cpu)[0]:
        out.append(PlacementViolation(
            t=t, kind="over_capacity", service="",
            node=low.node_ids[int(n)],
            detail=f"cpu load {float(cpu_load[n]):.6g} > "
                   f"cap {float(cpu_cap[n]):.6g}"))
    for n in np.nonzero(ram_load > ram_cap + tol_ram)[0]:
        out.append(PlacementViolation(
            t=t, kind="over_capacity", service="",
            node=low.node_ids[int(n)],
            detail=f"ram load {float(ram_load[n]):.6g} > "
                   f"cap {float(ram_cap[n]):.6g}"))
    return out


def check_assignment(
    low,
    assignment: Dict[str, Tuple[str, str]],
    alive: Optional[np.ndarray] = None,
    t: int = -1,
    rtol: float = 1e-9,
) -> List[PlacementViolation]:
    """Dict-form twin of :func:`check_placement` (sid -> (flavour, node))."""
    sidx = low.service_index()
    nidx = low.node_index()
    S = low.S
    placed = np.zeros(S, dtype=bool)
    fcur = np.zeros(S, dtype=np.int64)
    ncur = np.zeros(S, dtype=np.int64)
    for sid, (fl, nid) in assignment.items():
        i = sidx[sid]
        placed[i] = True
        fcur[i] = low.flavour_names[i].index(fl)
        ncur[i] = nidx[nid]
    return check_placement(low, placed, fcur, ncur, alive=alive, t=t,
                           rtol=rtol)


def assert_valid(violations: Sequence[PlacementViolation]) -> None:
    if violations:
        raise PlacementInvariantError(violations)
