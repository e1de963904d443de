"""Fleet planning: multi-tenant placement over shared infrastructure.

``plan_many`` plans A applications against one Infrastructure as one
batched float64 planner call per padded-shape group and chunk (uncoupled
/ waterfill / price-coupled capacity), on the scheduler's device;
:class:`FleetRuntime` drives the whole fleet's adaptive continuum loop
with one replan per tick and per-tenant billing on the emissions ledger.
"""
from .problem import (
    COUPLINGS,
    CapacityReport,
    FleetProblem,
    FleetResult,
    FleetStats,
    accumulate_loads,
    fleet_capacity_report,
)
from .planner import plan_many
from .runtime import FleetApp, FleetRunResult, FleetRuntime, FleetTickRecord

__all__ = [
    "COUPLINGS",
    "CapacityReport",
    "FleetApp",
    "FleetProblem",
    "FleetResult",
    "FleetRunResult",
    "FleetRuntime",
    "FleetStats",
    "FleetTickRecord",
    "accumulate_loads",
    "fleet_capacity_report",
    "plan_many",
]
