"""Continuum runtime: the adaptive-loop subsystem.

Closes the paper's Fig. 1 loop over a time horizon: synthetic carbon /
workload traces (:mod:`traces`, numpy on the host), batched what-if
planning over forecast ensembles in one float64 planner call
(:mod:`whatif`), and the warm-starting, migration-aware discrete-time
runtime (:mod:`loop`).  Planning runs on the card unless the runtime is
given a ``device="cpu"`` scheduler and pipeline.
"""
from .loop import (          # noqa: F401
    ContinuumResult,
    ContinuumRuntime,
    FallbackEvent,
    FallbackReason,
    RuntimeConfig,
    TickRecord,
)
from .traces import (        # noqa: F401
    REGION_PRESETS,
    CarbonTrace,
    RegionProfile,
    WorkloadTrace,
)
from .whatif import WhatIfPlanner, WhatIfResult  # noqa: F401
