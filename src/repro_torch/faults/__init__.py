"""Fault injection and degraded-mode machinery for the continuum.

Three pieces, deliberately dependent only on :mod:`repro_torch.core` and
numpy (the continuum runtime imports THIS package, never the reverse):

* :mod:`repro_torch.faults.trace` — :class:`FaultTrace`, the seeded
  trace-aligned fault schedule (node outages, carbon-zone blackouts,
  telemetry dropouts, workload spikes, capacity derates);
* :mod:`repro_torch.faults.degrade` — :class:`DegradedCarbon` /
  :class:`DegradedWorkload`, the pure per-tick views the runtime plans
  through while faults are active;
* :mod:`repro_torch.faults.validator` — post-plan invariants (services only
  on live nodes, within capacity) enforced after every committed tick.
"""
from .degrade import DegradedCarbon, DegradedWorkload  # noqa: F401
from .trace import FAULT_KINDS, FaultEvent, FaultTrace  # noqa: F401
from .validator import (  # noqa: F401
    PlacementInvariantError,
    PlacementViolation,
    assert_valid,
    check_assignment,
    check_placement,
)
