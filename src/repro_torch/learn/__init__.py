"""Array-native constraint learning: the Sect. 4.3-4.5 pass as tensors.

Three components close the monitoring -> constraints gap at continuum
scale (the last non-array stage between monitoring data and the planner):

* :mod:`telemetry` — :class:`TelemetryBuffer`: batched monitoring
  ingestion into ring-buffered ``[W, SF]`` energy / ``[W, L]``
  communication / ``[W, N]`` carbon tensors;
* :mod:`kb_array` — :class:`ArrayKB`: the Eq. 6-10 Knowledge Base as
  columnar max/min/avg/count/t tensors with vectorized updates and
  mu-decay, JSON-store compatible with the reference ``KnowledgeBase``;
* :mod:`engine` — :class:`ConstraintEngine`: candidate impacts for every
  (s, f, n)/(s, f, z) pair in one shot, Eq. 5 tau as a tensor quantile,
  Eq. 11/12 ranking as masked array ops, and a dirty-mask incremental
  mode that re-scores only candidates whose profile/CI entries moved.

``GreenConstraintPipeline(engine="array")`` (the default) routes the
constraint pass through this subsystem; ``engine="reference"`` keeps the
legacy object walk and ``engine="parity"`` runs both and asserts
bit-equality.
"""
from .constraint_set import ConstraintSet  # noqa: F401
from .engine import (       # noqa: F401
    ConstraintEngine,
    EngineResult,
    EngineStats,
    quantile_inf_tensor,
)
from .kb_array import (     # noqa: F401
    ArrayKB,
    ArrayStats,
    CKSection,
    KeyedStats,
    clone_constraint,
)
from .telemetry import TelemetryBuffer  # noqa: F401
