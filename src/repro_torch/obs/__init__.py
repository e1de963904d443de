"""Observability: the metrics registry the planner and the pipeline write
to, and ``profile.profile_window``, the device trace of one window of work
(the rest of the JAX package's ``obs`` is not ported yet)."""
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    HistogramData,
    MetricsRegistry,
    MetricsScope,
    REGISTRY,
    metrics_scope,
)
