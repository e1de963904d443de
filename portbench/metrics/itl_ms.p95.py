"""95th percentile of the gaps between consecutive output tokens of a
request, over every such gap in the window.  Also read under
``itl_ms.p95.<cells>``, the per-layer name of the same quantity."""
from portbench.yardstick.stats import percentile


def read(rec):
    v = percentile(rec.get("itl_s", []), 95, min_count=20)
    return None if v is None else 1e3 * v
