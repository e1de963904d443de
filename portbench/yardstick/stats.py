"""Order statistics the metrics share."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(values: Sequence[float], q: float, min_count: int = 1) -> Optional[float]:
    """The ``q``-th percentile (linear interpolation between order
    statistics), or None with fewer than ``min_count`` values."""
    if len(values) < max(min_count, 1):
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
