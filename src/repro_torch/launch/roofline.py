"""Roofline terms of one device's step, from ``launch.cost``'s counts.

The port's counterpart of ``repro.launch.hlo_analysis.Roofline``: the same
fields, properties and ``to_dict``, with the constants of one NVIDIA H100
SXM (80 GB HBM3; NVIDIA's data sheet, dense rates at the full 700 W power
limit):
  989 TFLOP/s bf16 on the tensor cores  |  67 TFLOP/s float32 outside them
  3.35 TB/s HBM  |  NVLink 450 GB/s each way to the other cards of a host
The compute peak is the one of the plan's compute dtype.  The collective
term is the per-device collective operand bytes (``launch.cost``, the
counterpart of ``hlo_analysis.collective_bytes``) over ``LINK_BW``, as the
JAX ``Roofline`` divides by its link rate; on one card it is 0.

One NVLink rate is a lower bound on the collective time of the production
meshes: an HGX H100 host joins 8 cards by NVLink, so a 16-wide model axis
(and every data or pod axis) crosses hosts, whose links (InfiniBand, about
50 GB/s a card each way) are an order of magnitude slower.  A two-tier
link model is not part of the JAX package's roofline either (ROADMAP).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
HBM_BYTES = 80e9              # 80 GB of HBM3: what a cell must fit in
LINK_BW = 450e9


@dataclass
class Roofline:
    """Per-device roofline terms, in seconds."""

    flops: float                  # per-device FLOPs (launch.cost)
    hbm_bytes: float              # per-device bytes accessed
    coll_bytes: float             # per-device collective operand bytes
    model_flops: float            # 6*N*D useful FLOPs (global)
    chips: int
    compute_dtype: str = "bfloat16"

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[self.compute_dtype]

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term-bound step time that is useful
        compute: (model_flops / chips / peak) / max(term)."""
        ideal = self.model_flops / self.chips / self.peak_flops
        worst = max(self.compute_s, self.memory_s, self.collective_s)
        return ideal / worst if worst else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }
