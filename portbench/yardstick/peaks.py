"""Published dense peaks of the cards the benchmark knows (NVIDIA data
sheets, full power limit): bf16 tensor-core FLOP/s, float32 FLOP/s outside
the tensor cores, memory bytes/s.  Frozen from ``chip_smoke.py::CARDS``."""
from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    bf16_flops: float
    f32_flops: float
    mem_bytes: float


CARDS = {
    "H100 PCIe": Peaks(756e12, 51e12, 2.0e12),
    "H100 NVL": Peaks(835e12, 60e12, 3.9e12),
    "H100": Peaks(989e12, 67e12, 3.35e12),       # SXM, 80 GB HBM3
    "H200": Peaks(989e12, 67e12, 4.8e12),
}


def card_peaks(name: str) -> Peaks:
    """The peaks of the card ``name`` (as ``torch.cuda.get_device_name``
    spells it); the first key found in the name wins, so the longer keys
    come first."""
    for key, peaks in CARDS.items():
        if key in name:
            return peaks
    raise KeyError(f"no published peaks for {name!r}; known: {sorted(CARDS)}")
