"""Hand-written CUDA kernels for Hopper, with their wrappers.

  flash_attention  — GQA attention, causal or not, online softmax
  ssd_scan         — the mamba2 SSD chunked scan, state carried across chunks
(each replaces one Pallas TPU kernel of ``repro.kernels``)
  decode_attention — flash-decoding: one query row a slot against the live
                     prefix of its cache lane (replaces none; the decode
                     step's cache attention)

``ops`` holds the model-layout wrappers and the launch counts; ``ref`` the
naive oracles; ``build`` compiles ``csrc/*.cu`` with nvcc at first use.
"""
from .ops import (LAUNCHES, decode_attention, flash_attention,  # noqa: F401
                  reset_launches, ssd_scan)
