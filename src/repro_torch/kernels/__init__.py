"""Hand-written CUDA kernels for Hopper, with their wrappers.

  flash_attention  — GQA attention, causal or not, online softmax
  ssd_scan         — the mamba2 SSD chunked scan, state carried across chunks
(each replaces one Pallas TPU kernel of ``repro.kernels``)
  decode_attention — flash-decoding: one query row a slot against the live
                     prefix of its cache lane (replaces none; the decode
                     step's cache attention)

Each kernel's module holds its wrapper and its one plain PyTorch version
(``flash_attention.attention_reference``, which with ``kv_len`` is decode
attention's too, and ``ssd_scan.ssd_chunked``): the operators' CPU
implementation, the models' plain routes and the comparison on the card.
``ops`` holds the model-layout operators and the launch counts; ``ref`` the
naive oracles; ``build`` compiles ``csrc/*.cu`` with nvcc at first use.
The models import this package; it imports nothing of them.
"""
from .ops import (LAUNCHES, decode_attention, flash_attention,  # noqa: F401
                  reset_launches, ssd_scan)
