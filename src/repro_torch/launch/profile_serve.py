"""Where a serving engine's time goes on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_serve --full
  PYTHONPATH=src python -m repro_torch.launch.profile_serve --arch falcon-mamba-7b --full

Builds ``ServeEngine`` (bf16, seeded random weights, 4 slots), warms it
up, then traces one admission (a B=1 prefill of 1024 tokens) and 8 decode
ticks of the full pool with ``torch.profiler``, tracing the device only
(``repro_torch.obs.profile.profile_window``).  For each window it prints
one JSON line: the host-clock wall time, the summed time of the device
kernels, the device's idle share (1 - kernel time / wall time; one stream,
so kernels do not overlap), the kernel launches, and the kernels that took
the most time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.models.config import CellTuning
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import init_from_schema
from repro_torch.models.testing import reduced
from repro_torch.obs.profile import profile_window
from repro_torch.serve import Request, ServeEngine


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-1.5b")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    slots, prompt_len, ticks, top = 4, 1024, 8, 8

    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    max_len = prompt_len + 2 * ticks + 8
    engine = ServeEngine(
        cfg, init_from_schema(0, build_schema(cfg), torch.float32, device),
        slots=slots, max_len=max_len,
        tuning=CellTuning(compute_dtype="bfloat16"), device=device)
    rng = np.random.default_rng(1)

    def submit(i, new_tokens):
        engine.submit(Request(i, rng.integers(0, cfg.vocab, size=prompt_len),
                              max_new_tokens=new_tokens))

    # warm-up with a full pool; request 0 finishes after two ticks and
    # frees its slot for the traced admission
    for i in range(slots):
        submit(i, 2 if i == 0 else 10 * ticks)
    engine.tick()
    engine.tick()
    submit(slots, 10 * ticks)
    print(json.dumps({"card": smi, "arch": cfg.name, "slots": slots,
                      "prompt_len": prompt_len}), flush=True)
    print(json.dumps(profile_window("prefill", engine._admit, top)), flush=True)

    def decode():
        for _ in range(ticks):
            engine.tick()

    print(json.dumps(profile_window(f"decode x{ticks}", decode, top)), flush=True)


if __name__ == "__main__":
    main()
