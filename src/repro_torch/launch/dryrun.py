"""Dry run: count every (architecture x input-shape) cell's step on one card.

The port of ``repro.launch.dryrun``.  Where the JAX package lowers and
compiles each cell against a production mesh, the port runs the cell's
step on fake tensors of its full shapes (``launch.plan``), counting its
FLOPs, bytes and memory (``launch.cost``) without allocating or launching
anything, and turns the counts into the H100's roofline terms
(``launch.roofline``).  ``compile_s`` holds the counting seconds.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-1.2b \\
      --shape decode_32k --device cpu

The fakes live on the card by default (``--device cuda``, which needs one:
autograd places fake CUDA tensors on a CUDA device); ``--device cpu`` counts
on CPU fakes, which give the same counts.  The records feed
``GreenPlacement`` (``JobSpec.roofline``), as the JAX package's do in
``examples/green_deployment.py``.  The mesh flags (``--multi-pod``,
``--both-meshes``) wait for the multi-device slice (ROADMAP queue 1,
item 6).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Dict, Optional

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import cost
from repro_torch.launch.plan import build_plan
from repro_torch.launch.roofline import HBM_BYTES, Roofline
from repro_torch.models.config import SHAPES, cell_is_supported
from repro_torch.obs import Tracer


def run_cell(
    arch: str, shape: str, *,
    tuning_overrides: Optional[Dict] = None,
    optimized: bool = False,
    tracer: Optional[Tracer] = None,
    device=None,
) -> Dict:
    """Count one cell; returns the dry-run record (the JAX package's layout,
    ``multi_pod`` always False, without ``xla_cost_analysis``).

    ``device`` (None = the card, raising without one) holds the fakes.
    Pass a ``repro_torch.obs.Tracer`` to get one ``dryrun.cell`` span per
    cell with ``dryrun.plan``, ``dryrun.count`` (the JAX package's lower and
    compile) and ``dryrun.analyze`` child spans."""
    device = resolve_device(device)
    if tracer is None:
        tracer = Tracer(enabled=False)
    ok, why = cell_is_supported(ARCHS[arch], SHAPES[shape])
    if not ok:
        return {"arch": arch, "shape": shape, "multi_pod": False,
                "status": "skipped", "reason": why}
    t0 = time.time()
    with tracer.span("dryrun.cell", arch=arch, shape=shape, multi_pod=False):
        with tracer.span("dryrun.plan"):
            plan = build_plan(arch, shape, tuning_overrides=tuning_overrides,
                              optimized=optimized, device=device)
        with tracer.span("dryrun.count"):
            with FakeTensorMode():
                args = plan.abstract_args()
            totals = cost.analyze(plan.step_fn, *args)
        with tracer.span("dryrun.analyze"):
            roof = Roofline(flops=totals.flops, hbm_bytes=totals.bytes,
                            coll_bytes=totals.coll_bytes,
                            model_flops=plan.model_flops, chips=plan.chips,
                            compute_dtype=plan.tuning.compute_dtype)
    return {
        "arch": arch, "shape": shape, "multi_pod": False,
        "optimized": optimized,
        "status": "ok",
        "device": device.type,
        "compile_s": round(time.time() - t0, 1),
        "memory": totals.memory,
        "collectives": {
            "counts": totals.coll_counts,
            "bytes_by_kind": totals.coll_bytes_by_kind,
        },
        "roofline": roof.to_dict(),
    }


def summary(rec: Dict) -> str:
    """The CLI's line for one record."""
    label = f"{rec['arch']} x {rec['shape']} x 1 card"
    if rec["status"] == "skipped":
        return f"[SKIP] {label}: {rec['reason']}"
    if rec["status"] != "ok":
        return f"[FAIL] {label}: {rec['error']}"
    r, peak = rec["roofline"], rec["memory"]["peak_bytes_per_device"]
    fits = "fits" if peak <= HBM_BYTES else "does not fit"
    return (f"[OK]   {label}: mem={peak / 2**30:.2f}GiB/dev ({fits} in 80 GB) "
            f"compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms "
            f"coll={r['collective_s'] * 1e3:.2f}ms "
            f"bottleneck={r['bottleneck']} "
            f"frac={r['roofline_fraction']:.3f} "
            f"(count {rec['compile_s']}s)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply launch.plan.OPTIMIZED_OVERRIDES per arch")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--trace-out", default=None,
                    help="write dryrun.* spans as JSONL here")
    ap.add_argument("--device", default=None,
                    help="where the fakes live: cuda (default, needs a card) or cpu")
    args = ap.parse_args()
    tracer = Tracer() if args.trace_out else None

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        try:
            rec = run_cell(arch, shape, optimized=args.optimized,
                           tracer=tracer, device=args.device)
        except Exception as e:  # a failure here is a bug in the system
            failures += 1
            rec = {
                "arch": arch, "shape": shape, "multi_pod": False,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
        print(summary(rec), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
    if tracer is not None:
        with open(args.trace_out, "w") as fh:
            fh.write(tracer.to_jsonl())
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
