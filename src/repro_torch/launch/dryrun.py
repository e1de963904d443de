"""Dry run: count every (architecture x input-shape) cell's step on one
card, or per device on the JAX package's production meshes.

The port of ``repro.launch.dryrun``.  Where the JAX package lowers and
compiles each cell against a production mesh, the port runs the cell's
step on fake tensors of its full shapes (``launch.plan``), counting its
FLOPs, bytes, memory and collectives (``launch.cost``) without allocating
or launching anything, and turns the counts into the H100's roofline
terms (``launch.roofline``).  ``compile_s`` holds the counting seconds.

On a mesh (``--multi-pod``: 2x16x16, ``--both-meshes``: each cell on
16x16 and on 2x16x16) the count runs in a fake world of
256 or 512 ranks (``launch.mesh.fake_world``): this process is rank 0, the
step's tensors are DTensors whose local fakes have rank 0's shapes, and
every collective DTensor dispatches is counted with its per-device operand
bytes.  The record's ``multi_pod`` is the JAX package's; its ``mesh`` names
the mesh (``1 card``, ``16x16``, ``2x16x16``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_results.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-1.2b \\
      --shape decode_32k --device cpu

The fakes live on the card by default (``--device cuda``, which needs one:
autograd places fake CUDA tensors on a CUDA device); ``--device cpu`` counts
on CPU fakes, which give the same FLOPs, bytes and memory.  The records
feed ``GreenPlacement`` (``JobSpec.roofline``), as the JAX package's do in
``examples/green_deployment.py``.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Dict, Optional

import contextlib

import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import cost
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.plan import build_plan
from repro_torch.launch.roofline import HBM_BYTES, Roofline
from repro_torch.models.config import SHAPES, cell_is_supported
from repro_torch.obs import Tracer


MESH_NAMES = {None: "1 card", False: "16x16", True: "2x16x16"}


def _world(chips: int):
    """A fake world of ``chips`` ranks, or the one this process has open
    (which must have that many ranks)."""
    if not dist.is_initialized():
        return fake_world(chips)
    if dist.get_world_size() != chips:
        raise RuntimeError(f"the open process group has {dist.get_world_size()} "
                           f"ranks; this mesh needs {chips}")
    return contextlib.nullcontext()


def run_cell(
    arch: str, shape: str, *,
    multi_pod: Optional[bool] = None,
    tuning_overrides: Optional[Dict] = None,
    optimized: bool = False,
    tracer: Optional[Tracer] = None,
    device=None,
) -> Dict:
    """Count one cell; returns the dry-run record (the JAX package's layout
    without ``xla_cost_analysis``; a mesh's record adds ``mesh`` and the
    implicit collectives).

    ``multi_pod``: None counts on one card; False and True per device on
    the 16x16 and 2x16x16 meshes, in a fake world of 256 or 512 ranks
    (opened here unless this process has one of that size open).
    ``device`` (None = the card, raising without one) holds the fakes.
    Pass a ``repro_torch.obs.Tracer`` to get one ``dryrun.cell`` span per
    cell (with its mesh) with ``dryrun.plan``, ``dryrun.count`` (the JAX
    package's lower and compile) and ``dryrun.analyze`` child spans."""
    device = resolve_device(device)
    if tracer is None:
        tracer = Tracer(enabled=False)
    head = {"arch": arch, "shape": shape, "multi_pod": bool(multi_pod)}
    if multi_pod is not None:
        head["mesh"] = MESH_NAMES[multi_pod]
    ok, why = cell_is_supported(ARCHS[arch], SHAPES[shape])
    if not ok:
        return {**head, "status": "skipped", "reason": why}
    t0 = time.time()
    with tracer.span("dryrun.cell", arch=arch, shape=shape,
                     multi_pod=bool(multi_pod), mesh=MESH_NAMES[multi_pod]):
        with tracer.span("dryrun.plan"):
            plan = build_plan(arch, shape, multi_pod=multi_pod,
                              tuning_overrides=tuning_overrides,
                              optimized=optimized, device=device)
        with tracer.span("dryrun.count"):
            world = _world(plan.chips) if plan.rules is not None \
                else contextlib.nullcontext()
            with world:
                mesh = None if plan.rules is None else \
                    make_production_mesh(multi_pod=multi_pod, device_type=device.type)
                with FakeTensorMode():
                    args = plan.abstract_args(mesh=mesh)
                totals = cost.analyze(plan.step_fn, *args)
        with tracer.span("dryrun.analyze"):
            roof = Roofline(flops=totals.flops, hbm_bytes=totals.bytes,
                            coll_bytes=totals.coll_bytes,
                            model_flops=plan.model_flops, chips=plan.chips,
                            compute_dtype=plan.tuning.compute_dtype)
    collectives = {"counts": totals.coll_counts,
                   "bytes_by_kind": totals.coll_bytes_by_kind}
    if multi_pod is not None:
        # the part of them DTensor inserted where the program asked for none
        collectives.update(implicit_counts=totals.implicit_counts,
                           implicit_bytes_by_kind=totals.implicit_bytes_by_kind)
    return {
        **head,
        "optimized": optimized,
        "status": "ok",
        "device": device.type,
        "compile_s": round(time.time() - t0, 1),
        "memory": totals.memory,
        "collectives": collectives,
        "roofline": roof.to_dict(),
    }


def summary(rec: Dict) -> str:
    """The CLI's line for one record."""
    label = f"{rec['arch']} x {rec['shape']} x {rec.get('mesh', '1 card')}"
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
    ap.add_argument("--multi-pod", action="store_true",
                    help="count per device on the 2x16x16 (512-chip) mesh")
    ap.add_argument("--both-meshes", action="store_true",
                    help="each cell on the 16x16 and the 2x16x16 mesh")
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

    if args.both_meshes:
        meshes = [False, True]
    else:
        meshes = [True] if args.multi_pod else [None]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, multi_pod=mp, optimized=args.optimized,
                               tracer=tracer, device=args.device)
            except Exception as e:  # a failure here is a bug in the system
                failures += 1
                rec = {
                    "arch": arch, "shape": shape, "multi_pod": bool(mp),
                    **({} if mp is None else {"mesh": MESH_NAMES[mp]}),
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
