#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA
               versions; TF32 is turned off for matmuls and cuDNN.
  2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc,
               one process per source, all started together.
  3. kernel  — flash attention against its plain PyTorch version on the card
               at the serving shapes (qwen2-1.5b, zamba2-1.2b's shared
               block, granite-moe-3b-a800m's 24/8 heads at hd 64) and the
               repo's test shapes, with its time, the plain
               version's, SDPA's (a yardstick only) and the least time the
               card could take (bound_ms).  Each row names the kernel route
               its dtype takes: tensor_core_bf16 or cuda_core_f32.
  4. ssd     — the SSD scan kernel against its plain version at zamba2's
               prefill shape, ragged, and the repo's test shapes, in float32
               and bfloat16, with its time, the plain version's and its
               bound (no single PyTorch call computes it: library_ms null);
               in float32 both also stand beside the step recurrence
               (ref.ssd_ref) as a second witness.  The slice rows also time
               each of the kernel's five passes alone (pass_ms).
  5. serve   — per model (qwen2-1.5b, zamba2-1.2b, granite-moe-3b-a800m,
               falcon-mamba-7b) at full width and depth in bf16, seeded
               random weights, ServeEngine(slots=4, max_len=1088): 8
               requests of 1024 prompt tokens and 32 new tokens each.
               Launch counts are zeroed just before and read just after;
               each kernel of the model's path must run exactly once per
               layer (flash: per attention layer or shared-block
               application; ssd: per mamba2 layer) per admitted request,
               and a kernel off the path not at all (falcon-mamba's mamba1
               layers run none).
  6. parity  — after each model's serve phase, in float32: qwen2 and
               zamba2 with 2 requests (512 and 512 tokens for qwen2, 512
               and 500 for zamba2), 8 new tokens, with the kernels and
               with the plain torch paths: equal greedy tokens, prefill
               logits within 1e-3.  granite (2 x 512): at every layer both
               attention paths on the torch path's hidden state within
               1e-3; equal tokens and logits within 1e-3 wherever both
               paths route every token to the same experts, with the
               tokens whose experts differ counted (routing_flips).
               falcon-mamba (decode_check): one 512-token prompt, the
               prefill then one decode step against the full forward over
               513 tokens at the last position, within 2e-3.
  7. planner — the float64 planner (no custom kernel): boutique scenarios
               1-3 through GreenConstraintPipeline.run -> problem_for ->
               GreenScheduler.plan under the green, baseline and oracle
               profiles; synth(500, 200) dense at B=1 and B=8 and
               synth(2000, 200) sparse (one link per service), then the
               same shapes with 8 links per service, with dyadic inputs
               (every sum exact in any order) and with float inputs.
               Each problem is
               planned twice on the card (the sparse problems but the
               float fan-in one: once) and once on the CPU (the float
               fan-in problems, which repeat their dyadic twins' shapes,
               on the card only); per problem
               one line with S, F, N, L, B, backend, greedy and
               local-search steps, the warm (second) card plan's wall ms
               beside the CPU's, the placements that differ and both
               plans' objective, and for the float dense synthetic
               problems the idle share of one warm plan under
               torch.profiler (device trace only).  On the float fan-in
               problem the sparse move
               score is evaluated 8 times at the plan's state, with the
               planner's segment sum and with plain index_add_, and the
               distinct bit patterns of each are printed.  Fails when the
               two card runs differ, the planner's move score is not
               bitwise repeatable, a card plan breaks capacity, or card
               and CPU decide differently on boutique or a dyadic
               problem.
  8. continuum — the adaptive loop (ContinuumRuntime.run: pipeline.run ->
               problem_for -> fault masking -> WhatIfPlanner.evaluate over
               B forecast branches -> hysteresis switch -> accounting) on
               the card and on the CPU with the same inputs: (a) the
               continuum benchmark's paper-scale week (12 services, 6
               nodes over solar-south, wind-north and coal-east, 168
               ticks) under the adaptive, static and oracle policies;
               (b) the same week under a seeded fault trace (3 outages,
               a zone blackout, a telemetry dropout, a workload spike, a
               capacity derate) with an Observability bundle and an
               observe-mode Watchtower attached; (c) the benchmark's
               delta-replanning scale, 96 services on 48 nodes, B=4, 24
               ticks; the fan-in week: (a)'s adaptive week with 8 links
               into each service.  Per run one line: ticks, replans,
               switches, migrations, evictions, emergencies, violations,
               total emissions, the p50 and p95 of each tick's wall ms
               and of its replan ms on the card and on the CPU, the ticks
               whose records differ; then one more warm tick on the card
               under torch.profiler (device trace only): kernel ms,
               launches, idle share.  Fails when a non-timing TickRecord
               field or the final assignment differs between card and
               CPU, when (b) records a placement violation, when (b)'s
               ledger does not sum bit-equal to its records, or when
               (b)'s alerts differ between card and CPU.
  9. replay  — the fused trace replay (ContinuumRuntime.run_scanned: the
               trace staged on the host once, the decision tick rolled on
               the device) on the card and on the CPU: (d) (a)'s week
               under the adaptive and oracle policies; (e) the faulty week
               without the capacity derate (which the replay does not
               stage), observed, against an eager run of the same; and
               with it, on the CPU, which must fall back to the eager
               loop (FAULT_CAPACITY_DERATE) and equal (b); (f)
               monte_carlo_emissions over the adaptive week under 8 carbon
               scales (64 planner branches a tick), beside (d)'s adaptive
               replay for the marginal ms per reality per tick; (g) (c)'s
               mid-size; (h) the continuum benchmark's at-scale point in
               its smoke size, 300 services x 60 nodes, B=4, 4 ticks, on
               the card only; the fan-in week.  Per run one line: stage,
               scan and commit seconds, the scan's ms per tick beside the
               eager tick's, the ticks that differ from the eager run and
               between card and CPU, and (but (d) oracle's) a profile of
               a warm replay of its first ticks on the card (device trace
               only): launches
               per tick, kernel ms, idle share.  Fails when a replay falls
               back where it should not (or does not where it should),
               when a non-timing TickRecord field (``compiles`` aside: the
               replay books its own signature) or the final assignment
               differs from the eager run, when card and CPU differ, when
               (e)'s ledger or alerts differ from the eager run's, or when
               (f)'s totals differ card vs CPU, or at scale 1.0 from (a)'s
               adaptive week, by more than rel 1e-12.
 10. fleet   — the multi-tenant planner (fleet.plan_many: one
               plan_branches call per shape group and chunk, the apps on
               its row axis) and FleetRuntime, at
               benchmarks/fleet_scale.py's sizes: (a) 100 apps of
               to_dyadic(synth(50, 200, seed=1+i)) on the one shared
               infrastructure of seed 0, dense, priorities descending,
               its scheduler (emission weight 0.25, 2 local-search
               rounds), under the none, waterfill and price (4 rounds)
               couplings; each planned twice on the card and once on the
               CPU; (b) 1000 float apps of synth(50, 200), uncoupled, 4
               chunks of 256, twice on the card only; (c) its billing
               run (5 tenants of 3-5 services on 9 nodes, waterfill,
               Observability, 6 ticks) and the same tenants under
               FaultTrace.generate(seed=0, capacity_derates=1) for 24
               ticks, on the card and on the CPU.  Per plan one line:
               calls, padded apps, cold and warm card ms beside CPU ms,
               feasible apps, violated nodes, greedy and largest
               local-search steps, and a profile of one more warm card
               plan (device trace only; waterfill's covers the first 4
               apps of its order): launches, kernel ms, idle share.  Per
               run one line: switches, migrations, evictions, emergency
               ticks, bills, tick ms.  Fails when two card plans differ,
               card and CPU differ on (a) or (c), waterfill over-commits
               a node, a warm replan or tick records a compile miss, a
               bill differs from its tenant's plain sum of accounted
               ticks, a tick breaks capacity, or (c) under faults meets
               no emergency.
 11. green   — GreenPlacement (launch/green_placement.py) with
               device="cuda" and device="cpu": place on the four job sets
               of tests/test_green_placement.py, then run_continuum on
               tests/test_continuum.py's job set for 6 and 168 ticks.  Per
               run one line: placements, constraints, stats or the run's
               summary, wall ms on both.  Fails when a plan, a
               constraint, a stat, a tick record (timings and
               ``compiles`` aside) or the final assignment differs.

Then one line with each phase's seconds, one line {"kernels": [...]}, the
nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises, so the script exits
non-zero and prints no result; so does a run without a card or outside a
checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published dense peaks (NVIDIA data sheets) at each card's full power limit:
# bf16 tensor FLOP/s, float32 (non-tensor) FLOP/s, memory bytes/s.
CARDS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H100": (989e12, 67e12, 3.35e12),       # SXM, 80 GB HBM3
    "H200": (989e12, 67e12, 4.8e12),
}
FLASH = {
    "name": "flash_attention",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "replaces": "src/repro/kernels/flash_attention.py:129",
}
SSD = {
    "name": "ssd_scan",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "replaces": "src/repro/kernels/ssd_scan.py:122",
}
# the shape lists of tests/test_kernels.py: (B, S, H, KV, hd) and
# (B, S, nh, hp, n, chunk)
ATTN_SHAPES = [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64), (1, 192, 6, 1, 16),
               (2, 64, 4, 4, 128), (1, 512, 2, 2, 8)]
SSD_SHAPES = [(1, 64, 2, 16, 8, 32), (2, 128, 4, 32, 16, 64),
              (1, 200, 4, 16, 8, 64), (2, 96, 1, 64, 32, 32),
              (1, 256, 8, 8, 4, 256)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the flash kernel's route for each dtype (csrc/flash_attention.cu)
FLASH_ROUTE = {"bfloat16": "tensor_core_bf16", "float32": "cuda_core_f32"}
SSD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_peaks(name: str):
    for key, peaks in CARDS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}; known: {sorted(CARDS)}")


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed between two CUDA events, so the host's enqueue time
    (Python, ctypes, allocation) is not in the number."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / reps


def eager_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """ms per call of ``fn`` launched eagerly, as the model path launches
    it, between two CUDA events: the device time, or the host's enqueue
    time where that is longer."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def attention_bound_ms(B, Sq, Sk, H, KV, hd, causal, dtype, peaks) -> tuple:
    """(ms, "bytes"|"operations"): the larger of the bytes each input read
    once and the output written once over the memory rate, and the
    multiply-adds of QK^T and PV over the live (query, key) pairs over the
    peak rate for the input type."""
    import torch

    bf16_rate, f32_rate, mem_rate = peaks
    es = 2 if dtype == torch.bfloat16 else 4
    pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
    flops = 4.0 * B * H * hd * pairs
    nbytes = es * B * hd * (2 * Sq * H + 2 * Sk * KV)
    t_ops = flops / (bf16_rate if dtype == torch.bfloat16 else f32_rate)
    t_mem = nbytes / mem_rate
    return (1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes")


def ssd_chunked_flops(B, S, nh, hp, n, chunk) -> float:
    """FLOPs of the chunked SSD algorithm with nothing computed twice: per
    chunk of Qv steps, C.B^T over its Qv(Qv+1)/2 causal pairs (n each) once
    per batch, as every head shares B and C; per head, the weighted product
    over those pairs (hp each), C.h_prev and the state update (Qv hp n
    each)."""
    Q = min(chunk, S)
    macs = 0
    for c0 in range(0, S, Q):
        qv = min(Q, S - c0)
        pairs = qv * (qv + 1) // 2
        macs += pairs * n + nh * (pairs * hp + 2 * qv * hp * n)
    return 2.0 * B * macs


def ssd_bound_ms(B, S, nh, hp, n, dtype, peaks) -> tuple:
    """(ms, "bytes"|"operations", flops, bytes) for one SSD scan: the larger
    of the bytes each input read once and y, h written once (float32) over
    the memory rate, and the operations over the float32 rate (the function
    computes in float32 whatever its input type).  The operations are those
    of the step recurrence h = a h + dt x B^T, y = C.h: two multiply-adds
    per (step, head, p, n), the fewest of any known algorithm (the chunked
    form, ``ssd_chunked_flops``, adds its causal products to them)."""
    import torch

    _, f32_rate, mem_rate = peaks
    es = 2 if dtype == torch.bfloat16 else 4
    flops = 4.0 * B * S * nh * hp * n
    nbytes = es * B * S * (nh * hp + nh + 2 * n) + 4 * nh \
        + 4 * B * S * nh * hp + 4 * B * nh * hp * n
    t_ops, t_mem = flops / f32_rate, nbytes / mem_rate
    return (1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem else "bytes",
            flops, nbytes)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi, name, card_peaks(name)


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    per_source = build.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source)


def phase_kernel(peaks) -> tuple:
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for S in (1024, 1000):                    # the serving slice, and ragged
        for dt in ("bfloat16", "float32"):
            cases.append(((1, S, S, 12, 2, 128), True, dt, 1.0, "slice"))
    # zamba2-1.2b's shared attention block
    cases.append(((1, 1024, 1024, 32, 32, 64), True, "bfloat16", 1.0, "zamba2"))
    # granite-moe-3b-a800m's attention layers: GQA group 3
    for dt in ("bfloat16", "float32"):
        cases.append(((1, 1024, 1024, 24, 8, 64), True, dt, 1.0, "granite"))
    for (B, S, H, KV, hd) in ATTN_SHAPES:
        for dt in ("float32", "bfloat16"):
            for causal in (True, False):
                cases.append(((B, S, S, H, KV, hd), causal, dt, 1.0, "tests"))
    cases.append(((1, 96, 96, 2, 2, 16), True, "float32", 1.0, "S=96"))
    cases.append(((2, 64, 128, 4, 4, 32), False, "float32", 1.0, "cross"))
    cases.append(((1, 128, 128, 2, 2, 32), True, "float32", 8.0, "logits~40"))

    main_entry = zamba_entry = granite_entry = None
    for (B, Sq, Sk, H, KV, hd), causal, dt, scale, what in cases:
        dtype = getattr(torch, dt)
        q = (scale * torch.randn(B, Sq, H, hd, generator=gen, device=dev)).to(dtype)
        k = (scale * torch.randn(B, Sk, KV, hd, generator=gen, device=dev)).to(dtype)
        v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
        out = flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal=causal)
        tol = 1e-4 if what == "logits~40" else TOL[dt]
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol + tol * ref.float().abs()).all()) and \
            bool(torch.isfinite(out).all())
        row = dict(shape=[B, Sq, Sk, H, KV, hd], causal=causal, dtype=dt,
                   kernel_route=FLASH_ROUTE[dt], case=what, max_abs_err=err,
                   tol=tol, ok=ok)
        if what in ("slice", "zamba2", "granite"):
            row["ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal))
            row["eager_ms"] = eager_ms(lambda: flash_attention_cuda(q, k, v, causal=causal))
            row["plain_ms"] = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                B, Sq, Sk, H, KV, hd, causal, dtype, peaks)
            if what == "zamba2":
                zamba_entry = row
            elif what == "granite" and dt == "bfloat16":
                granite_entry = row
            elif what == "slice" and Sq == 1024 and dt == "bfloat16":
                main_entry = row
        emit("kernel", **row)
        if not ok:
            raise RuntimeError(f"flash_attention disagrees with its plain version: {row}")
    return main_entry, zamba_entry, granite_entry


def phase_ssd(peaks) -> dict:
    import math

    import torch

    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import (
        ALL_PASSES,
        PASSES,
        ssd_scan_cuda,
        ssd_scan_launcher,
        ssd_scan_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for S in (1024, 1000):                    # zamba2's prefill, and ragged
        for dt in ("float32", "bfloat16"):
            cases.append(((1, S, 64, 64, 64, 256), dt, "slice"))
    for shape in SSD_SHAPES:
        for dt in ("float32", "bfloat16"):
            cases.append((shape, dt, "tests"))

    main_entry = None
    for (B, S, nh, hp, n, chunk), dt, what in cases:
        dtype = getattr(torch, dt)
        x = torch.randn(B, S, nh, hp, generator=gen, device=dev)
        Bc = torch.randn(B, S, n, generator=gen, device=dev)
        Cc = torch.randn(B, S, n, generator=gen, device=dev)
        if what == "slice":
            # the model's ranges: softplus(dt_bias) in [1e-3, 1e-1] and
            # A = -exp(A_log) = -(1..nh), so dt*A reaches about -6 a step
            lo, hi = math.log(1e-3), math.log(1e-1)
            dts = torch.exp(lo + (hi - lo) * torch.rand(B, S, nh, generator=gen, device=dev))
            A = -torch.arange(1, nh + 1, dtype=torch.float32, device=dev)
        else:                                 # the inputs of tests/test_kernels.py
            dts = torch.nn.functional.softplus(
                torch.randn(B, S, nh, generator=gen, device=dev))
            A = -torch.exp(torch.randn(nh, generator=gen, device=dev))
        x, dts, Bc, Cc = (t.to(dtype) for t in (x, dts, Bc, Cc))
        y, h = ssd_scan_cuda(x, dts, A, Bc, Cc, chunk=chunk)
        torch.cuda.synchronize()
        yr, hr = ssd_scan_plain(x, dts, A, Bc, Cc, chunk=chunk)
        tol = SSD_TOL[dt]
        err, ok = 0.0, True
        for out, ref in ((y, yr), (h, hr)):
            diff = (out - ref).abs()
            err = max(err, float(diff.max()))
            ok = ok and bool((diff <= tol + tol * ref.abs()).all()) \
                and bool(torch.isfinite(out).all())
        row = dict(shape=[B, S, nh, hp, n, chunk], dtype=dt,
                   kernel_route="cuda_core_f32", case=what, max_abs_err=err,
                   tol=tol, ok=ok)
        if dt == "float32":
            # a second witness, not a check: the step recurrence takes no
            # cumulative sum, so where kernel and plain version share one's
            # float32 cancellation both stand apart from it alike
            yo, ho = ssd_ref(x, dts, A, Bc, Cc)
            for key, (yy, hh) in (("kernel_vs_oracle", (y, h)),
                                  ("plain_vs_oracle", (yr, hr))):
                row[key] = max(float((yy - yo).abs().max()),
                               float((hh - ho).abs().max()))
        if what == "slice":
            row["ms"] = cuda_ms(lambda: ssd_scan_cuda(x, dts, A, Bc, Cc, chunk=chunk))
            row["eager_ms"] = eager_ms(lambda: ssd_scan_cuda(x, dts, A, Bc, Cc, chunk=chunk))
            # each pass alone, on the buffers of one full run (every pass
            # reads only what the earlier ones wrote, so a repeat is exact)
            launch, _, _ = ssd_scan_launcher(x, dts, A, Bc, Cc, chunk=chunk)
            launch(ALL_PASSES)
            row["pass_ms"] = {name: cuda_ms(lambda bit=bit: launch(bit))
                              for name, bit in PASSES.items()}
            row["plain_ms"] = cuda_ms(lambda: ssd_scan_plain(x, dts, A, Bc, Cc, chunk=chunk))
            row["library_ms"] = None      # no single PyTorch call computes it
            row["bound_ms"], row["bound_by"], row["bound_flops"], row["bound_bytes"] = \
                ssd_bound_ms(B, S, nh, hp, n, dtype, peaks)
            row["chunked_flops"] = ssd_chunked_flops(B, S, nh, hp, n, chunk)
            if S == 1024 and dt == "float32":  # what the model path passes
                main_entry = row
        emit("ssd", **row)
        if not ok:
            raise RuntimeError(f"ssd_scan disagrees with its plain version: {row}")
    return main_entry


def _prompts(rng, n, length, vocab):
    return [rng.integers(0, vocab, size=length).astype("int64") for _ in range(n)]


def _rescale_attention(attn) -> None:
    """Scale one attention block's projections, stacked (L, ...) or not, from
    the reference init's 1/sqrt(shape[-2]) to 1/sqrt(contracted width)."""
    import math

    d, H, hd = attn["wq"].shape[-3:]
    KV = attn["wk"].shape[-2]
    attn["wq"].mul_(math.sqrt(H / d))
    attn["wk"].mul_(math.sqrt(KV / d))
    attn["wv"].mul_(math.sqrt(KV / d))
    attn["wo"].mul_(math.sqrt(hd / (H * hd)))


def _weights(cfg):
    """Seeded random float32 weights on the card, attention well conditioned.

    ``init_from_schema`` follows the JAX package and scales each weight by
    1/sqrt(shape[-2]).  For the head-structured projections that is the
    head count (qwen2 wq: 12, wk/wv: 2; zamba2's shared block: 32) or the
    head dim (wo: 128; zamba2: 64), not the contracted width, so at full
    width the q.k logits reach the hundreds, the softmax is saturated, and
    two summation orders of the same model part within a few layers:
    without the rescale the qwen2 parity phase fails (prefill logits 3.7
    apart, different tokens) while the kernel agrees with its plain
    version.  Rescaling the projections of every attention block (the
    stacked layers' and zamba2's shared one) to their contracted width
    keeps the parity phase a test of the kernels.
    """
    import torch

    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema

    params = init_from_schema(0, build_schema(cfg), torch.float32, "cuda")
    for group in ("layers", "shared"):
        if "attn" in params.get(group, {}):
            _rescale_attention(params[group]["attn"])
    return params


def _expected_launches(cfg, n_req: int) -> dict:
    """Launches of each kernel for ``n_req`` admitted requests: one per
    attention layer (or shared-block application) and per mamba2 layer."""
    from repro_torch.models.config import Family

    if cfg.family == Family.HYBRID:
        return {"flash_attention": n_req * (cfg.n_layers // cfg.shared_attn_period),
                "ssd_scan": n_req * cfg.n_layers}
    if cfg.family == Family.SSM:          # mamba1: no kernel on its path
        return {"flash_attention": 0, "ssd_scan": 0}
    return {"flash_attention": n_req * cfg.n_layers, "ssd_scan": 0}


def phase_serve(cfg) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.config import CellTuning
    from repro_torch.serve import EngineStats, Request, ServeEngine

    n_req, prompt_len, new_tokens = 8, 1024, 32
    # the engine casts the weights to bf16 once; the float32 draws go after
    engine = ServeEngine(cfg, _weights(cfg), slots=4, max_len=1088,
                         tuning=CellTuning(compute_dtype="bfloat16"))
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1)
    # warm-up: one request through prefill and decode, before the counts
    engine.submit(Request(-1, _prompts(rng, 1, prompt_len, cfg.vocab)[0],
                          max_new_tokens=2))
    engine.run_until_drained()
    engine.stats = EngineStats()
    reqs = [Request(i, p, max_new_tokens=new_tokens)
            for i, p in enumerate(_prompts(rng, n_req, prompt_len, cfg.vocab))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    stats = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expected = _expected_launches(cfg, n_req)

    toks = [t for r in reqs for t in r.generated]
    checks = {
        "all_finished": stats.finished == n_req and all(r.done for r in reqs),
        "all_lengths": all(len(r.generated) == new_tokens for r in reqs),
        "tokens_in_vocab": all(0 <= t < cfg.vocab for t in toks),
        "launches": launches == expected,
    }
    decode_ticks = stats.ticks
    emit("serve", arch=cfg.name, dtype="bfloat16", requests=n_req,
         prompt_len=prompt_len, new_tokens=new_tokens, slots=4, max_len=1088,
         launches=launches, expected_launches=expected,
         ticks=stats.ticks, decoded_tokens=stats.decoded_tokens,
         prefill_s=stats.prefill_s, decode_s=stats.decode_s, wall_s=wall,
         prefill_tok_s=stats.prefill_tokens / stats.prefill_s,
         decode_tok_s=stats.decoded_tokens / stats.decode_s,
         prefill_ms_per_request=1e3 * stats.prefill_s / n_req,
         decode_ms_per_tick=1e3 * stats.decode_s / decode_ticks,
         peak_mem_bytes=peak, checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"serve checks failed: {checks}")
    return launches


def phase_parity(cfg, prompt_lens) -> None:
    import numpy as np
    import torch

    from repro_torch.models.config import CellTuning
    from repro_torch.models.ops import ShardCtx
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train.steps import make_prefill_step

    params32 = _weights(cfg)
    rng = np.random.default_rng(2)
    prompts = [_prompts(rng, 1, n, cfg.vocab)[0] for n in prompt_lens]
    tokens, logits = {}, {}
    for impl in ("kernel", "torch"):
        engine = ServeEngine(cfg, params32, slots=2, max_len=max(prompt_lens) + 8,
                             tuning=CellTuning(compute_dtype="float32",
                                               attention_impl=impl, ssm_impl=impl))
        reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        tokens[impl] = [r.generated for r in reqs]
        step = make_prefill_step(cfg, ShardCtx(impl, impl))
        logits[impl] = torch.stack([
            step(engine.params, {"tokens": torch.as_tensor(p[None], device="cuda")})[0][0]
            for p in prompts])
        del engine
    err = float((logits["kernel"] - logits["torch"]).abs().max())
    checks = {"tokens_equal": tokens["kernel"] == tokens["torch"],
              "logits_within_1e-3": err <= 1e-3,
              "logits_finite": bool(torch.isfinite(logits["kernel"]).all())}
    emit("parity", arch=cfg.name, dtype="float32", requests=2,
         prompt_lens=list(prompt_lens),
         new_tokens=8, prefill_logits_max_abs_err=err, tol=1e-3,
         tokens=tokens["kernel"], checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"parity checks failed: {checks}")


def phase_parity_moe(cfg, prompt_lens) -> None:
    """The MoE model in float32, kernel path against torch path.  Gate 1: at
    every layer both attention paths take the torch path's hidden state and
    agree within 1e-3.  Gate 2 (where the two paths route every token of
    every layer to the same experts): equal greedy tokens and prefill
    logits within 1e-3.  Routing is a discontinuous function of its input,
    so each path's experts are recorded per router call and the tokens
    whose experts differ are counted (routing_flips)."""
    import numpy as np
    import torch

    from repro_torch.models import moe
    from repro_torch.models.config import CellTuning
    from repro_torch.models.model import TRAIN, attention_block
    from repro_torch.models.ops import ShardCtx
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train.steps import make_prefill_step

    params32 = _weights(cfg)
    rng = np.random.default_rng(2)
    prompts = [_prompts(rng, 1, n, cfg.vocab)[0] for n in prompt_lens]
    ctxs = {impl: ShardCtx(impl) for impl in ("kernel", "torch")}

    layer_err = [0.0] * cfg.n_layers                      # gate 1
    with torch.inference_mode():
        for p in prompts:
            h = params32["embed"][torch.as_tensor(p[None], device="cuda")]
            for i in range(cfg.n_layers):
                lp = {blk: {name: w[i] for name, w in ws.items()}
                      for blk, ws in params32["layers"].items()}
                outs = {impl: attention_block(lp["attn"], h, cfg, ctx, mode=TRAIN)[0]
                        for impl, ctx in ctxs.items()}
                layer_err[i] = max(layer_err[i], float(
                    (outs["kernel"] - outs["torch"]).abs().max()))
                y, _ = moe.moe_mlp(lp["moe"], outs["torch"], cfg, ctxs["torch"],
                                   with_aux=False)
                h = outs["torch"] + y

    route = moe._route
    routes, tokens, logits = {}, {}, {}
    for impl in ctxs:                                     # gate 2
        rec = routes[impl] = []

        def recording(*args, rec=rec, **kwargs):
            out = route(*args, **kwargs)
            rec.append(out[3].sort(dim=-1).values)        # experts per token
            return out

        moe._route = recording
        try:
            engine = ServeEngine(cfg, params32, slots=2, max_len=max(prompt_lens) + 8,
                                 tuning=CellTuning(compute_dtype="float32",
                                                   attention_impl=impl))
            reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
            for r in reqs:
                engine.submit(r)
            engine.run_until_drained()
            tokens[impl] = [r.generated for r in reqs]
            step = make_prefill_step(cfg, ctxs[impl])
            logits[impl] = torch.stack([
                step(engine.params, {"tokens": torch.as_tensor(p[None], device="cuda")})[0][0]
                for p in prompts])
            del engine
        finally:
            moe._route = route
    same_calls = len(routes["kernel"]) == len(routes["torch"])
    flips = sum(int((a != b).any(dim=-1).sum())
                for a, b in zip(routes["kernel"], routes["torch"]))
    routed = sum(a.shape[0] for a in routes["torch"])
    err = float((logits["kernel"] - logits["torch"]).abs().max())
    gate2 = same_calls and flips == 0
    checks = {"attention_layers_within_1e-3": max(layer_err) <= 1e-3,
              "router_calls_aligned": same_calls,
              "logits_finite": bool(torch.isfinite(logits["kernel"]).all()),
              "tokens_in_vocab": all(0 <= t < cfg.vocab for ts in tokens["kernel"]
                                     for t in ts)}
    if gate2:
        checks["tokens_equal"] = tokens["kernel"] == tokens["torch"]
        checks["logits_within_1e-3"] = err <= 1e-3
    emit("parity", arch=cfg.name, dtype="float32", requests=len(prompts),
         prompt_lens=list(prompt_lens), new_tokens=8,
         attention_layer_max_abs_err=max(layer_err),
         attention_layer_errs=layer_err, routing_flips=flips,
         routed_tokens=routed, router_calls=len(routes["torch"]),
         gate2_applies=gate2, prefill_logits_max_abs_err=err, tol=1e-3,
         tokens_equal=tokens["kernel"] == tokens["torch"],
         tokens=tokens["kernel"], checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"parity checks failed: {checks}")


def phase_decode_check(cfg, prompt_len=512) -> None:
    """An SSM model in float32 at full width: the prefill over one prompt,
    then one decode step, equals the training forward over the prompt and
    the decoded token at the last position within 2e-3 (the recurrent step
    against the scan, tests/test_models.py's tolerance).  No kernel runs."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import DECODE, PREFILL, TRAIN, forward

    params32 = _weights(cfg)
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(_prompts(rng, 1, prompt_len, cfg.vocab)[0][None],
                           device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        pre, cache, _ = forward(params32, cfg, {"tokens": toks}, mode=PREFILL)
        nxt = torch.argmax(pre[:, -1, : cfg.vocab], dim=-1)[:, None]
        dec, _, _ = forward(params32, cfg, {"tokens": nxt}, mode=DECODE, cache=cache)
        full, _, _ = forward(params32, cfg, {"tokens": torch.cat([toks, nxt], 1)},
                             mode=TRAIN)
    torch.cuda.synchronize()
    err = float((dec[:, -1] - full[:, -1]).abs().max())
    checks = {"decode_within_2e-3": err <= 2e-3,
              "finite": bool(torch.isfinite(full).all() and torch.isfinite(dec).all()),
              "no_kernel_launched": dict(LAUNCHES) == {"flash_attention": 0,
                                                       "ssd_scan": 0}}
    emit("decode_check", arch=cfg.name, dtype="float32", prompt_len=prompt_len,
         decode_vs_full_max_abs_err=err, tol=2e-3,
         logits_max_abs=float(full[:, -1].abs().max()),
         seconds=time.perf_counter() - t0, launches=dict(LAUNCHES), checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"decode check failed: {checks}")


# the planner phase: boutique's scenarios through the pipeline under each
# profile, and the scalability benchmark's synthetic problems at full size
PLANNER_PROFILES = ("green", "baseline", "oracle")
PLANNER_LS_ROUNDS = 2          # benchmarks/scheduler_scalability.py's rounds
PLANNER_B = 8
PLANNER_LINKS = 8              # links per service of the fan-in problems
SEGMENT_SUM_RUNS = 8


def _timed_plan(sched, problem, cuda: bool):
    import torch

    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = sched.plan(problem)
    if cuda:
        torch.cuda.synchronize()
    return result, 1e3 * (time.perf_counter() - t0)


def _decisions(result):
    """Everything two plans of one problem must agree on: placed, flavour
    and node per service, skipped services, feasibility, the failing
    service (in the notes), emissions."""
    import numpy as np

    return (np.asarray(result.placed).tobytes(),
            np.asarray(result.fcur).tobytes(),
            np.asarray(result.ncur).tobytes(),
            np.asarray(result.emissions_g).tobytes(),
            [(p.feasible, p.placements, p.skipped_services, p.notes)
             for p in result.plans])


def _differing_placements(a, b) -> int:
    """Services placed differently (or in one plan only), over branches."""
    return sum(len({p.service for p in set(pa.placements)
                    ^ set(pb.placements)})
               for pa, pb in zip(a.plans, b.plans))


def _capacity_ok(app, infra, result) -> bool:
    """Each feasible branch's plan, checked from its assignment alone:
    every mandatory service placed, node CPU and RAM within capacity."""
    must = {s.component_id for s in app.services if s.must_deploy}
    for plan in result.plans:
        if not plan.feasible:
            continue
        used = {}
        for p in plan.placements:
            req = app.service(p.service).flavour(p.flavour).requirements
            cpu, ram = used.get(p.node, (0.0, 0.0))
            used[p.node] = (cpu + req.cpu, ram + req.ram_gb)
        if not must <= {p.service for p in plan.placements}:
            return False
        for nid, (cpu, ram) in used.items():
            cap = infra.node(nid).capabilities
            if cpu > cap.cpu or ram > cap.ram_gb:
                return False
    return True


def _segment_sum_patterns(problem, result) -> dict:
    """Distinct bit patterns of the sparse move score, evaluated
    SEGMENT_SUM_RUNS times on the card at the plan's state: with the
    planner's segment sum, and with plain ``index_add_`` (float64
    atomics) in its place."""
    import hashlib
    from unittest import mock

    import torch

    from repro_torch.core import scheduler as sched

    low, dev = problem.lowering, torch.device("cuda")
    esrc, ef, edst, ek = (torch.tensor(a, device=dev)[None]
                          for a in low.comm.planner_args())
    static = torch.zeros((1, low.S, low.F, low.N), dtype=torch.float64,
                         device=dev)
    state = [torch.tensor(a, device=dev)
             for a in (result.placed, result.fcur, result.ncur)]

    def patterns() -> int:
        seen = set()
        for _ in range(SEGMENT_SUM_RUNS):
            score, _ = sched._sparse_move_score(static, esrc, ef, edst,
                                                ek, *state)
            seen.add(hashlib.sha256(score.cpu().numpy().tobytes()).digest())
        return len(seen)

    def atomic(size, index, values):
        return torch.zeros(size, dtype=values.dtype,
                           device=values.device).index_add_(0, index, values)

    ours = patterns()
    with mock.patch.object(sched, "_segment_sum", atomic):
        atomics = patterns()
    return {"planner": ours, "index_add": atomics}


def _plan_case(case, problem, make_cfg, inputs, exact, profile_it,
               segment_sums=False, cpu_twin=True, card_twice=True) -> dict:
    """Plan one problem twice (``card_twice``, else once) on the card and
    (``cpu_twin``) once on the CPU with the port; check the card's
    decisions against the CPU's (``exact``: any difference fails) and
    against capacity; time the last card call."""
    from repro_torch.core.scheduler import GreenScheduler, reference_objective
    from repro_torch.obs.profile import profile_window

    app, infra, comp, comm, cs = inputs
    card = GreenScheduler(make_cfg(), device="cuda")
    first, cold_ms = _timed_plan(card, problem, True)
    result, warm_ms = _timed_plan(card, problem, True) if card_twice \
        else (first, None)
    on_cpu, cpu_ms = _timed_plan(
        GreenScheduler(make_cfg(), device="cpu"), problem, False) \
        if cpu_twin else (None, None)
    st, low = result.stats, problem.lowering

    def objective(r):
        a = r.assignment(0)
        return reference_objective(app, infra, comp, comm, cs, make_cfg(), a)

    checks = {
        "card_runs_equal": _decisions(result) == _decisions(first),
        "capacity_ok": _capacity_ok(app, infra, result),
    }
    if not card_twice:
        del checks["card_runs_equal"]
    if cpu_twin:
        checks["card_equals_cpu"] = _decisions(result) == _decisions(on_cpu)
    row = dict(
        case=case, S=low.S, F=low.F, N=low.N,
        L=low.comm.n_links if low.comm.kind == "sparse" else None,
        B=result.B, backend=low.comm.kind, exact_inputs=exact,
        greedy_steps=st.greedy_steps,
        local_search_steps=list(st.local_search_steps),
        local_search_steps_cpu=(list(on_cpu.stats.local_search_steps)
                                if cpu_twin else None),
        cold_ms=cold_ms, warm_ms=warm_ms, cpu_ms=cpu_ms,
        feasible=[p.feasible for p in result.plans],
        emissions_g=[float(e) for e in result.emissions_g],
        differing_placements=(_differing_placements(result, on_cpu)
                              if cpu_twin else None),
        objective_card=objective(result) if result.plans[0].feasible else None,
        objective_cpu=(objective(on_cpu) if cpu_twin
                       and on_cpu.plans[0].feasible else None),
        checks=checks)
    if profile_it:
        t0 = time.perf_counter()
        prof = profile_window(case, lambda: card.plan(problem), 6)
        row.update(profiled_wall_ms=prof["wall_ms"],
                   device_kernel_ms=prof["kernel_ms"],
                   idle_share=prof["idle_share"], launches=prof["launches"],
                   top_kernels=prof["top"],
                   profile_s=time.perf_counter() - t0)
    if segment_sums:
        # the same check at the move score's bits, and what plain
        # index_add_ gives there (printed, not gated)
        bits = _segment_sum_patterns(problem, result)
        row["move_score_bit_patterns"] = bits
        checks["move_score_runs_equal"] = bits["planner"] == 1
    emit("planner", **row)
    must_hold = ["capacity_ok"] + ["card_runs_equal"] * card_twice
    if segment_sums:
        must_hold.append("move_score_runs_equal")
    if exact:
        must_hold.append("card_equals_cpu")
    if not all(checks[k] for k in must_hold):
        raise RuntimeError(f"planner checks failed on {case}: {checks}")
    return row


def phase_planner() -> list:
    """The port's planning path on the card at full size.

    Boutique scenarios 1-3 (the paper's case study, S=10) go through
    ``GreenConstraintPipeline.run`` -> ``problem_for`` ->
    ``GreenScheduler.plan`` under each profile.  The scalability
    benchmark's synthetic problems run at its sizes: synth(500, 200)
    dense at B=1 and B=8 (ci scaled per branch from the seed, an
    emission-weighted profile so the branches differ) and synth(2000,
    200) sparse.  These give each service one link, so each of the
    planner's communication sums has at most one non-zero term; the
    fan-in problems give each service PLANNER_LINKS links (four per
    (service, flavour), eight into each service).  Their dyadic twins
    (``to_dyadic``: every sum exact in any order) and their float
    versions run at the same shapes and backends; on the sparse float
    one the move score's bits are also compared over repeated
    evaluations.  The card must decide exactly as the CPU on boutique
    and the dyadic problems, and as itself everywhere."""
    import numpy as np

    from repro_torch.configs import boutique
    from repro_torch.configs.synth import synth, to_dyadic
    from repro_torch.core.lowering import ScenarioBatch
    from repro_torch.core.pipeline import GreenConstraintPipeline
    from repro_torch.core.problem import PlacementProblem
    from repro_torch.core.scheduler import SchedulerConfig

    rows = []
    for n in (1, 2, 3):
        app, infra, mon = boutique.scenario(n)
        pipe = GreenConstraintPipeline(device="cuda")
        out = pipe.run(app, infra, mon)
        problem = pipe.problem_for(out)
        inputs = (out.app, out.infra, out.computation, out.communication,
                  out.constraints)
        for prof in PLANNER_PROFILES:
            rows.append(_plan_case(
                f"boutique{n}_{prof}", problem, getattr(SchedulerConfig, prof),
                inputs, exact=True, profile_it=False))

    def rounds(cfg):
        cfg.local_search_rounds = PLANNER_LS_ROUNDS
        return cfg

    scale = np.random.default_rng(0).integers(4, 13, size=(PLANNER_B, 1)) / 8.0
    scale[0] = 1.0                  # branch 0 is the unscaled problem
    fanin = f"_fanin{PLANNER_LINKS}"
    for S, backend in ((500, "dense"), (2000, "sparse")):
        variants = [("", synth(S, 200), False),
                    (fanin + "_dyadic",
                     to_dyadic(synth(S, 200, links=PLANNER_LINKS)), True),
                    (fanin, synth(S, 200, links=PLANNER_LINKS), False)]
        for suffix, inputs, dyadic in variants:
            problem = PlacementProblem.build(*inputs, backend=backend)
            tag = f"synth{S}_{backend}{suffix}"
            # the float fan-in problem repeats its dyadic twin's shape:
            # the twin's CPU plan stands for both, so it is planned on the
            # card only; only the dense problems are profiled (a sparse
            # plan's profile, ~300k launches, takes over a minute); the
            # other two sparse problems are planned once on the card (a
            # timing repeat of ~5 s each, cut to make room for the fleet)
            rows.append(_plan_case(
                tag, problem, lambda: rounds(SchedulerConfig.green()),
                inputs, exact=dyadic,
                profile_it=not dyadic and backend == "dense",
                segment_sums=suffix == fanin and backend == "sparse",
                cpu_twin=suffix != fanin,
                card_twice=backend == "dense" or suffix == fanin))
            if backend == "dense":
                batch = problem.with_scenarios(ScenarioBatch(
                    ci=problem.lowering.ci[None, :] * scale))
                rows.append(_plan_case(
                    f"{tag}_b{PLANNER_B}", batch,
                    lambda: rounds(SchedulerConfig(emission_weight=0.25)),
                    inputs, exact=dyadic, profile_it=not dyadic,
                    cpu_twin=suffix != fanin))
    return rows


# the continuum phase: benchmarks/continuum_loop.py's scenarios, rebuilt
# here from the port alone
CONTINUUM_START = 24
CONTINUUM_WEEK = 168
CONTINUUM_REGIONS = ("solar-south", "wind-north", "coal-east")
CONTINUUM_POLICIES = (
    ("adaptive", dict(scenarios=8, hysteresis_g=30.0)),
    ("static", dict(replan_every=10 ** 9)),
    ("oracle", dict(oracle=True, hysteresis_g=0.0, horizon_h=1)),
)
CONTINUUM_MID = dict(n_services=96, nodes_per_region=16, B=4, ticks=24)
# benchmarks/continuum_loop.py::time_megaloop's at-scale point, --smoke size
CONTINUUM_AT_SCALE = dict(n_services=300, nodes_per_region=20, B=4, ticks=4)
CONTINUUM_FAN_IN = 8           # links into each service of the fan-in week
MC_SCALES = [1.0, 0.8, 0.9, 1.1, 1.2, 1.3, 0.7, 1.5]
REPLAY_PROFILE_TICKS = 4       # ticks of the profiled warm replay
TIMING_FIELDS = ("rebuild_s", "replan_s", "constraint_s", "tick_fused_s")


def continuum_scenario(n_services=12, nodes_per_region=2,
                       regions=CONTINUUM_REGIONS, links=None):
    """``benchmarks/continuum_loop.py::build_scenario``: a capacity-tight
    continuum where the clean capacity moves with the sun.  With
    ``links``, ``configs/synth.py``'s fan-in instead of its ring: link j
    (1..links) of service i goes to service ``i + 1 + (j - 1) * (S //
    links)`` (mod S), so every service has ``links`` links in and out;
    and "small" ranks first, so that the traffic the workload trace draws
    from each service's first flavour leaves the flavour the planner
    runs and the communication sums decide placements."""
    from repro_torch.core.types import (
        Application, CommunicationLink, Flavour, FlavourRequirements,
        Infrastructure, Node, NodeCapabilities, Service)

    order = ("small", "large") if links else ()
    services = tuple(
        Service(f"svc{i}", flavours=(
            Flavour("large", FlavourRequirements(cpu=2.0, ram_gb=4.0)),
            Flavour("small", FlavourRequirements(cpu=1.0, ram_gb=2.0)),
        ), flavours_order=order) for i in range(n_services))
    if links is None:
        edges = [(i, (i + 1) % n_services) for i in range(0, n_services, 2)]
    else:
        step = n_services // links
        edges = [(i, (i + 1 + (j - 1) * step) % n_services)
                 for i in range(n_services) for j in range(1, links + 1)]
    app = Application("continuum-bench", services, tuple(
        CommunicationLink(f"svc{i}", f"svc{z}") for i, z in edges))
    nodes = tuple(
        Node(f"{region}-{k}", region=region, cost_per_cpu_hour=0.5,
             capabilities=NodeCapabilities(cpu=5.0, ram_gb=24.0))
        for region in regions for k in range(nodes_per_region))
    return app, Infrastructure("continuum-bench", nodes)


def continuum_runtime(device, app, infra, ticks, config, observed=False):
    """A ContinuumRuntime whose pipeline and planner run on ``device``,
    over the benchmark's seeded traces, with a per-tick wall clock."""
    from repro_torch.continuum import (
        REGION_PRESETS, CarbonTrace, ContinuumRuntime, WhatIfPlanner,
        WorkloadTrace)
    from repro_torch.core.pipeline import GreenConstraintPipeline
    from repro_torch.core.scheduler import GreenScheduler, SchedulerConfig
    from repro_torch.obs import Observability, Watchtower

    rt = ContinuumRuntime(
        app, infra,
        CarbonTrace(REGION_PRESETS, hours=CONTINUUM_START + ticks + 25,
                    seed=0),
        WorkloadTrace(app, seed=0), config=config,
        pipeline=GreenConstraintPipeline(device=device),
        planner=WhatIfPlanner(GreenScheduler(
            SchedulerConfig(emission_weight=1.0), device=device)),
        obs=Observability() if observed else None,
        watch=Watchtower() if observed else None)
    walls = []
    tick = rt.tick

    def timed_tick(t):
        t0 = time.perf_counter()
        rec = tick(t)           # ends in host values: no sync needed
        walls.append(1e3 * (time.perf_counter() - t0))
        return rec

    rt.tick = timed_tick        # ContinuumRuntime.run calls self.tick
    return rt, walls


def _records(result):
    """Every TickRecord field but the wall-clock timings."""
    import dataclasses

    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in TIMING_FIELDS} for r in result.ticks]


def _percentiles(ms) -> list:
    import numpy as np

    return [float(np.percentile(ms, 50)), float(np.percentile(ms, 95))]


def continuum_case(case, app, infra, ticks, config, observed=False) -> dict:
    """Run one continuum case on the card and on the CPU; compare."""
    from repro_torch.obs.profile import profile_window

    runs = []
    for dev in ("cuda", "cpu"):
        rt, walls = continuum_runtime(dev, app, infra, ticks, config,
                                      observed)
        runs.append((rt, rt.run(CONTINUUM_START, ticks), walls))
    (rt, res, walls), (rt_c, res_c, walls_c) = runs
    recs, recs_c = _records(res), _records(res_c)
    s = res.summary()
    checks = {
        "records_equal": recs == recs_c,
        "final_assignment_equal":
            res.final_assignment == res_c.final_assignment,
    }
    row = dict(
        case=case, S=len(app.services), N=len(infra.nodes),
        B=config.scenarios if config.use_whatif and not config.oracle else 1,
        ticks=len(res.ticks), replans=s["replans"], switches=s["switches"],
        migrations=s["migrations"], restarts=s["restarts"],
        evictions=sum(r.evicted for r in res.ticks),
        emergencies=sum(r.emergency for r in res.ticks),
        violations=sum(r.violations for r in res.ticks),
        total_emissions_g=res.total_emissions_g,
        total_emissions_g_cpu=res_c.total_emissions_g,
        differing_ticks=[r["t"] for r, rc in zip(recs, recs_c) if r != rc],
        differing_fields=sorted({k for r, rc in zip(recs, recs_c)
                                 for k in r if r[k] != rc[k]}),
        tick_ms_p50_p95=_percentiles(walls),
        tick_ms_p50_p95_cpu=_percentiles(walls_c),
        replan_ms_p50_p95=_percentiles(
            [1e3 * r.replan_s for r in res.ticks]),
        replan_ms_p50_p95_cpu=_percentiles(
            [1e3 * r.replan_s for r in res_c.ticks]))
    if observed:
        em, mig = rt.obs.ledger.totals()
        entries = rt.obs.ledger.entries
        checks["no_violations"] = (rt.placement_violations == []
                                   and row["violations"] == 0)
        checks["ledger_equals_records"] = (
            len(entries) == len(res.ticks)
            and all(e.emissions_g == r.emissions_g
                    and e.migration_g == r.migration_g
                    for e, r in zip(entries, res.ticks))
            and em == sum(r.emissions_g for r in res.ticks)
            and mig == sum(r.migration_g for r in res.ticks))
        sig = [[(a.t, a.name, a.source, a.target, a.zone, a.value)
                for a in r.watch.alerts] for r in (rt, rt_c)]
        checks["alerts_equal"] = sig[0] == sig[1]
        row.update(ledger_total_g=em + mig, alerts=len(sig[0]),
                   fault_events=[(e.kind, e.target, e.start, e.hours)
                                 for e in config.faults.events])
    # what the replay phase holds its replays to, taken before the
    # profiled tick below adds to the ledger and the alerts
    eager = (res, walls, _ledger(rt) if observed else None,
             _alerts(rt) if observed else None)
    t_next = CONTINUUM_START + ticks
    prof = profile_window(case, lambda: rt.tick(t_next), 6)
    row.update(profiled_tick_wall_ms=prof["wall_ms"],
               device_kernel_ms=prof["kernel_ms"],
               idle_share=prof["idle_share"], launches=prof["launches"],
               top_kernels=prof["top"])
    row["checks"] = checks
    emit("continuum", **row)
    if not all(checks.values()):
        raise RuntimeError(f"continuum checks failed on {case}: {checks}")
    return eager


def phase_continuum() -> dict:
    """The port's adaptive loop on the card, against the port on the CPU.

    (a) the continuum benchmark's paper-scale week under the adaptive,
    static and oracle policies; (b) the same week under a seeded fault
    trace with observability and an observe-mode watchtower; (c) the
    benchmark's delta-replanning scale (96 services on 48 nodes, B=4); the
    fan-in week.  Returns each run's card (runtime, result, tick walls),
    which the replay phase holds its replays to."""
    from repro_torch.continuum import RuntimeConfig

    eager = {}
    app, infra = continuum_scenario()
    for policy, kw in CONTINUUM_POLICIES:
        eager[f"week_{policy}"] = continuum_case(
            f"week_{policy}", app, infra, CONTINUUM_WEEK, RuntimeConfig(**kw))
    eager["week_faults"] = continuum_case(
        "week_faults", app, infra, CONTINUUM_WEEK,
        faulty_config(infra, derates=True), observed=True)
    mid = CONTINUUM_MID
    app_m, infra_m = continuum_scenario(mid["n_services"],
                                        mid["nodes_per_region"])
    eager["mid"] = continuum_case(
        f"mid_{mid['n_services']}x{len(infra_m.nodes)}", app_m, infra_m,
        mid["ticks"], RuntimeConfig(scenarios=mid["B"], hysteresis_g=30.0))
    app_f, infra_f = continuum_scenario(links=CONTINUUM_FAN_IN)
    eager["week_fanin"] = continuum_case(
        f"week_fanin{CONTINUUM_FAN_IN}", app_f, infra_f, CONTINUUM_WEEK,
        RuntimeConfig(**dict(CONTINUUM_POLICIES)["adaptive"]))
    return eager


def faulty_config(infra, derates: bool):
    """The faulty week's configuration: FaultTrace.generate(seed=0) from
    tick 24, with one capacity derate or none."""
    from repro_torch.continuum import RuntimeConfig
    from repro_torch.faults import FaultTrace

    faults = FaultTrace.generate(
        [n.node_id for n in infra.nodes], CONTINUUM_REGIONS,
        ticks=CONTINUUM_START + CONTINUUM_WEEK, seed=0,
        earliest=CONTINUUM_START, capacity_derates=1 if derates else 0)
    return RuntimeConfig(scenarios=8, hysteresis_g=30.0, faults=faults,
                         emergency_replan=True)


def _decided(result):
    """:func:`_records` without ``compiles``: a replay books its own
    signature once where the eager loop books the planner's."""
    return [{k: v for k, v in r.items() if k != "compiles"}
            for r in _records(result)]


def _ledger(rt):
    """The ledger's entries, each tick's cells as a sorted list (the eager
    loop lists a switch's migration cells in its assignment's key order,
    the replay in service order)."""
    return [(e.t, e.emissions_g, e.migration_g, e.moved, e.flapped,
             sorted(e.cells())) for e in rt.obs.ledger.entries]


def _alerts(rt):
    return [(a.t, a.name, a.source, a.target, a.zone, a.value)
            for a in rt.watch.alerts]


def replay_case(case, app, infra, ticks, config, eager, observed=False,
                devices=("cuda", "cpu"), fallback=None,
                profile_ticks=REPLAY_PROFILE_TICKS) -> dict:
    """``run_scanned`` of one trace on each of ``devices``, checked against
    the eager run ``eager`` = (result, tick walls, ledger, alerts) and
    card against CPU; then a warm replay of the first ``profile_ticks``
    ticks on the card under the device-only profiler."""
    from repro_torch.obs.profile import profile_window

    runs = {}
    for dev in devices:
        rt, _ = continuum_runtime(dev, app, infra, ticks, config, observed)
        t0 = time.perf_counter()
        res = rt.run_scanned(CONTINUUM_START, ticks)
        runs[dev] = (rt, res, time.perf_counter() - t0)
    rt, res, wall = runs[devices[0]]
    res_e, walls_e, ledger_e, alerts_e = eager
    decided, decided_e = _decided(res), _decided(res_e)
    checks = {
        "fallback": all(r[0].last_scanned_fallback == fallback
                        for r in runs.values()),
        "replay_equals_eager": decided == decided_e,
        "final_assignment_equals_eager":
            res.final_assignment == res_e.final_assignment,
    }
    stage_s = sum(r.constraint_s for r in res.ticks)
    scan_s = sum(r.replan_s for r in res.ticks)
    row = dict(
        case=case, S=len(app.services), N=len(infra.nodes),
        B=config.scenarios if config.use_whatif and not config.oracle else 1,
        ticks=len(res.ticks), devices=list(devices),
        fallback=None if fallback is None else str(rt.last_scanned_fallback),
        replans=sum(r.replanned for r in res.ticks),
        switches=sum(r.switched for r in res.ticks),
        total_emissions_g=res.total_emissions_g,
        differing_ticks_vs_eager=[
            r["t"] for r, e in zip(decided, decided_e) if r != e],
        wall_s=wall,
        eager_tick_ms_mean=sum(walls_e) / len(walls_e) if walls_e else None)
    if fallback is None:
        row.update(stage_s=stage_s, scan_s=scan_s,
                   commit_s=wall - stage_s - scan_s,
                   scan_ms_per_tick=1e3 * scan_s / ticks,
                   replay_ms_per_tick=1e3 * wall / ticks)
    if len(runs) == 2:
        rt_c, res_c, wall_c = runs["cpu"]
        recs, recs_c = _records(res), _records(res_c)
        checks["card_equals_cpu"] = recs == recs_c
        checks["final_assignment_card_equals_cpu"] = (
            res.final_assignment == res_c.final_assignment)
        row.update(
            differing_ticks_card_vs_cpu=[
                r["t"] for r, c in zip(recs, recs_c) if r != c],
            wall_s_cpu=wall_c,
            stage_s_cpu=sum(r.constraint_s for r in res_c.ticks),
            scan_ms_per_tick_cpu=1e3 * sum(
                r.replan_s for r in res_c.ticks) / ticks)
    if observed:
        checks["ledger_equals_eager"] = _ledger(rt) == ledger_e
        checks["alerts_equal_eager"] = _alerts(rt) == alerts_e
        checks["no_violations"] = rt.placement_violations == []
        if len(runs) == 2:
            checks["ledger_card_equals_cpu"] = \
                _ledger(rt) == _ledger(runs["cpu"][0])
            checks["alerts_card_equal_cpu"] = \
                _alerts(rt) == _alerts(runs["cpu"][0])
        row.update(alerts=len(rt.watch.alerts),
                   evictions=sum(r.evicted for r in res.ticks),
                   emergencies=sum(r.emergency for r in res.ticks))
    if fallback is None and profile_ticks:
        rt_p, _ = continuum_runtime("cuda", app, infra, profile_ticks,
                                    config, observed)
        profiled = []
        prof = profile_window(case, lambda: profiled.append(
            rt_p.run_scanned(CONTINUUM_START, profile_ticks)), 6)
        scan_ms = 1e3 * sum(r.replan_s for r in profiled[0].ticks)
        row.update(profiled_ticks=profile_ticks,
                   profiled_wall_ms=prof["wall_ms"],
                   profiled_scan_ms=scan_ms,
                   device_kernel_ms=prof["kernel_ms"],
                   idle_share=prof["idle_share"],
                   scan_idle_share=1.0 - prof["kernel_ms"] / scan_ms,
                   launches=prof["launches"],
                   launches_per_tick=prof["launches"] / profile_ticks,
                   top_kernels=prof["top"])
    row["checks"] = checks
    emit("replay", **row)
    if not all(checks.values()):
        raise RuntimeError(f"replay checks failed on {case}: {checks}")
    return row


def replay_monte_carlo(app, infra, config, week) -> dict:
    """(f): monte_carlo_emissions over the week under MC_SCALES on the card
    and on the CPU.  ``week`` is (d)'s adaptive replay row: its total, and
    its stage and scan seconds, which time the same staged scan for one
    reality (run_scanned is the M = 1 case of the code), for the marginal
    device cost of one more carbon reality."""
    import numpy as np

    from repro_torch.continuum import monte_carlo_emissions

    totals, secs = {}, {}
    for dev in ("cuda", "cpu"):
        rt, _ = continuum_runtime(dev, app, infra, CONTINUUM_WEEK, config)
        t0 = time.perf_counter()
        totals[dev], _per_tick = monte_carlo_emissions(
            rt, CONTINUUM_START, CONTINUUM_WEEK, MC_SCALES)
        secs[dev] = time.perf_counter() - t0
    M = len(MC_SCALES)
    card, cpu = totals["cuda"], totals["cpu"]
    one = week["stage_s"] + week["scan_s"]
    checks = {
        "card_equals_cpu": bool(np.allclose(card, cpu, rtol=1e-12,
                                            atol=0.0)),
        "scale_1_equals_week": bool(np.isclose(
            card[0], week["total_emissions_g"], rtol=1e-12, atol=0.0)),
    }
    row = dict(
        case="monte_carlo_week", realities=M, scales=MC_SCALES,
        B=config.scenarios, branches_per_tick=M * config.scenarios,
        ticks=CONTINUUM_WEEK, totals_g=[float(x) for x in card],
        totals_g_cpu=[float(x) for x in cpu],
        week_total_g=week["total_emissions_g"],
        max_rel_card_vs_cpu=float(np.max(np.abs(card - cpu) / np.abs(cpu))),
        seconds_m8=secs["cuda"], seconds_m8_cpu=secs["cpu"],
        seconds_m1=one,
        marginal_ms_per_reality_per_tick=1e3 * (
            secs["cuda"] - one) / (M - 1) / CONTINUUM_WEEK,
        checks=checks)
    emit("replay", **row)
    if not all(checks.values()):
        raise RuntimeError(f"monte carlo checks failed: {checks}")
    return row


def phase_replay(eager) -> None:
    """The port's fused trace replay on the card, against the port's eager
    loop (the continuum phase's card runs) and against the replay on the
    CPU: runs (d)-(h) and the fan-in week."""
    from repro_torch.continuum import FallbackReason, RuntimeConfig

    app, infra = continuum_scenario()
    policies = dict(CONTINUUM_POLICIES)
    # the oracle replay is not profiled (cut to make room for the fleet)
    week = {policy: replay_case(                                   # (d)
        f"week_{policy}", app, infra, CONTINUUM_WEEK,
        RuntimeConfig(**policies[policy]), eager[f"week_{policy}"],
        profile_ticks=REPLAY_PROFILE_TICKS if policy == "adaptive" else 0)
        for policy in ("adaptive", "oracle")}
    # (e) without the derate, against an eager run of the same on the CPU
    # (the eager loop decides alike on both: the continuum phase)
    config = faulty_config(infra, derates=False)
    rt_e, walls_e = continuum_runtime("cpu", app, infra, CONTINUUM_WEEK,
                                      config, observed=True)
    res_e = rt_e.run(CONTINUUM_START, CONTINUUM_WEEK)
    replay_case("week_faults", app, infra, CONTINUUM_WEEK, config,
                (res_e, [], _ledger(rt_e), _alerts(rt_e)), observed=True)
    # the fallback replays the eager loop, which (b) ran on both devices
    replay_case("week_faults_derate", app, infra, CONTINUUM_WEEK,
                faulty_config(infra, derates=True), eager["week_faults"],
                observed=True, devices=("cpu",),
                fallback=FallbackReason.FAULT_CAPACITY_DERATE)
    replay_monte_carlo(app, infra, RuntimeConfig(**policies["adaptive"]),
                       week["adaptive"])                           # (f)
    mid = CONTINUUM_MID                                            # (g)
    app_m, infra_m = continuum_scenario(mid["n_services"],
                                        mid["nodes_per_region"])
    replay_case("mid", app_m, infra_m, mid["ticks"],
                RuntimeConfig(scenarios=mid["B"], hysteresis_g=30.0),
                eager["mid"], profile_ticks=2)
    at = CONTINUUM_AT_SCALE                                        # (h)
    app_a, infra_a = continuum_scenario(at["n_services"],
                                        at["nodes_per_region"])
    config = RuntimeConfig(scenarios=at["B"], hysteresis_g=30.0)
    rt_a, walls_a = continuum_runtime("cuda", app_a, infra_a, at["ticks"],
                                      config)
    res_a = rt_a.run(CONTINUUM_START, at["ticks"])
    replay_case(f"at_scale_{at['n_services']}x{len(infra_a.nodes)}", app_a,
                infra_a, at["ticks"], config, (res_a, walls_a, None, None),
                devices=("cuda",), profile_ticks=1)
    app_f, infra_f = continuum_scenario(links=CONTINUUM_FAN_IN)
    replay_case("week_fanin", app_f, infra_f, CONTINUUM_WEEK,
                RuntimeConfig(**policies["adaptive"]), eager["week_fanin"])


# the fleet phase: benchmarks/fleet_scale.py's first full point and its
# billing run, rebuilt here from the port alone
FLEET_APPS = 100               # fleet_scale's apps axis starts at 100
FLEET_SERVICES, FLEET_NODES = 50, 200
FLEET_LARGE = 1000             # its last point, planned on the card only
FLEET_PRICE_ROUNDS = 4
FLEET_PROFILE_PREFIX = 4       # apps of the profiled waterfill prefix
FLEET_TENANTS, FLEET_TICKS = 5, 6
FLEET_FAULT_TICKS = 24
FLEET_CARD = "cuda"


def fleet_scheduler(device):
    """fleet_scale's scheduler: a dyadic emission weight, 2 rounds."""
    from repro_torch.core.scheduler import GreenScheduler, SchedulerConfig

    return GreenScheduler(SchedulerConfig(emission_weight=0.25,
                                          local_search_rounds=2),
                          device=device)


def _timed_fleet(fleet, sched):
    import torch

    from repro_torch.fleet import plan_many

    cuda = torch.device(sched.device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan_many(fleet, sched)
    if cuda:
        torch.cuda.synchronize()
    return res, 1e3 * (time.perf_counter() - t0)


def _fleet_decided(res):
    """Everything two plans of one fleet must agree on: each app's
    decisions and plan, the capacity report, the stats but time and
    compiles."""
    stats = res.stats.to_dict()
    stats.pop("plan_time_s")
    stats.pop("compiles")
    return ([_decisions(r) for r in res.results],
            res.capacity.cpu_load.tobytes(), res.capacity.ram_load.tobytes(),
            res.emissions_g.tobytes(), stats)


def fleet_case(case, fleet, cpu_twin=True, profile=None,
               profile_it=True) -> dict:
    """Plan one fleet twice on the card and (``cpu_twin``) once on the
    CPU; the warm card plan must record no compile miss; with
    ``profile_it``, profile ``profile`` (a fleet, by default this one)
    planned once more."""
    from repro_torch.obs import metrics_scope
    from repro_torch.obs.profile import profile_window

    card = fleet_scheduler(FLEET_CARD)
    first, cold_ms = _timed_fleet(fleet, card)
    with metrics_scope() as warm:
        res, warm_ms = _timed_fleet(fleet, card)
    cap = res.capacity
    checks = {
        "card_runs_equal": _fleet_decided(res) == _fleet_decided(first),
        "warm_compiles_nothing": (warm.delta("planner.compile.misses") == 0
                                  and res.stats.compiles == 0),
    }
    if fleet.coupling == "waterfill":
        checks["no_overcommit"] = (cap.violations == 0
                                   and bool((cap.cpu_load <= cap.cpu_cap).all())
                                   and bool((cap.ram_load <= cap.ram_cap).all()))
    on_cpu = cpu_ms = None
    if cpu_twin:
        on_cpu, cpu_ms = _timed_fleet(fleet, fleet_scheduler("cpu"))
        checks["card_equals_cpu"] = \
            _fleet_decided(res) == _fleet_decided(on_cpu)
    low = fleet.apps[0].lowering
    ls = [r.stats.local_search_steps[0] for r in res.results]
    row = dict(
        case=case, coupling=fleet.coupling, S=low.S, F=low.F, N=low.N,
        backend=low.comm.kind, **res.stats.to_dict(),
        cold_ms=cold_ms, warm_ms=warm_ms, cpu_ms=cpu_ms,
        warm_ms_per_app=warm_ms / fleet.A,
        feasible_apps=int(res.feasible.sum()),
        violated_nodes=cap.violations,
        total_emissions_g=res.total_emissions_g,
        greedy_steps=res.results[0].stats.greedy_steps,
        max_local_search_steps=max(ls),
        local_search_steps_cpu_max=(
            max(r.stats.local_search_steps[0] for r in on_cpu.results)
            if cpu_twin else None))
    if profile_it and FLEET_CARD == "cuda":
        target = fleet if profile is None else profile
        prof = profile_window(case, lambda: _timed_fleet(target, card), 6)
        row.update(profiled_apps=target.A, profiled_wall_ms=prof["wall_ms"],
                   device_kernel_ms=prof["kernel_ms"],
                   idle_share=prof["idle_share"], launches=prof["launches"],
                   launches_per_app=prof["launches"] / target.A,
                   top_kernels=prof["top"])
    row["checks"] = checks
    emit("fleet", **row)
    if not all(checks.values()):
        raise RuntimeError(f"fleet checks failed on {case}: {checks}")
    return row


def fleet_tenants(n_tenants, ticks, device, faults=False):
    """fleet_scale's billing run: tenant i runs 3 + i % 3 services (two
    flavours, one link) on 9 shared nodes (16 CPUs, 64 GB) over three
    regions, waterfilled, priority descending, horizon 4 h."""
    from repro_torch.continuum import (
        REGION_PRESETS, CarbonTrace, RuntimeConfig, WorkloadTrace)
    from repro_torch.core.types import (
        Application, CommunicationLink, Flavour, FlavourRequirements,
        Infrastructure, Node, NodeCapabilities, Service)
    from repro_torch.faults import FaultTrace
    from repro_torch.fleet import FleetApp, FleetRuntime
    from repro_torch.obs import Observability

    def tenant_app(tag, n_services):
        return Application(tag, tuple(
            Service(f"{tag}-svc{i}", flavours=(
                Flavour("large", FlavourRequirements(cpu=2.0, ram_gb=4.0)),
                Flavour("small", FlavourRequirements(cpu=1.0, ram_gb=2.0))))
            for i in range(n_services)),
            (CommunicationLink(f"{tag}-svc0", f"{tag}-svc1"),))

    infra = Infrastructure("shared", tuple(
        Node(f"{r}-{k}", region=r, cost_per_cpu_hour=0.5,
             capabilities=NodeCapabilities(cpu=16.0, ram_gb=64.0))
        for r in CONTINUUM_REGIONS for k in range(3)))
    tenants = [FleetApp(f"tenant{i}", tenant_app(f"t{i}", 3 + i % 3),
                        WorkloadTrace(tenant_app(f"t{i}", 3 + i % 3),
                                      seed=i, noise=0.0),
                        priority=float(n_tenants - i))
               for i in range(n_tenants)]
    config = RuntimeConfig(horizon_h=4)
    if faults:
        config = RuntimeConfig(horizon_h=4, emergency_replan=True,
                               faults=FaultTrace.generate(
                                   [n.node_id for n in infra.nodes],
                                   CONTINUUM_REGIONS, ticks, seed=0,
                                   capacity_derates=1))
    return FleetRuntime(tenants, infra,
                        CarbonTrace(REGION_PRESETS, hours=ticks + 25, seed=7),
                        config=config, coupling="waterfill",
                        obs=Observability(), device=device)


def _fleet_run_records(res):
    return [{name: {k: v for k, v in dataclasses.asdict(r).items()
                    if k not in TIMING_FIELDS + ("compiles",)}
             for name, r in fr.records.items()} for fr in res.ticks]


def _plain_sum(values) -> float:
    """Left-to-right float sum: the ledger's order (Python's ``sum`` of
    floats compensates its rounding)."""
    total = 0.0
    for v in values:
        total += v
    return total


def fleet_runtime_case(case, ticks, faults=False) -> dict:
    """FleetRuntime.run of the billing tenants on the card and on the
    CPU: records, final assignments, ledgers and bills equal; each bill
    the plain sum of its tenant's accounted ticks; no tick over
    capacity."""
    from repro_torch.obs import billing_report

    runs = {}
    for dev in (FLEET_CARD, "cpu"):
        frt = fleet_tenants(FLEET_TENANTS, ticks, dev, faults)
        t0 = time.perf_counter()
        res = frt.run(0, ticks)
        runs[dev] = (frt, res, time.perf_counter() - t0)
    (frt, res, wall), (frt_c, res_c, wall_c) = runs[FLEET_CARD], runs["cpu"]
    bills = billing_report(frt.obs.ledger)
    recs = [r for fr in res.ticks for r in fr.records.values()]
    checks = {
        "records_equal": _fleet_run_records(res) == _fleet_run_records(res_c),
        "final_assignments_equal": {
            k: r.final_assignment for k, r in res.results.items()} == {
            k: r.final_assignment for k, r in res_c.results.items()},
        "ledger_equal": _ledger(frt) == _ledger(frt_c),
        "bills_equal": bills == billing_report(frt_c.obs.ledger),
        "bills_equal_accounted": all(
            bills[name]["total"] == _plain_sum(
                t.emissions_g + t.migration_g for t in r.ticks)
            for name, r in res.results.items()),
        "no_capacity_violation": (
            all(fr.violations == 0 and fr.planned_capacity.violations == 0
                for fr in res.ticks) and frt.placement_violations == []),
        "warm_ticks_compile_nothing": all(
            fr.compiles == 0 for fr in res.ticks[1:]),
    }
    if faults:
        checks["emergency_seen"] = any(r.emergency for r in recs)
    row = dict(
        case=case, tenants=FLEET_TENANTS, ticks=ticks,
        nodes=len(frt.infra.nodes),
        services=[len(fa.app.services) for fa in frt.apps],
        switches=sum(r.switched for r in recs),
        migrations=sum(r.migrations for r in recs),
        evictions=sum(r.evicted for r in recs),
        emergency_ticks=sum(any(r.emergency for r in fr.records.values())
                            for fr in res.ticks),
        total_emissions_g=res.total_emissions_g,
        billed_g={k: v["total"] for k, v in bills.items()},
        wall_s=wall, wall_s_cpu=wall_c,
        tick_ms_mean=1e3 * wall / ticks, tick_ms_mean_cpu=1e3 * wall_c / ticks,
        replan_ms_mean=1e3 * sum(
            next(iter(fr.records.values())).replan_s
            for fr in res.ticks) / ticks,
        replan_ms_mean_cpu=1e3 * sum(
            next(iter(fr.records.values())).replan_s
            for fr in res_c.ticks) / ticks,
        checks=checks)
    emit("fleet", **row)
    if not all(checks.values()):
        raise RuntimeError(f"fleet runtime checks failed on {case}: {checks}")
    return row


def phase_fleet() -> None:
    """The port's multi-tenant planner on the card: (a) fleet_scale's
    first full point, 100 dyadic apps of synth(50, 200) on one shared
    infrastructure, dense, under the none, waterfill and price couplings,
    card against CPU; (b) its last point's size, 1000 float apps in 4
    chunks of 256, uncoupled, on the card only; (c) its billing run, and
    the same tenants under faults, card against CPU."""
    from repro_torch.configs.synth import synth_fleet
    from repro_torch.core.problem import PlacementProblem
    from repro_torch.fleet import FleetProblem

    t0 = time.perf_counter()
    probs = tuple(PlacementProblem.build(*p, backend="dense") for p in
                  synth_fleet(FLEET_APPS, FLEET_SERVICES, FLEET_NODES,
                              dyadic=True))
    emit("fleet", case="build_dyadic", apps=len(probs),
         seconds=time.perf_counter() - t0)
    prio = tuple(float(FLEET_APPS - i) for i in range(FLEET_APPS))
    for coupling in ("none", "waterfill", "price"):             # (a)
        fleet = FleetProblem(apps=probs, priority=prio, coupling=coupling,
                             price_rounds=FLEET_PRICE_ROUNDS)
        # a waterfill plan launches ~4,000 kernels an app: its profile
        # covers the first apps of its order, which plan exactly as they
        # do in the whole fleet (the capacity they meet is untouched)
        prefix = FleetProblem(apps=probs[:FLEET_PROFILE_PREFIX],
                              priority=prio[:FLEET_PROFILE_PREFIX],
                              coupling=coupling) \
            if coupling == "waterfill" else None
        fleet_case(f"dyadic{FLEET_APPS}_{coupling}", fleet, profile=prefix)
    t0 = time.perf_counter()                                    # (b)
    large = tuple(PlacementProblem.build(*p, backend="dense") for p in
                  synth_fleet(FLEET_LARGE, FLEET_SERVICES, FLEET_NODES))
    emit("fleet", case="build_float", apps=len(large),
         seconds=time.perf_counter() - t0)
    # not profiled: (a)'s uncoupled profile covers the same program
    fleet_case(f"float{FLEET_LARGE}_none", FleetProblem(apps=large),
               cpu_twin=False, profile_it=False)
    fleet_runtime_case("billing", FLEET_TICKS)                  # (c)
    fleet_runtime_case("billing_faults", FLEET_FAULT_TICKS, faults=True)


# tests/test_green_placement.py's rooflines and job sets
GREEN_ROOF_TRAIN = {"compute_s": 1.2, "memory_s": 8.5, "collective_s": 3.9}
GREEN_ROOF_DECODE = {"compute_s": 0.0003, "memory_s": 0.035, "collective_s": 0.003}
GREEN_WEEK = (6, 168)          # run_continuum's ticks: the test's, a week


def green_cases():
    """The four placements of tests/test_green_placement.py (jobs, pods,
    traffic) and the job set of tests/test_continuum.py's run_continuum
    smoke."""
    from repro_torch.launch.green_placement import JobSpec, PodSpec, TrafficSpec

    jobs = [
        JobSpec("train-a", "yi-9b", "train_4k", {"perf": GREEN_ROOF_TRAIN}),
        JobSpec("prefill", "yi-9b", "prefill_32k",
                {"perf": {"compute_s": 0.37, "memory_s": 2.5,
                          "collective_s": 1.15}}, steps_per_h=900.0),
        JobSpec("decode", "yi-9b", "decode_32k", {"perf": GREEN_ROOF_DECODE},
                steps_per_h=3.6e6)]
    pods = [PodSpec("clean", "france", carbon=16.0, cost_per_chip_hour=1.3),
            PodSpec("mid", "finland", carbon=120.0, cost_per_chip_hour=1.1),
            PodSpec("dirty", "texas", carbon=410.0, cost_per_chip_hour=0.8)]
    traffic = [TrafficSpec("prefill", "decode", gb_per_h=7200.0),
               TrafficSpec("train-a", "prefill", gb_per_h=40.0)]
    full = [JobSpec(f"train-{i}", "yi-9b", "train_4k", {"perf": GREEN_ROOF_TRAIN})
            for i in range(5)] + [JobSpec("opt", "yi-9b", "train_4k",
                                          {"perf": GREEN_ROOF_TRAIN},
                                          must_deploy=False)]
    only = [PodSpec("only", "france", carbon=16.0)]
    places = {"avoids_dirty_pod": (jobs, pods, ()),
              "affinity_colocates": (jobs, pods, traffic),
              "fleet_full_infeasible": (full, only, ()),
              "fleet_full_drops_optional": (full[:4] + full[-1:], only, ())}
    roof = {"tuned": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5},
            "default": {"compute_s": 1.3, "memory_s": 2.6, "collective_s": 0.6}}
    week = ([JobSpec(f"job{i}", "yi-9b", "train_4k", roofline=roof,
                     flavours_order=("tuned", "default"), steps_per_h=100.0)
             for i in range(3)],
            [PodSpec("pod-ss", "solar-south"), PodSpec("pod-wn", "wind-north")],
            [TrafficSpec("job0", "job1", gb_per_h=20.0)])
    return places, week


def phase_green() -> None:
    """GreenPlacement (launch/green_placement.py) on the card and on the CPU:
    place on the four job sets, run_continuum for 6 ticks and a week.
    Placements, constraints and the three stats must be equal with no
    tolerance, and every tick record but its timings and ``compiles``."""
    from repro_torch.launch.green_placement import GreenPlacement

    places, week = green_cases()
    for case, args in places.items():
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[dev] = GreenPlacement(device=dev).place(*args)
            runs[dev] += (1e3 * (time.perf_counter() - t0),)
        (plan, out, stats, ms), (plan_c, out_c, stats_c, ms_c) = \
            runs["cuda"], runs["cpu"]
        checks = {"plan_equal": plan == plan_c,
                  "constraints_equal": list(out.constraints) == list(out_c.constraints),
                  "stats_equal": stats == stats_c}
        emit("green", case=case, jobs=len(args[0]), pods=len(args[1]),
             feasible=plan.feasible,
             placements=[(p.service, p.flavour, p.node) for p in plan.placements],
             skipped=list(plan.skipped_services),
             constraints=[(c.kind, list(c.key())) for c in out.constraints],
             stats=stats, wall_ms=ms, wall_ms_cpu=ms_c, checks=checks)
        if not all(checks.values()):
            raise RuntimeError(f"green placement checks failed on {case}: {checks}")
    for ticks in GREEN_WEEK:
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res = GreenPlacement(device=dev).run_continuum(*week, ticks=ticks)
            runs[dev] = (res, 1e3 * (time.perf_counter() - t0))
        (res, ms), (res_c, ms_c) = runs["cuda"], runs["cpu"]
        recs = [{k: v for k, v in r.items() if k != "compiles"} for r in _records(res)]
        recs_c = [{k: v for k, v in r.items() if k != "compiles"}
                  for r in _records(res_c)]
        checks = {"records_equal": recs == recs_c,
                  "final_assignment_equal":
                      res.final_assignment == res_c.final_assignment,
                  "ticks": len(res.ticks) == ticks}
        s = res.summary()
        emit("green", case=f"run_continuum_{ticks}", ticks=ticks,
             replans=s["replans"], switches=s["switches"],
             migrations=s["migrations"], total_emissions_g=res.total_emissions_g,
             total_emissions_g_cpu=res_c.total_emissions_g,
             wall_ms=ms, wall_ms_cpu=ms_c, tick_ms=ms / ticks,
             tick_ms_cpu=ms_c / ticks,
             differing_ticks=[r["t"] for r, rc in zip(recs, recs_c) if r != rc],
             checks=checks)
        if not all(checks.values()):
            raise RuntimeError(f"green placement checks failed on {ticks} ticks: {checks}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch under {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    from repro_torch.configs.registry import get_arch

    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0
        return out

    smi, name, peaks = timed("device", phase_device)
    timed("build", phase_build)
    flash, flash_zamba, flash_granite = timed("kernel", phase_kernel, peaks)
    ssd = timed("ssd", phase_ssd, peaks)

    launches = {}
    for arch, check, fn, arg in (
            ("qwen2-1.5b", "parity", phase_parity, (512, 512)),
            ("zamba2-1.2b", "parity", phase_parity, (512, 500)),
            ("granite-moe-3b-a800m", "parity", phase_parity_moe, (512, 512)),
            ("falcon-mamba-7b", "decode_check", phase_decode_check, 512)):
        cfg = get_arch(arch)
        launches[arch] = timed(f"serve {arch}", phase_serve, cfg)
        torch.cuda.empty_cache()
        timed(f"{check} {arch}", fn, cfg, arg)
        torch.cuda.empty_cache()
    timed("planner", phase_planner)
    eager = timed("continuum", phase_continuum)
    timed("replay", phase_replay, eager)
    timed("fleet", phase_fleet)
    timed("green", phase_green)
    emit("seconds", **seconds)

    entries = []
    for spec, row, also in ((FLASH, flash, {"at_zamba2": flash_zamba,
                                            "at_granite": flash_granite}),
                            (SSD, ssd, {})):
        per_path = {arch: n[spec["name"]] for arch, n in launches.items()}
        entry = dict(spec, launches=sum(per_path.values()),
                     launches_per_path=per_path, max_abs_err=row["max_abs_err"],
                     ms=row["ms"], plain_ms=row["plain_ms"],
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=row["library_ms"], shape=row["shape"],
                     dtype=row["dtype"], kernel_route=row["kernel_route"])
        if "pass_ms" in row:
            entry["pass_ms"] = row["pass_ms"]
        for key, at in also.items():
            entry[key] = {k: at[k] for k in (
                "shape", "dtype", "kernel_route", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")}
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
