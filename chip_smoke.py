#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py              every phase below
  python3 chip_smoke.py --kernels    phases 1 to 4 alone (device, build and
                                     the three kernels against their plain
                                     versions, timed)

Phases, each printing one JSON line:
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA
               versions; TF32 is turned off for matmuls and cuDNN.
  2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc,
               one process per source, all started together.
  3. kernel  — flash attention against its plain PyTorch version on the card
               at the serving shapes (qwen2-1.5b, zamba2-1.2b's shared
               block, granite-moe-3b-a800m's 24/8 heads at hd 64, and
               whisper-large-v3's 20/20 heads at hd 64 three ways: its
               encoder over 1536 frames and its cross-attention of 224
               prompt tokens over them, both non-causal, bf16 and the
               encoder also float32; its decoder self-attention over 224,
               causal; granite-4.0-h-small's NoPE layers, 32/8 heads of
               128 with scores times 1/128, causal over the long-doc
               cell's longest prompt, 12,288, and a ragged 6,000 in bf16
               and 2,048 in float32, checked in blocks of query rows past
               4,096 rows), causal slices of later query rows against every
               key (``q_offset``, as sequence-parallel attention calls it)
               and the repo's test shapes, with its time, the plain
               version's, SDPA's (a yardstick only) and the least time the
               card could take (bound_ms).  Each row names the kernel route
               its dtype takes: tensor_core_bf16 or cuda_core_f32.
  3b. decode — the decode attention kernel against its plain version
               (``attention_reference`` with ``kv_len``) on the card:
               granite-moe-3b-a800m's 24/8 heads at hd 64 at the
               benchmark's chat pool (256 slots of 2048) and long-prompt
               pool (48 of 4016, 30 live), each slot at a seeded live
               length drawn from the cell's traffic mix; qwen2's 12/2 at
               hd 128, whisper's 20/20 (self, and cross over the 1536
               frames with no kv_len), granite-4.0-h-small's 32/8 at hd
               128 with scores times 1/128 at the long-doc pool (32 slots
               of 12,800, all live, lengths drawn from the cell's traffic),
               the reduced twins' hd 16, float32
               and bfloat16, lengths 1 and Sk among them.  float32 within
               1e-5 (the same float32 arithmetic in another order of sums),
               bfloat16 within that plus one bf16 ulp of the larger value
               (each side rounds its float32 result once).  The two pool
               rows are timed with the plain version, SDPA under the same
               length mask (a yardstick only) and the least time of their
               live bytes; so is the long-doc pool row.
  4. ssd     — the SSD scan kernel against its plain version at zamba2's
               prefill shape, ragged, granite-4.0-h-small's (128 heads of
               64, d_state 128) at 2,048, 6,144 and 12,288 tokens, the
               long-doc cell's prompts (and 2,048 in bfloat16), and the
               repo's test shapes, in float32
               and bfloat16, with its time, the plain version's and its
               bound (no single PyTorch call computes it: library_ms null);
               in float32 both also stand beside the step recurrence
               (ref.ssd_ref) as a second witness.  The slice and long-doc
               rows also time each of the kernel's five passes alone
               (pass_ms); the long-doc rows also give the share of the
               bf16 roofline that the benchmark's ``ssd_scan_roofline``
               reads (its ``ssd_work`` at the configuration's bf16 size).
  5. serve   — per model (qwen2-1.5b, zamba2-1.2b, granite-moe-3b-a800m,
               falcon-mamba-7b, whisper-large-v3) at full width and depth
               in bf16, seeded random weights, ServeEngine(slots=4,
               max_len=1088): 8 requests of 1024 prompt tokens and 32 new
               tokens each; whisper at its published decoder context,
               max_len=448, with prompts of 224 (the half of it whisper
               gives its conditioning prompt) over the engine's zero
               frames (1536, the frontend a stub).
               Launch counts are zeroed just before and read just after;
               each kernel of the model's path must run exactly once per
               layer (flash: per attention layer or shared-block
               application, whisper's three per decoder layer: encoder,
               decoder self, cross; ssd: per mamba2 layer) per admitted
               request, and a kernel off the path not at all
               (falcon-mamba's mamba1 layers run none).
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
               513 tokens at the last position, within 2e-3.  whisper
               (nonzero biases, frames 0.02 N(0, 1) from a seeded
               generator, through serve_batch): 2 requests of 224 and 200
               tokens, 8 new tokens: encoder output and prefill logits
               within 1e-3, equal greedy tokens; and prefill + one decode
               step against the full forward within 2e-3.
  7. train   — after the model phases: (c) on qwen2-1.5b's seeded weights
               at full width (the training CLI's ``--full`` init, attention
               rescaled) and its first batch, ``loss_fn`` under no_grad in
               float32 with the kernel context and with TRAIN_CTX: within
               1e-4 relative, exactly 28 flash launches; (a) 6 steps of the
               CLI's full-width step (``launch.train.build``: float32,
               remat, 2 micro-batches, 8 x 512 tokens), per step loss,
               grad_norm, lr, ms, tokens/s and the model-FLOP share of the
               float32 peak (8 N tokens: forward, backward, remat forward),
               peak memory, then one more step under torch.profiler
               (device trace only); (b) the same weights in bfloat16
               compute for 3 steps and one profiled, step-0 loss within
               2e-2 relative of (a)'s; (c) again at zamba2's reduced twin (ssd and flash
               counted); (d) every registry arch's reduced twin, 3 steps on
               the card and on the CPU from the same weights: loss within
               1e-5 relative, grad_norm within 1e-4, MoE routing flips
               counted (no comparison from the first flip on); (e) reduced
               qwen2 for 12 steps through RestartManager (a checkpoint
               every 4, a failure injected at step 6) against an
               uninterrupted run: final params and optimizer state within
               1e-6 (bit-equality printed).  Fails on a non-finite loss, a
               leaf that did not move in (a), or any flash or ssd launch in
               a train step.
  8. planner — the float64 planner (no custom kernel): boutique scenarios
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
  9. continuum — the adaptive loop (ContinuumRuntime.run: pipeline.run ->
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
 10. replay  — the fused trace replay (ContinuumRuntime.run_scanned: the
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
 11. fleet   — the multi-tenant planner (fleet.plan_many: one
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
 12. green   — GreenPlacement (launch/green_placement.py) with
               device="cuda" and device="cpu": place on the four job sets
               of tests/test_green_placement.py, then run_continuum on
               tests/test_continuum.py's job set for 6 and 168 ticks.  Per
               run one line: placements, constraints, stats or the run's
               summary, wall ms on both.  Fails when a plan, a
               constraint, a stat, a tick record (timings and
               ``compiles`` aside) or the final assignment differs.
 13. dryrun  — the launch layer's dry run (launch/dryrun.py: each cell's
               step run on fake tensors of its full shapes, nothing
               allocated, its FLOPs, bytes and memory counted and turned
               into the H100's roofline): (a) run_cell on fakes on the card
               for every registry arch x the serving shapes (prefill_32k,
               decode_32k, long_500k); the train_4k cells are left to the
               CLI, since one takes minutes to count (8 micro-batches with
               remat through FakeTensorMode, operator by operator).  Per
               cell one line: status or the skip reason, the fake peak and
               whether it fits in 80 GB, the three roofline terms, the
               bottleneck, the counting seconds.  (b) falcon-mamba-7b x decode_32k and
               zamba2-1.2b x long_500k, which fit on the card: one real
               serve step with the plan's dtypes (seeded weights, a zero
               cache, seeded tokens), its FLOPs counted on the real tensors
               by FlopCounterMode against the fake count (exactly equal),
               torch.cuda.max_memory_allocated against the fake peak
               (within 5% or 0.5 GB, whichever is larger), its ms (3 warm
               steps between CUDA events) beside the roofline's largest
               term.  (c) GreenPlacement fed with (a)'s records, built into
               JobSpec.roofline as examples/green_deployment.py's
               roofline_lookup builds them (a "perf" flavour and a 0.55x
               "eco" one): placements, constraints and stats on the card
               equal to the CPU's.  Fails when a cell errs, a skip reason
               is not cell_is_supported's, or a check of (b) or (c) fails.
 14. mesh    — multi-device sharding (launch/mesh.py, DTensor) with one
               card, each part in a child process (one default process
               group a process: ``chip_smoke.py --mesh-child PART``): (a)
               the same 30 cells counted per device on the 16x16 mesh in
               a fake world of 256 ranks, on CUDA fakes and on CPU fakes
               (three children per fakes' device, a third of the archs
               each, one thread each, all started after every timed
               phase so that they slow none); per cell one line: per-device
               FLOPs, bytes, fake peak and whether it fits in 80 GB, the
               collectives by kind (those DTensor inserted on its own
               apart), the three terms, the bottleneck, the counting
               seconds and the replication factor (per-device FLOPs x 256
               over the dryrun phase's one-card count).  (b) rank 0 of
               that world runs yi-6b's and zamba2-1.2b's prefill_32k step
               on real CUDA shards (seeded; the fake collectives leave
               their outputs unwritten, so no value is checked): the FLOPs
               of its local operators (launch.cost.LocalFlopCounter) equal the fake
               count, its peak is within 5% or 0.5 GB of the fake peak,
               each kernel launches as often as the count calls its
               operator; ms a step beside the terms.  (c) a real 1x1 NCCL
               mesh: qwen2-1.5b at full width in bf16 with DTensor
               parameters and the sharded context, a prefill and a
               decode step through the kernel route against the
               unsharded port: logits equal bit for bit, the same flash
               launches, wall ms of both.  (d) each kernel at the
               per-device arguments the count recorded in (b)'s steps,
               through its wrapper, element by element against its plain
               version (flash's over query slices of 4,096 rows, each
               with its causal offset): device ms, plain ms, bound, SDPA
               ms.  Fails when a count differs card vs CPU, a cell's
               status or skip reason is not cell_is_supported's, an ok
               cell moves no collective byte, or a check of (b), (c) or
               (d) fails.

Then one line with each phase's seconds, one line {"kernels": [...]} (each
kernel's ``launches_per_path`` also counts the train steps' launches under
"train": none, and the mesh phase's under "mesh"), the
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

FLASH = {
    "name": "flash_attention",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "replaces": "src/repro/kernels/flash_attention.py:129",
}
DECODE = {
    "name": "decode_attention",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "replaces": None,
}
SSD = {
    "name": "ssd_scan",
    "route": "cuda",
    "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "replaces": "src/repro/kernels/ssd_scan.py:122",
}
# LAUNCHES where no kernel ran
NO_LAUNCHES = {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
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
# granite-4.0-h-small's attention scores: times ``attention_multiplier``
# (1/128, not 1/sqrt(128)); its q and k drawn LONG_DOC_QK times a standard
# normal, so the scores have unit variance, as the benchmark's weights give
LONG_DOC_SCALE = 0.0078125
LONG_DOC_QK = 128 ** 0.25
# query rows per block where the plain version of a long attention is
# checked block by block (its full float32 score matrix would not fit)
PLAIN_ROWS = 1024


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def attention_bound(B, Sq, Sk, H, KV, hd, causal, dtype, peaks,
                    q_offset: int = 0) -> tuple:
    """(ms, "bytes"|"operations"): the benchmark's least time of one
    attention call (``portbench.yardstick.bounds.attention_bound_s``) and
    which of ``attention_work``'s two terms sets it."""
    from portbench.yardstick.bounds import attention_bound_s, attention_work

    es = dtype.itemsize
    flops, nbytes = attention_work(B, Sq, Sk, H, KV, hd, causal, es, q_offset)
    rate = peaks.bf16_flops if es == 2 else peaks.f32_flops
    by = "operations" if flops / rate >= nbytes / peaks.mem_bytes else "bytes"
    return 1e3 * attention_bound_s(B, Sq, Sk, H, KV, hd, causal, es, peaks, q_offset), by


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

    from portbench.yardstick.peaks import card_peaks

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


# the kernel rows timed beside the main one (qwen2's bf16 row), by the key
# each takes in the kernels line
FLASH_AT = {"at_zamba2": ("zamba2", "bfloat16"), "at_granite": ("granite", "bfloat16"),
            "at_whisper_encoder": ("whisper_encoder", "bfloat16"),
            "at_whisper_cross": ("whisper_cross", "bfloat16"),
            "at_whisper_self": ("whisper_self", "bfloat16"),
            "at_long_doc": ("long_doc", "bfloat16")}


def phase_kernel(peaks) -> tuple:
    import torch

    from repro_torch.kernels.flash_attention import attention_reference, flash_attention_cuda

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
    # whisper-large-v3's encoder (non-causal over the 1536 frames), its
    # cross-attention (224 prompt tokens over the frames) and its decoder
    # self-attention: 20/20 heads, hd 64
    for dt in ("bfloat16", "float32"):
        cases.append(((1, 1536, 1536, 20, 20, 64), False, dt, 1.0, "whisper_encoder"))
    cases.append(((1, 224, 1536, 20, 20, 64), False, "bfloat16", 1.0, "whisper_cross"))
    cases.append(((1, 224, 224, 20, 20, 64), True, "bfloat16", 1.0, "whisper_self"))
    # granite-4.0-h-small's NoPE layers at the long-doc cell's longest
    # prompt, a ragged one, and the float32 route
    cases.append(((1, 12288, 12288, 32, 8, 128), True, "bfloat16", LONG_DOC_QK, "long_doc"))
    cases.append(((1, 6000, 6000, 32, 8, 128), True, "bfloat16", LONG_DOC_QK,
                  "long_doc_ragged"))
    cases.append(((1, 2048, 2048, 32, 8, 128), True, "float32", LONG_DOC_QK,
                  "long_doc_f32"))
    for (B, S, H, KV, hd) in ATTN_SHAPES:
        for dt in ("float32", "bfloat16"):
            for causal in (True, False):
                cases.append(((B, S, S, H, KV, hd), causal, dt, 1.0, "tests"))
    cases.append(((1, 96, 96, 2, 2, 16), True, "float32", 1.0, "S=96"))
    cases.append(((2, 64, 128, 4, 4, 32), False, "float32", 1.0, "cross"))
    cases.append(((1, 128, 128, 2, 2, 32), True, "float32", 8.0, "logits~40"))
    # a causal slice of later query rows against every key, its mask
    # starting at the slice's first row (a shard of a sequence-sharded q)
    offsets = {"q_slice": 768, "q_slice_ragged": 450}
    # the scores' factor where it is not 1/sqrt(hd)
    softmax_scales = {"long_doc": LONG_DOC_SCALE, "long_doc_ragged": LONG_DOC_SCALE,
                      "long_doc_f32": LONG_DOC_SCALE}
    for dt in ("bfloat16", "float32"):
        cases.append(((1, 256, 1024, 12, 2, 128), True, dt, 1.0, "q_slice"))
        cases.append(((1, 100, 1000, 12, 2, 128), True, dt, 1.0, "q_slice_ragged"))

    timed = {case for case, _ in FLASH_AT.values()} | {"slice", "granite", "long_doc_f32"}
    main_entry, at = None, {}
    for (B, Sq, Sk, H, KV, hd), causal, dt, scale, what in cases:
        dtype = getattr(torch, dt)
        q = (scale * torch.randn(B, Sq, H, hd, generator=gen, device=dev)).to(dtype)
        k = (scale * torch.randn(B, Sk, KV, hd, generator=gen, device=dev)).to(dtype)
        v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
        off, sm = offsets.get(what, 0), softmax_scales.get(what)
        out = flash_attention_cuda(q, k, v, causal=causal, q_offset=off, scale=sm)
        torch.cuda.synchronize()
        if Sq > 4 * PLAIN_ROWS:               # causal, square: rows in blocks
            ref = torch.cat([attention_reference(
                q[:, r:r + PLAIN_ROWS], k, v, causal=True, q_offset=r, scale=sm)
                for r in range(0, Sq, PLAIN_ROWS)], dim=1)
        else:
            ref = attention_reference(q, k, v, causal=causal, q_offset=off, scale=sm)
        tol = 1e-4 if what == "logits~40" else TOL[dt]
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= tol + tol * ref.float().abs()).all()) and \
            bool(torch.isfinite(out).all())
        row = dict(shape=[B, Sq, Sk, H, KV, hd], causal=causal, dtype=dt,
                   kernel_route=FLASH_ROUTE[dt], case=what, max_abs_err=err,
                   tol=tol, ok=ok)
        if off:
            row["q_offset"] = off
        if sm is not None:
            row["scale"] = sm
        del ref, diff
        if what in timed:
            row["ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal, scale=sm))
            row["eager_ms"] = eager_ms(
                lambda: flash_attention_cuda(q, k, v, causal=causal, scale=sm))
            # past 4 blocks of rows the plain version's scores would not fit
            row["plain_ms"] = None if Sq > 4 * PLAIN_ROWS else cuda_ms(
                lambda: attention_reference(q, k, v, causal=causal, scale=sm))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True, scale=sm))
            row["bound_ms"], row["bound_by"] = attention_bound(
                B, Sq, Sk, H, KV, hd, causal, dtype, peaks)
            for key, case in FLASH_AT.items():
                if (what, dt) == case:
                    at[key] = row
            if what == "slice" and Sq == 1024 and dt == "bfloat16":
                main_entry = row
        emit("kernel", **row)
        if not ok:
            raise RuntimeError(f"flash_attention disagrees with its plain version: {row}")
    return main_entry, at


def _live_lengths(rng, pool, live, max_len, prompt, output):
    """``pool`` slots' kv_len: ``live`` of them at a prompt drawn from the
    mix (lognormal (median, sigma, lo, hi) or uniform (lo, hi)) plus a
    uniform share of an output drawn likewise, the rest free (1)."""
    import numpy as np

    def draw(spec, n):
        if spec[0] == "lognormal":
            _, med, sig, lo, hi = spec
            return np.clip(np.round(med * np.exp(sig * rng.standard_normal(n))), lo, hi)
        return rng.integers(spec[1], spec[2] + 1, size=n)

    lens = np.ones(pool, np.int64)
    pos = draw(prompt, live) + np.floor(rng.random(live) * draw(output, live))
    lens[:live] = np.minimum(pos + 1, max_len)
    return lens[rng.permutation(pool)]


# (case, B, Sk, H, KV, hd, dtype, kv_len): the three benchmark pools (lengths
# drawn from their cells' traffic) are timed; long-doc's scores take
# LONG_DOC_SCALE
DECODE_CASES = [
    ("chat", 256, 2048, 24, 8, 64, "bfloat16",
     ("live", 256, ("lognormal", 256, 0.6, 64, 1024), ("lognormal", 384, 0.5, 128, 1024))),
    ("long_prompt", 48, 4016, 24, 8, 64, "bfloat16",
     ("live", 30, ("lognormal", 2048, 0.5, 512, 3968), ("uniform", 8, 48))),
    ("chat", 256, 2048, 24, 8, 64, "float32", "ragged"),
    ("qwen2", 4, 1088, 12, 2, 128, "bfloat16", "ragged"),
    ("qwen2", 4, 1088, 12, 2, 128, "float32", "ragged"),
    ("whisper_self", 4, 448, 20, 20, 64, "bfloat16", "ragged"),
    ("whisper_cross", 4, 1536, 20, 20, 64, "bfloat16", None),
    ("whisper_cross", 4, 1536, 20, 20, 64, "float32", None),
    ("zamba2", 4, 1088, 32, 32, 64, "bfloat16", "ragged"),
    ("long_doc", 32, 12800, 32, 8, 128, "bfloat16",
     ("live", 32, ("lognormal", 6144, 0.5, 2048, 12288), ("lognormal", 192, 0.5, 64, 512))),
    ("long_doc", 32, 12800, 32, 8, 128, "float32", "ragged"),
    ("twin", 3, 48, 4, 2, 16, "float32", "ragged"),
    ("twin", 3, 48, 4, 4, 16, "float32", "ragged"),
]


def bf16_ulp(x):
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    import torch

    a = x.abs().float().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def decode_close(out, ref) -> tuple:
    """(max abs error, ok): float32 within 1e-5 absolute and relative;
    bfloat16 within that plus one ulp of the larger of the two values."""
    import torch

    diff = (out.float() - ref.float()).abs()
    lim = 1e-5 + 1e-5 * ref.float().abs()
    if out.dtype == torch.bfloat16:
        lim = lim + bf16_ulp(torch.maximum(out.float().abs(), ref.float().abs()))
    return float(diff.max()), bool((diff <= lim).all()) and bool(torch.isfinite(out).all())


def phase_decode(peaks) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import attention_reference

    def plain(q, k, v, kv_len, sm):
        return attention_reference(q, k, v, causal=False, kv_len=kv_len, scale=sm)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    bf16_rate, f32_rate, mem_rate = peaks
    timed = {}
    for what, B, Sk, H, KV, hd, dt, how in DECODE_CASES:
        dtype = getattr(torch, dt)
        sm, mag = (LONG_DOC_SCALE, LONG_DOC_QK) if what == "long_doc" else (None, 1.0)
        q = (mag * torch.randn(B, 1, H, hd, generator=gen, device=dev)).to(dtype)
        k = (mag * torch.randn(B, Sk, KV, hd, generator=gen, device=dev)).to(dtype)
        v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
        if how is None:
            lens = np.full(B, Sk)
            kv_len = None
        else:
            if how == "ragged":            # 1 and Sk among them
                lens = rng.integers(1, Sk + 1, size=B)
                lens[0], lens[-1] = 1, Sk
            else:
                lens = _live_lengths(rng, B, how[1], Sk, how[2], how[3])
            kv_len = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        out = decode_attention_cuda(q, k, v, kv_len, sm)
        torch.cuda.synchronize()
        ref = plain(q, k, v, kv_len, sm)
        err, ok = decode_close(out, ref)
        row = dict(case=what, shape=[B, 1, Sk, H, KV, hd], dtype=dt,
                   kernel_route="flash_decode_f32_math", kv_len_mean=float(lens.mean()),
                   kv_len_min=int(lens.min()), kv_len_max=int(lens.max()),
                   max_abs_err=err, ok=ok)
        if sm is not None:
            row["scale"] = sm
        if how is not None and how[0] == "live":
            tokens = int(lens.sum())
            es = 2 if dtype == torch.bfloat16 else 4
            t_ops = 4.0 * H * hd * tokens / (bf16_rate if es == 2 else f32_rate)
            t_mem = es * hd * (2 * KV * tokens + 2 * H * B) / mem_rate
            row["live_tokens"] = tokens
            row["bound_ms"] = 1e3 * max(t_ops, t_mem)
            row["bound_by"] = "operations" if t_ops >= t_mem else "bytes"
            row["ms"] = cuda_ms(lambda: decode_attention_cuda(q, k, v, kv_len, sm))
            row["eager_ms"] = eager_ms(lambda: decode_attention_cuda(q, k, v, kv_len, sm))
            row["plain_ms"] = cuda_ms(lambda: plain(q, k, v, kv_len, sm))
            mask = (torch.arange(Sk, device=dev)[None, :] < kv_len[:, None])[:, None, None]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True, scale=sm))
            row["roofline_pct"] = 100.0 * row["bound_ms"] / row["ms"]
            timed[what] = row
        emit("decode", **row)
        if not ok:
            raise RuntimeError(f"decode_attention disagrees with its plain version: {row}")
    return timed


def _metric(name):
    """The benchmark's reader ``portbench/metrics/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "portbench", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_ssd(peaks) -> tuple:
    import math

    import torch

    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import (
        ALL_PASSES,
        PASSES,
        ssd_chunked,
        ssd_scan_cuda,
        ssd_scan_launcher,
    )

    ssd_work = _metric("ssd_scan_roofline").ssd_work
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for S in (1024, 1000):                    # zamba2's prefill, and ragged
        for dt in ("float32", "bfloat16"):
            cases.append(((1, S, 64, 64, 64, 256), dt, "slice"))
    # granite-4.0-h-small's mixer over the long-doc cell's prompts (2,048 to
    # 12,288, median 6,144), float32 as mamba2_block passes them
    for S in (2048, 6144, 12288):
        cases.append(((1, S, 128, 64, 128, 256), "float32", "long_doc"))
    cases.append(((1, 2048, 128, 64, 128, 256), "bfloat16", "long_doc"))
    for shape in SSD_SHAPES:
        for dt in ("float32", "bfloat16"):
            cases.append((shape, dt, "tests"))

    main_entry, long_doc = None, {}
    for (B, S, nh, hp, n, chunk), dt, what in cases:
        dtype = getattr(torch, dt)
        x = torch.randn(B, S, nh, hp, generator=gen, device=dev)
        Bc = torch.randn(B, S, n, generator=gen, device=dev)
        Cc = torch.randn(B, S, n, generator=gen, device=dev)
        if what in ("slice", "long_doc"):
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
        yr, hr = ssd_chunked(x, dts, A, Bc, Cc, chunk)
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
        if what in ("slice", "long_doc"):
            row["ms"] = cuda_ms(lambda: ssd_scan_cuda(x, dts, A, Bc, Cc, chunk=chunk))
            row["eager_ms"] = eager_ms(lambda: ssd_scan_cuda(x, dts, A, Bc, Cc, chunk=chunk))
            # each pass alone, on the buffers of one full run (every pass
            # reads only what the earlier ones wrote, so a repeat is exact)
            launch, _, _ = ssd_scan_launcher(x, dts, A, Bc, Cc, chunk=chunk)
            launch(ALL_PASSES)
            row["pass_ms"] = {name: cuda_ms(lambda bit=bit: launch(bit))
                              for name, bit in PASSES.items()}
            row["plain_ms"] = cuda_ms(lambda: ssd_chunked(x, dts, A, Bc, Cc, chunk))
            row["library_ms"] = None      # no single PyTorch call computes it
            row["bound_ms"], row["bound_by"], row["bound_flops"], row["bound_bytes"] = \
                ssd_bound_ms(B, S, nh, hp, n, dtype, peaks)
            row["chunked_flops"] = ssd_chunked_flops(B, S, nh, hp, n, chunk)
            if what == "slice" and S == 1024 and dt == "float32":  # the model path's
                main_entry = row
        if what == "long_doc":
            # the benchmark's yardstick: the configuration's bf16 bytes and
            # the bf16 tensor rate, whatever the inputs' type here
            flops, nbytes = ssd_work(B, S, nh, hp, n, 2)
            bound_ms = 1e3 * max(flops / peaks.bf16_flops, nbytes / peaks.mem_bytes)
            row["roofline_bf16_pct"] = 100.0 * bound_ms / row["ms"]
            long_doc[f"at_long_doc_{S}_{dt}"] = row
        emit("ssd", **row)
        if not ok:
            raise RuntimeError(f"ssd_scan disagrees with its plain version: {row}")
    return main_entry, long_doc


def _prompts(rng, n, length, vocab):
    return [rng.integers(0, vocab, size=length).astype("int64") for _ in range(n)]


def _weights(cfg, device="cuda"):
    """Seeded random float32 weights on ``device`` (the card), attention
    well conditioned: the training CLI's ``--full`` weights at ``--seed 0``.

    ``init_from_schema`` follows the JAX package and scales each weight by
    1/sqrt(shape[-2]).  For the head-structured projections that is the
    head count (qwen2 wq: 12, wk/wv: 2; zamba2's shared block: 32) or the
    head dim (wo: 128; zamba2: 64), not the contracted width, so at full
    width the q.k logits reach the hundreds, the softmax is saturated, and
    two summation orders of the same model part within a few layers:
    without the rescale the qwen2 parity phase fails (prefill logits 3.7
    apart, different tokens) while the kernel agrees with its plain
    version.  Rescaling the projections of every attention block (the
    stacked layers', zamba2's shared one, whisper's encoder and cross
    blocks) to their contracted width (``launch.train.rescale_attention``)
    keeps the parity phase a test of the kernels.
    """
    import torch

    from repro_torch.launch.train import rescale_attention
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema

    params = init_from_schema(0, build_schema(cfg), torch.float32, device)
    rescale_attention(params)
    return params


def _expected_launches(cfg, n_req: int, steps: int) -> dict:
    """Launches of each kernel for ``n_req`` admitted requests and ``steps``
    decode steps: flash once per attention layer of a prefill (or
    shared-block application; three per whisper decoder layer: encoder,
    decoder self, cross), decode attention once per attention layer of a
    decode step (two per whisper decoder layer: self, cross), ssd_scan once
    per mamba2 layer of a prefill."""
    from repro_torch.models.config import Family

    L = cfg.n_layers
    if cfg.family in (Family.ENC_DEC, Family.AUDIO):
        return {"flash_attention": n_req * 3 * L, "decode_attention": steps * 2 * L,
                "ssd_scan": 0}
    if cfg.family == Family.HYBRID:
        apps = L // cfg.shared_attn_period
        return {"flash_attention": n_req * apps, "decode_attention": steps * apps,
                "ssd_scan": n_req * L}
    if cfg.family == Family.SSM:          # mamba1: no kernel on its path
        return {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    return {"flash_attention": n_req * L, "decode_attention": steps * L, "ssd_scan": 0}


# (prompt tokens, new tokens, the pool's max_len) of each serve phase
SERVE_LENGTHS = {"whisper-large-v3": (224, 32, 448)}
SERVE_DEFAULT = (1024, 32, 1088)


def phase_serve(cfg) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.config import CellTuning
    from repro_torch.serve import EngineStats, Request, ServeEngine

    n_req = 8
    prompt_len, new_tokens, max_len = SERVE_LENGTHS.get(cfg.name, SERVE_DEFAULT)
    # the engine casts the weights to bf16 once; the float32 draws go after
    engine = ServeEngine(cfg, _weights(cfg), slots=4, max_len=max_len,
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
    expected = _expected_launches(cfg, n_req, stats.ticks)

    toks = [t for r in reqs for t in r.generated]
    checks = {
        "all_finished": stats.finished == n_req and all(r.done for r in reqs),
        "all_lengths": all(len(r.generated) == new_tokens for r in reqs),
        "tokens_in_vocab": all(0 <= t < cfg.vocab for t in toks),
        "launches": launches == expected,
    }
    decode_ticks = stats.ticks
    emit("serve", arch=cfg.name, dtype="bfloat16", requests=n_req,
         prompt_len=prompt_len, new_tokens=new_tokens, slots=4, max_len=max_len,
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
              "no_kernel_launched": dict(LAUNCHES) == NO_LAUNCHES}
    emit("decode_check", arch=cfg.name, dtype="float32", prompt_len=prompt_len,
         decode_vs_full_max_abs_err=err, tol=2e-3,
         logits_max_abs=float(full[:, -1].abs().max()),
         seconds=time.perf_counter() - t0, launches=dict(LAUNCHES), checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"decode check failed: {checks}")


def phase_parity_encdec(cfg, prompt_lens) -> None:
    """whisper in float32 at full width, kernel path against torch path, on
    nonzero biases and random frames (0.02 N(0, 1), seeded; the engine's
    zero frames would leave the biases alone to drive the encoder): per
    request the encoder output and the prefill logits within 1e-3 and the
    greedy tokens of ``serve_batch`` equal.  Then the decode check: the
    prefill of the first prompt and one decode step (cross K/V from the
    cache) against the full forward at the last position, within 2e-3."""
    import numpy as np
    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models.model import DECODE, PREFILL, TRAIN, encoder, forward
    from repro_torch.models.ops import ShardCtx
    from repro_torch.train.steps import make_prefill_step

    params32 = _weights(cfg)
    gen = torch.Generator().manual_seed(4)
    for group, blocks in (("enc_layers", ("attn", "mlp")),
                          ("layers", ("attn", "cross", "mlp"))):
        for blk in blocks:
            for key, w in params32[group][blk].items():
                if key in ("bq", "bk", "bv", "b_up", "b_down"):
                    w.copy_(0.1 * torch.randn(w.shape, generator=gen))
    frames = (0.02 * torch.randn(len(prompt_lens), cfg.enc_len, cfg.d_model,
                                 generator=gen)).cuda()
    rng = np.random.default_rng(2)
    prompts = [_prompts(rng, 1, n, cfg.vocab)[0] for n in prompt_lens]
    tokens, logits, enc, launches = {}, {}, {}, {}
    t0 = time.perf_counter()
    for impl in ("kernel", "torch"):
        ctx = ShardCtx(impl)
        step = make_prefill_step(cfg, ctx)
        reset_launches()
        tokens[impl] = [serve_batch(cfg, params32, p[None], 8, enc_embeds=frames[i:i + 1],
                                    ctx=ctx, device="cuda")[0, len(p):].tolist()
                        for i, p in enumerate(prompts)]
        launches[impl] = LAUNCHES["flash_attention"]
        with torch.inference_mode():
            enc[impl] = torch.cat([encoder(params32, cfg, frames[i:i + 1], ctx=ctx)
                                   for i in range(len(prompts))])
            logits[impl] = torch.cat([
                step(params32, {"tokens": torch.as_tensor(p[None], device="cuda"),
                                "enc_embeds": frames[i:i + 1]})[0]
                for i, p in enumerate(prompts)])
    enc_err = float((enc["kernel"] - enc["torch"]).abs().max())
    err = float((logits["kernel"] - logits["torch"]).abs().max())

    toks = torch.as_tensor(prompts[0][None], device="cuda")
    f0 = frames[:1]
    with torch.inference_mode():
        pre, cache, _ = forward(params32, cfg, {"tokens": toks, "enc_embeds": f0},
                                mode=PREFILL)
        for key in ("k", "v"):
            cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 8))
        nxt = torch.argmax(pre[:, -1, : cfg.vocab], dim=-1)[:, None]
        dec, _, _ = forward(params32, cfg, {"tokens": nxt}, mode=DECODE, cache=cache)
        full, _, _ = forward(params32, cfg, {"tokens": torch.cat([toks, nxt], 1),
                                             "enc_embeds": f0}, mode=TRAIN)
    torch.cuda.synchronize()
    dec_err = float((dec[:, -1] - full[:, -1]).abs().max())
    checks = {"encoder_within_1e-3": enc_err <= 1e-3,
              "logits_within_1e-3": err <= 1e-3,
              "tokens_equal": tokens["kernel"] == tokens["torch"],
              "logits_finite": bool(torch.isfinite(logits["kernel"]).all()),
              "kernel_path_launched": launches["kernel"] == 3 * cfg.n_layers * len(prompts),
              "torch_path_launched_none": launches["torch"] == 0,
              "decode_within_2e-3": dec_err <= 2e-3,
              "decode_finite": bool(torch.isfinite(dec).all() and torch.isfinite(full).all())}
    emit("parity", arch=cfg.name, dtype="float32", requests=len(prompts),
         prompt_lens=list(prompt_lens), new_tokens=8, enc_len=cfg.enc_len,
         encoder_max_abs_err=enc_err, encoder_max_abs=float(enc["torch"].abs().max()),
         prefill_logits_max_abs_err=err, tol=1e-3, flash_launches=launches,
         decode_vs_full_max_abs_err=dec_err, decode_tol=2e-3,
         logits_max_abs=float(full[:, -1].abs().max()),
         seconds=time.perf_counter() - t0, tokens=tokens["kernel"], checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"parity checks failed: {checks}")


# the train phase: the CLI's full-width qwen2-1.5b step (launch/train.py's
# build at --full), float32 and bfloat16, the kernel route under no_grad,
# every family's reduced twin card against CPU, and a restart
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 512, 8, 2
TRAIN_LR = 3e-3                # the CLI's default
TRAIN_STEPS = 6                # (a), float32, then one profiled step
TRAIN_BF16_STEPS = 3           # (b)
TRAIN_TWIN_STEPS = 3           # (d), each reduced twin on the card and the CPU
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL_AT = 12, 4, 6      # (e)
TWIN_OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=20)
TRAIN_CARD = "cuda"


def _leaf_sums(params) -> list:
    """Per leaf, its float64 sum and sum of squares: a leaf that moved
    changes them."""
    import torch

    from repro_torch.tree import leaves

    return [(float(p.sum(dtype=torch.float64)),
             float(p.square().sum(dtype=torch.float64))) for p in leaves(params)]


def _train_steps(case, cfg, opt_cfg, step_fn, dcfg, params, n_steps, dtype,
                 peaks, profile_it) -> dict:
    """``n_steps`` of ``step_fn`` on the card from ``params``, the launch
    counts zeroed just before and read just after.  Per step: loss,
    grad_norm, lr, wall ms to a synchronize, tokens/s and the model-FLOP
    share of the card's peak for ``dtype`` (8 N tokens: 6 N T for the
    forward and backward, 2 N T for the remat forward; N =
    ``cfg.param_count()``, attention's own products not counted)."""
    import math

    import torch

    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import to_device
    from repro_torch.obs.profile import profile_window
    from repro_torch.optim import adamw

    bf16_rate, f32_rate, _ = peaks
    rate = bf16_rate if dtype == "bfloat16" else f32_rate
    tokens = dcfg.global_batch * dcfg.seq_len
    model_flops = 8.0 * cfg.param_count() * tokens
    before = _leaf_sums(params)
    state = adamw.init(opt_cfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps = []
    for i in range(n_steps):
        batch = to_device(batch_for_step(dcfg, i), TRAIN_CARD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": i + 1, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                      "ms": 1e3 * dt, "tokens_per_s": tokens / dt,
                      "model_flop_share": model_flops / dt / rate})
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    moved = [a != b for a, b in zip(before, _leaf_sums(params))]
    warm = sorted(s["ms"] for s in steps[1:])
    row = {"case": case, "arch": cfg.name, "dtype": dtype,
           "seq_len": dcfg.seq_len, "global_batch": dcfg.global_batch,
           "microbatches": TRAIN_MICRO, "remat": True,
           "params": cfg.param_count(), "model_flops_per_step": model_flops,
           "peak_rate": rate, "steps": steps,
           "warm_step_ms_median": warm[len(warm) // 2] if warm else None,
           "peak_mem_bytes": peak, "launches": launches,
           "leaves_moved": sum(moved), "leaves": len(moved)}
    row["checks"] = {
        "losses_finite": all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                             for s in steps),
        "every_leaf_moved": all(moved),
        "no_kernel_launched": launches == NO_LAUNCHES}
    if profile_it:
        batch = to_device(batch_for_step(dcfg, n_steps), TRAIN_CARD)
        out = []
        prof = profile_window(case, lambda: out.append(step_fn(params, state, batch)), 8)
        del out
        row.update(profiled_step_wall_ms=prof["wall_ms"],
                   device_kernel_ms=prof["kernel_ms"],
                   idle_share=prof["idle_share"], profiled_launches=prof["launches"],
                   top_kernels=prof["top"])
    return row


def _train_kernel_route(case, cfg, params, batch, expected) -> dict:
    """``loss_fn`` under no_grad in float32 with the kernel context and with
    TRAIN_CTX: the losses within 1e-4 relative, the kernel context's
    launches exactly ``expected``, TRAIN_CTX's none."""
    import math

    import torch

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.config import CellTuning
    from repro_torch.models.ops import ShardCtx
    from repro_torch.train.steps import TRAIN_CTX, loss_fn

    tuning = CellTuning(compute_dtype="float32", remat=False)
    losses, launches = {}, {}
    with torch.no_grad():
        for impl, ctx in (("kernel", ShardCtx()), ("torch", TRAIN_CTX)):
            reset_launches()
            loss, _ = loss_fn(params, cfg, batch, ctx, tuning)
            losses[impl] = float(loss)
            launches[impl] = dict(LAUNCHES)
    rel = abs(losses["kernel"] - losses["torch"]) / abs(losses["torch"])
    checks = {"losses_finite": all(math.isfinite(v) for v in losses.values()),
              "within_1e-4": rel <= 1e-4,
              "kernel_launches": launches["kernel"] == expected,
              "torch_launches_none": launches["torch"] == NO_LAUNCHES}
    return {"case": case, "arch": cfg.name, "dtype": "float32",
            "tokens": list(batch["tokens"].shape), "losses": losses, "rel_diff": rel,
            "tol": 1e-4, "launches": launches, "expected_launches": expected,
            "checks": checks}


def _twin_case(name) -> dict:
    """One reduced twin, ``TRAIN_TWIN_STEPS`` steps on the card and on the
    CPU from the same weights and batches: per step the loss within 1e-5
    relative and grad_norm within 1e-4.  For MoE the experts each router
    call picks are recorded on both; the tokens whose experts differ are
    counted (routing_flips), and from the first step with a flip on the
    two runs are no longer compared."""
    import math

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import rescale_attention, to_device
    from repro_torch.models import moe
    from repro_torch.models.config import CellTuning
    from repro_torch.models.model import cast_params
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.models.testing import reduced
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    cfg = reduced(get_arch(name))
    cpu = init_from_schema(0, build_schema(cfg), torch.float32, "cpu")
    rescale_attention(cpu)
    opt = adamw.OptimizerConfig(**TWIN_OPT)
    step = make_train_step(cfg, opt, CellTuning(num_microbatches=TRAIN_MICRO, remat=True,
                                                compute_dtype="float32"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=2,
                      enc_len=cfg.enc_len, d_model=cfg.d_model)
    devices = {"card": TRAIN_CARD, "cpu": "cpu"}
    runs = {key: [cast_params(cpu, torch.float32, dev), None] for key, dev in devices.items()}
    for run in runs.values():
        run[1] = adamw.init(opt, run[0])
    route = moe._route
    rows, flips, compared = [], 0, True
    for i in range(TRAIN_TWIN_STEPS):
        batch = batch_for_step(dcfg, i)
        metrics, routes = {}, {}
        for key, run in runs.items():
            rec = routes[key] = []

            def recording(*args, rec=rec, **kwargs):
                out = route(*args, **kwargs)
                rec.append(out[3].sort(dim=-1).values.cpu())
                return out

            moe._route = recording
            try:
                run[0], run[1], m = step(run[0], run[1], to_device(batch, devices[key]))
            finally:
                moe._route = route
            metrics[key] = {k: float(v) for k, v in m.items()}
        step_flips = sum(int((a != b).any(dim=-1).sum())
                         for a, b in zip(routes["card"], routes["cpu"]))
        flips += step_flips
        compared = compared and step_flips == 0 and len(routes["card"]) == len(routes["cpu"])
        c, p = metrics["card"], metrics["cpu"]
        rows.append({"step": i + 1, "loss": c["loss"], "loss_cpu": p["loss"],
                     "loss_rel": abs(c["loss"] - p["loss"]) / abs(p["loss"]),
                     "grad_norm": c["grad_norm"], "grad_norm_cpu": p["grad_norm"],
                     "grad_norm_rel": abs(c["grad_norm"] - p["grad_norm"]) / p["grad_norm"],
                     "routing_flips": step_flips, "compared": compared})
    finite = all(math.isfinite(r[k]) for r in rows
                 for k in ("loss", "loss_cpu", "grad_norm", "grad_norm_cpu"))
    gated = [r for r in rows if r["compared"]]
    checks = {"finite": finite,
              "loss_within_1e-5": all(r["loss_rel"] <= 1e-5 for r in gated),
              "grad_norm_within_1e-4": all(r["grad_norm_rel"] <= 1e-4 for r in gated)}
    return {"case": "d_card_vs_cpu", "arch": name, "family": cfg.family.value,
            "steps": rows, "routing_flips": flips, "steps_compared": len(gated),
            "checks": checks}


def _train_restart() -> dict:
    """Reduced qwen2 for RESTART_STEPS steps on the card through
    RestartManager (a checkpoint every RESTART_EVERY steps, one injected
    failure at step RESTART_FAIL_AT), against an uninterrupted run: its
    final parameters and optimizer state bit-equal, or within 1e-6 of each
    leaf's magnitude."""
    import tempfile

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.ft.manager import RestartManager
    from repro_torch.launch.train import to_device
    from repro_torch.models.config import CellTuning
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.models.testing import reduced
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves

    cfg = reduced(get_arch(TRAIN_ARCH))
    opt = adamw.OptimizerConfig(**TWIN_OPT)
    step = make_train_step(cfg, opt, CellTuning(num_microbatches=TRAIN_MICRO, remat=True,
                                                compute_dtype="float32"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=5)

    def init_fn():
        params = init_from_schema(0, build_schema(cfg), torch.float32, TRAIN_CARD)
        return {"params": params, "opt": adamw.init(opt, params)}

    def step_fn(state, i):
        params, opt_state, _ = step(state["params"], state["opt"],
                                    to_device(batch_for_step(dcfg, i), TRAIN_CARD))
        return {"params": params, "opt": opt_state}

    ref = init_fn()
    for i in range(RESTART_STEPS):
        ref = step_fn(ref, i)
    failed = []

    def flaky(state, i):
        if i == RESTART_FAIL_AT and not failed:
            failed.append(i)
            raise RuntimeError("injected failure")
        return step_fn(state, i)

    with tempfile.TemporaryDirectory() as d:
        mgr = RestartManager(d, checkpoint_every=RESTART_EVERY)
        out = mgr.run(init_fn, flaky, num_steps=RESTART_STEPS)
        kept = store.all_steps(d)
    pairs = list(zip(leaves(out), leaves(ref)))
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    max_rel = max(float((a.double() - b.double()).abs().max())
                  / max(float(b.double().abs().max()), 1e-30) for a, b in pairs)
    checks = {"one_failure_recovered": mgr.total_failures == 1 and failed == [RESTART_FAIL_AT],
              "final_step": int(out["opt"].step) == RESTART_STEPS,
              "within_1e-6": max_rel <= 1e-6}
    return {"case": "e_restart", "arch": cfg.name, "steps": RESTART_STEPS,
            "checkpoint_every": RESTART_EVERY, "failed_at": RESTART_FAIL_AT,
            "checkpoints_kept": kept, "leaves": len(pairs), "bit_equal": bit_equal,
            "max_rel_diff": max_rel, "tol": 1e-6, "checks": checks}


def _emit_train(row) -> None:
    emit("train", **row)
    if not all(row["checks"].values()):
        raise RuntimeError(f"train checks failed on {row['case']} {row['arch']}: "
                           f"{row['checks']}")


def phase_train(peaks) -> dict:
    """The train phase.  (a) qwen2-1.5b at full width and depth through the
    CLI's builder (``launch.train.build(..., full=True)``: float32, remat,
    2 micro-batches), DataConfig(seq_len=512, global_batch=8), TRAIN_STEPS
    steps, then one more under the profiler.  (c) first, on the same initial
    weights and (a)'s first batch: the kernel route under no_grad, 28 flash
    launches.  (b) the same model and weights in bfloat16 compute,
    TRAIN_BF16_STEPS steps and one profiled, its step-0 loss within 2e-2
    relative of (a)'s.  (c) again at zamba2's
    reduced twin.  (d) every registry arch's reduced twin, card against
    CPU.  (e) the restart.  Returns the kernel launches counted over the
    train steps of (a), (b) and (d): none may launch."""
    import torch

    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import build, to_device
    from repro_torch.models.config import CellTuning
    from repro_torch.models.testing import reduced
    from repro_torch.train.steps import make_train_step

    cfg, opt_cfg, step_fn, dcfg = build(TRAIN_ARCH, full=True, seq_len=TRAIN_SEQ,
                                        batch=TRAIN_BATCH, lr=TRAIN_LR,
                                        microbatches=TRAIN_MICRO)
    total = {"flash_attention": 0, "ssd_scan": 0}

    def count(launches):
        for k in total:
            total[k] += launches[k]

    # each run draws its own copy of the seeded weights (the same values), so
    # no copy outlives the run that uses it
    _emit_train(_train_kernel_route(
        "c_kernel_route", cfg, _weights(cfg, TRAIN_CARD),
        to_device(batch_for_step(dcfg, 0), TRAIN_CARD),
        {"flash_attention": cfg.n_layers, "decode_attention": 0, "ssd_scan": 0}))
    torch.cuda.empty_cache()
    a = _train_steps("a_float32", cfg, opt_cfg, step_fn, dcfg, _weights(cfg, TRAIN_CARD),
                     TRAIN_STEPS, "float32", peaks, profile_it=True)
    count(a["launches"])
    _emit_train(a)
    torch.cuda.empty_cache()

    tuning16 = CellTuning(num_microbatches=TRAIN_MICRO, remat=True,
                          compute_dtype="bfloat16")
    b = _train_steps("b_bfloat16", cfg, opt_cfg, make_train_step(cfg, opt_cfg, tuning16),
                     dcfg, _weights(cfg, TRAIN_CARD), TRAIN_BF16_STEPS, "bfloat16", peaks,
                     profile_it=True)
    count(b["launches"])
    b["step0_loss_float32"] = a["steps"][0]["loss"]
    b["step0_rel_diff"] = abs(b["steps"][0]["loss"] - a["steps"][0]["loss"]) \
        / abs(a["steps"][0]["loss"])
    b["checks"]["step0_within_2e-2_of_float32"] = b["step0_rel_diff"] <= 2e-2
    _emit_train(b)
    torch.cuda.empty_cache()

    zcfg = reduced(get_arch("zamba2-1.2b"))
    zdata = DataConfig(vocab=zcfg.vocab, seq_len=64, global_batch=4, seed=1)
    _emit_train(_train_kernel_route(
        "c_kernel_route", zcfg, _weights(zcfg, TRAIN_CARD),
        to_device(batch_for_step(zdata, 0), TRAIN_CARD),
        {"flash_attention": zcfg.n_layers // zcfg.shared_attn_period,
         "decode_attention": 0, "ssd_scan": zcfg.n_layers}))
    for name in sorted(ARCHS):
        reset_launches()
        row = _twin_case(name)
        count(dict(LAUNCHES))
        row["launches"] = dict(LAUNCHES)
        row["checks"]["no_kernel_launched"] = row["launches"] == NO_LAUNCHES
        _emit_train(row)
    _emit_train(_train_restart())
    return total


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


# (a)'s shapes: a train_4k cell takes minutes to count on fakes (103-344 s
# each on an H100 machine's host, PERF.md), a serving cell 1-9 s
DRYRUN_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
# (b)'s cells: they fit on one card, so their step also runs for real
DRYRUN_REAL = (("falcon-mamba-7b", "decode_32k"), ("zamba2-1.2b", "long_500k"))
DRYRUN_MEM_TOL = (0.05, 0.5e9)   # relative, absolute: the larger holds


def _dryrun_real_step(arch, shape, rec) -> dict:
    """(b): the plan's step on real tensors of its fakes' shapes and dtypes
    on the card: seeded weights, the cache's zeros, seeded tokens."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.plan import build_plan
    from repro_torch.models.model import cache_schema
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.tree import leaves

    plan = build_plan(arch, shape, device="cuda")
    cfg, B, S = plan.arch, plan.shape.global_batch, plan.shape.seq_len
    with FakeTensorMode():
        fakes = plan.abstract_args()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = (init_from_schema(0, build_schema(cfg), getattr(torch, plan.tuning.param_dtype), "cuda"),
            init_from_schema(0, cache_schema(cfg, B, S, enc_len=cfg.enc_len),
                             getattr(torch, plan.tuning.compute_dtype), "cuda"),
            torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda",
                          dtype=torch.int32))
    layout = [(tuple(t.shape), t.dtype) for t in leaves(args)]
    fake_layout = [(tuple(t.shape), t.dtype) for t in leaves(fakes)]
    with FlopCounterMode(display=False) as fc:        # also the warm-up
        plan.step_fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    reps = 3
    t0.record()
    for _ in range(reps):
        out = plan.step_fn(*args)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    finite = bool(torch.isfinite(out[0]).all())
    del out
    peak = torch.cuda.max_memory_allocated() - base
    fake_peak = rec["memory"]["peak_bytes_per_device"]
    roof = rec["roofline"]
    largest = max(roof["compute_s"], roof["memory_s"], roof["collective_s"])
    tol = max(DRYRUN_MEM_TOL[0] * fake_peak, DRYRUN_MEM_TOL[1])
    checks = {"layout_equal": layout == fake_layout,
              "flops_equal": fc.get_total_flops() == roof["flops_per_device"],
              "peak_within_tol": abs(peak - fake_peak) <= tol,
              "logits_finite": finite}
    row = dict(case="real_step", arch=arch, shape=shape,
               param_dtype=plan.tuning.param_dtype,
               compute_dtype=plan.tuning.compute_dtype,
               flops_real=fc.get_total_flops(), flops_fake=roof["flops_per_device"],
               peak_bytes=peak, fake_peak_bytes=fake_peak, peak_tol_bytes=tol,
               ms=ms, roofline_largest_ms=1e3 * largest,
               ms_over_roofline=ms / (1e3 * largest), bottleneck=roof["bottleneck"],
               checks=checks)
    del args
    torch.cuda.empty_cache()
    emit("dryrun", **row)
    if not all(checks.values()):
        raise RuntimeError(f"dry-run real step checks failed on {arch} x {shape}: {checks}")
    return row


# (c)'s jobs, (arch, shape, steps per hour): 10 jobs for 3 pods of 4
DRYRUN_JOBS = (("qwen2-1.5b", "prefill_32k", 900.0), ("qwen2-1.5b", "decode_32k", 3.6e6),
               ("yi-9b", "prefill_32k", 900.0), ("yi-9b", "decode_32k", 3.6e6),
               ("granite-moe-3b-a800m", "prefill_32k", 900.0),
               ("granite-moe-3b-a800m", "decode_32k", 3.6e6),
               ("zamba2-1.2b", "decode_32k", 3.6e6), ("zamba2-1.2b", "long_500k", 3.6e5),
               ("falcon-mamba-7b", "decode_32k", 3.6e6),
               ("falcon-mamba-7b", "long_500k", 3.6e5))


def _dryrun_jobs(records):
    """(c)'s jobs from (a)'s records: the roofline table as
    examples/green_deployment.py's roofline_lookup builds it, a "perf"
    flavour (the record's terms) and a 0.55x "eco" one per job; each
    arch's prefill sends its KV cache to its decode."""
    from repro_torch.launch.green_placement import JobSpec, TrafficSpec

    table = {}
    for r in records:
        if r["status"] == "ok" and not r["multi_pod"]:
            f = r["roofline"]
            table[(r["arch"], r["shape"])] = {
                "compute_s": f["compute_s"], "memory_s": f["memory_s"],
                "collective_s": f["collective_s"]}
    jobs, traffic = [], []
    for arch, shape, steps_per_h in DRYRUN_JOBS:
        base = table[(arch, shape)]
        jobs.append(JobSpec(f"{arch}-{shape}", arch, shape,
                            {"perf": base, "eco": {k: v * 0.55 for k, v in base.items()}},
                            flavours_order=("perf", "eco"), steps_per_h=steps_per_h))
        if shape == "decode_32k" and (arch, "prefill_32k", 900.0) in DRYRUN_JOBS:
            traffic.append(TrafficSpec(f"{arch}-prefill_32k", f"{arch}-decode_32k",
                                       gb_per_h=7200.0))
    return jobs, traffic


def phase_dryrun() -> dict:
    """(a) every registry arch x DRYRUN_SHAPES counted on fakes on the card;
    (b) DRYRUN_REAL's steps run for real against their counts; (c)
    GreenPlacement fed with (a)'s records, card vs CPU."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.dryrun import run_cell, summary
    from repro_torch.launch.green_placement import GreenPlacement, PodSpec
    from repro_torch.launch.roofline import HBM_BYTES
    from repro_torch.models.config import SHAPES, cell_is_supported

    t0 = time.perf_counter()
    records = {}
    for arch in ARCHS:
        for shape in DRYRUN_SHAPES:
            rec = run_cell(arch, shape, device="cuda")
            records[(arch, shape)] = rec
            ok, why = cell_is_supported(ARCHS[arch], SHAPES[shape])
            row = dict(case="cell", arch=arch, shape=shape, status=rec["status"],
                       line=summary(rec))
            if rec["status"] == "ok":
                r, peak = rec["roofline"], rec["memory"]["peak_bytes_per_device"]
                row.update(peak_gb=peak / 1e9, fits_80gb=peak <= HBM_BYTES,
                           compute_s=r["compute_s"], memory_s=r["memory_s"],
                           collective_s=r["collective_s"], bottleneck=r["bottleneck"],
                           flops=r["flops_per_device"], bytes=r["hbm_bytes_per_device"],
                           model_flops=r["model_flops"], memory=rec["memory"],
                           count_s=rec["compile_s"])
            else:
                row["reason"] = rec["reason"]
            emit("dryrun", **row)
            if rec["status"] != ("ok" if ok else "skipped") or rec.get("reason", "") != why:
                raise RuntimeError(f"dry run of {arch} x {shape} gave {rec}")
    cells_s = time.perf_counter() - t0
    for arch, shape in DRYRUN_REAL:
        _dryrun_real_step(arch, shape, records[(arch, shape)])
    jobs, traffic = _dryrun_jobs(records.values())
    pods = [PodSpec("clean", "france", carbon=16.0, cost_per_chip_hour=1.3),
            PodSpec("mid", "finland", carbon=120.0, cost_per_chip_hour=1.1),
            PodSpec("dirty", "texas", carbon=410.0, cost_per_chip_hour=0.8)]
    runs = {dev: GreenPlacement(device=dev).place(jobs, pods, traffic)
            for dev in ("cuda", "cpu")}
    (plan, out, stats), (plan_c, out_c, stats_c) = runs["cuda"], runs["cpu"]
    checks = {"plan_equal": plan == plan_c,
              "constraints_equal": list(out.constraints) == list(out_c.constraints),
              "stats_equal": stats == stats_c}
    emit("dryrun", case="green_placement", jobs=len(jobs), pods=len(pods),
         feasible=plan.feasible,
         placements=[(p.service, p.flavour, p.node) for p in plan.placements],
         skipped=list(plan.skipped_services), stats=stats, cells_s=cells_s,
         checks=checks)
    if not all(checks.values()):
        raise RuntimeError(f"green placement from dry-run records differs: {checks}")
    return records


# -- the mesh phase -----------------------------------------------------------
# (b)'s cells: rank 0 of the 16x16 world on real tensors, and the arch that
# runs the same kernels where one's fake peak is over MESH_REAL_PEAK
MESH_REAL = (("yi-6b", "prefill_32k", "yi-9b"), ("zamba2-1.2b", "prefill_32k", None))
MESH_REAL_PEAK = 70e9
MESH_CHIPS = 256
MESH_CHILD_TIMEOUT = 900
# (a)'s count runs after the timed phases, in this many children per
# fakes' device (one thread each), so that it times nothing it slows
MESH_COUNT_PARTS = 3
# the flash rows' plain version runs over query slices of this many rows
# (its (B, H, S, S) float32 scores at 32,768 positions take 17 GB)
MESH_PLAIN_ROWS = 4096
# (c): qwen2-1.5b's requests on the 1x1 NCCL mesh
MESH_NCCL_BATCH, MESH_NCCL_PROMPT, MESH_NCCL_MAX = 4, 1024, 1088


def _mesh_count_cells(device: str, part: int) -> dict:
    """(a) in a child process: part ``part`` of MESH_COUNT_PARTS of the
    registry archs (every MESH_COUNT_PARTS-th from the ``part``-th) x
    DRYRUN_SHAPES counted per device on the 16x16 mesh, in one fake world
    of 256 ranks, the fakes on ``device``."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import fake_world

    records = {}
    with fake_world(MESH_CHIPS):
        for arch in list(ARCHS)[part::MESH_COUNT_PARTS]:
            for shape in DRYRUN_SHAPES:
                records[f"{arch} {shape}"] = run_cell(arch, shape, multi_pod=False,
                                                      device=device)
    return {"records": records}


def _seeded_locals(args, vocab: int, seed: int = 0) -> None:
    """Fill each DTensor's local shard with seeded draws: floats ~ N(0,
    0.02), integers (tokens) in the vocabulary."""
    import torch

    from repro_torch.tree import leaves

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for t in leaves(args):
        local = t.to_local()
        if local.is_floating_point():
            local.normal_(0.0, 0.02, generator=gen)
        else:
            local.random_(0, vocab, generator=gen)


def _mesh_real_step(arch: str, shape: str):
    """(b) in a child process: rank 0 of the fake 16x16 world runs the
    cell's step on real CUDA tensors of its local shapes.  The fake
    collectives move nothing and leave their outputs unwritten, so no value
    is checked: its FLOPs (``launch.cost.LocalFlopCounter``) must equal
    the fake count's, its peak memory the fake peak within DRYRUN_MEM_TOL,
    and each kernel's launches the count's calls of its operator.  The
    row carries the count's record of each kernel call (its per-device
    arguments), which the kernel rows of the phase run again.  None, with
    nothing run, where the fake peak is over MESH_REAL_PEAK."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.launch.plan import build_plan

    plan = build_plan(arch, shape, multi_pod=False, device="cuda")
    with fake_world(plan.chips):
        mesh = make_production_mesh(device_type="cuda")
        with FakeTensorMode():
            fakes = plan.abstract_args(mesh=mesh)
        t0 = time.perf_counter()
        totals, by_op = cost.analyze_by_op(plan.step_fn, *fakes)
        count_s = time.perf_counter() - t0
        calls = {name: int(by_op.get(name, (0, 0, 0))[2])
                 for name in ("flash_attention", "ssd_scan")}
        fake_peak = totals.memory["peak_bytes_per_device"]
        if fake_peak > MESH_REAL_PEAK:
            emit("mesh", case="real_step", arch=arch, shape=shape,
                 fake_peak_bytes=fake_peak, skipped=f"fake peak over {MESH_REAL_PEAK:.0f} B")
            return None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        args = plan.abstract_args(mesh=mesh)           # real local shards
        _seeded_locals(args, plan.arch.vocab)
        with cost.LocalFlopCounter() as fc:             # also the warm-up
            plan.step_fn(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        plan.step_fn(*args)
        torch.cuda.synchronize()
        launches = {name: LAUNCHES[name] for name in calls}
        peak = torch.cuda.max_memory_allocated() - base
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        reps = 3
        t0.record()
        for _ in range(reps):
            plan.step_fn(*args)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / reps
    roof = cost_roofline(plan, totals)
    tol = max(DRYRUN_MEM_TOL[0] * fake_peak, DRYRUN_MEM_TOL[1])
    checks = {"flops_equal": fc.get_total_flops() == totals.flops,
              "peak_within_tol": abs(peak - fake_peak) <= tol,
              "launches_as_counted": launches == calls and sum(calls.values()) > 0}
    row = dict(case="real_step", arch=arch, shape=shape, mesh="16x16 rank 0",
               flops_real=fc.get_total_flops(), flops_fake=totals.flops,
               peak_bytes=peak, fake_peak_bytes=fake_peak, peak_tol_bytes=tol,
               launches=launches, counted_calls=calls, ms=ms,
               compute_ms=1e3 * roof.compute_s, memory_ms=1e3 * roof.memory_s,
               collective_ms=1e3 * roof.collective_s, bottleneck=roof.bottleneck,
               count_s=count_s, kernel_calls=totals.kernel_calls, checks=checks)
    emit("mesh", **row)
    if not all(checks.values()):
        raise RuntimeError(f"mesh real step checks failed on {arch} x {shape}: {checks}")
    return row


def cost_roofline(plan, totals):
    from repro_torch.launch.roofline import Roofline

    return Roofline(flops=totals.flops, hbm_bytes=totals.bytes,
                    coll_bytes=totals.coll_bytes, model_flops=plan.model_flops,
                    chips=plan.chips, compute_dtype=plan.tuning.compute_dtype)


def _mesh_real_steps() -> dict:
    """(b)'s cells, each with the fake peak checked first: a cell over
    MESH_REAL_PEAK gives way to the next arch that runs the same kernels."""
    rows = []
    for arch, shape, instead in MESH_REAL:
        row = _mesh_real_step(arch, shape)
        if row is None and instead is not None:
            row = _mesh_real_step(instead, shape)
        if row is None:
            raise RuntimeError(f"no arch of {arch}'s kernels fits (b)'s real step")
        rows.append(row)
    return {"rows": rows}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_nccl() -> dict:
    """(c) in a child process: a real 1x1 NCCL mesh; qwen2-1.5b at full
    width in bf16 with the sharded context and DTensor parameters serves a
    prefill and a decode step through the kernel route, against the
    unsharded port on the same weights: logits equal bit for bit, the same
    flash launches, and the host cost of DTensor's dispatch (wall ms of
    each step, sharded beside plain).  The sharded context shards the
    cache's head dim, where the decode step's cache attention keeps the
    plain route (``models/model.py::_attend_cache``), so the unsharded
    decode step it is held to runs that route too."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh_from_shape
    from repro_torch.launch.plan import _place
    from repro_torch.models.model import SEQ_KEYS, cache_schema, cast_params
    from repro_torch.models.ops import ShardCtx
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import (default_rules, distribute_params,
                                             init_from_schema, schema_to_pspecs)
    from repro_torch.train import steps

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh_from_shape((1, 1), ("data", "model"), "cuda")
        cfg = get_arch("qwen2-1.5b")
        rules = default_rules(cfg, model_size=1, fsdp_total=1, batch_axes=("data",))
        ctx = ShardCtx("kernel", "kernel", enabled=True, dp=("data",), tp="model",
                       heads_sharded=rules.rules["heads_q"] is not None,
                       ff_sharded=rules.rules["d_ff"] is not None)
        params = cast_params(_weights(cfg), torch.bfloat16)
        specs = schema_to_pspecs(build_schema(cfg), rules)
        dparams = distribute_params(params, specs, mesh)
        B, S, L = MESH_NCCL_BATCH, MESH_NCCL_PROMPT, MESH_NCCL_MAX
        rng = np.random.default_rng(3)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).cuda()
        step_tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)).cuda()

        def shard_batch(t):
            return distribute_tensor(t, mesh, [Shard(0), Replicate()])

        def pooled(cache):
            full = init_from_schema(0, cache_schema(cfg, B, L), torch.bfloat16, "cuda")
            for key, val in cache.items():
                if key == "pos":
                    full[key] = val.clone()
                elif key in SEQ_KEYS:
                    full[key][:, :, :S] = val
            return full

        cspecs = schema_to_pspecs(cache_schema(cfg, B, L), rules)
        runs = {}
        for label, step_ctx, p, to in (("plain", None, params, lambda t: t),
                                       ("sharded", ctx, dparams, shard_batch)):
            kw = {} if step_ctx is None else {"ctx": step_ctx}
            prefill = steps.make_prefill_step(cfg, **kw)
            serve = steps.make_serve_step(cfg, ctx=step_ctx or ShardCtx("torch", "kernel"))

            def full(t):
                return t.full_tensor() if isinstance(t, DTensor) else t

            def decode_cache(cache):
                pool = pooled({k: full(v) for k, v in cache.items()})
                if step_ctx is None:
                    return pool
                return _place(distribute_params(pool, cspecs, mesh), cspecs)

            prefill(p, {"tokens": to(tokens)})            # warm-up
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            logits, cache = prefill(p, {"tokens": to(tokens)})
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            flash = LAUNCHES["flash_attention"]
            serve(p, decode_cache(cache), to(step_tok))   # warm-up
            pool = decode_cache(cache)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dlogits, _ = serve(p, pool, to(step_tok))
            torch.cuda.synchronize()
            decode_ms = 1e3 * (time.perf_counter() - t0)
            runs[label] = dict(logits=full(logits), dlogits=full(dlogits), flash=flash,
                               prefill_ms=prefill_ms, decode_ms=decode_ms)
        a, b = runs["plain"], runs["sharded"]
        checks = {"prefill_logits_bit_equal": bool(torch.equal(a["logits"], b["logits"])),
                  "decode_logits_bit_equal": bool(torch.equal(a["dlogits"], b["dlogits"])),
                  "flash_launches_equal": a["flash"] == b["flash"] == cfg.n_layers}
        row = dict(case="nccl_1x1", arch=cfg.name, batch=B, prompt=S,
                   flash_launches=b["flash"],
                   prefill_ms={k: runs[k]["prefill_ms"] for k in runs},
                   decode_ms={k: runs[k]["decode_ms"] for k in runs},
                   max_abs_diff=float((a["logits"].float() - b["logits"].float()).abs().max()),
                   checks=checks)
        emit("mesh", **row)
        if not all(checks.values()):
            raise RuntimeError(f"the 1x1 NCCL mesh differs from the unsharded port: {checks}")
        return row
    finally:
        dist.destroy_process_group()


MESH_CHILDREN = {"real": _mesh_real_steps, "nccl": _mesh_nccl}
MESH_CHILDREN.update({f"count_{dev}_{i}": (lambda dev=dev, i=i: _mesh_count_cells(dev, i))
                      for dev in ("cuda", "cpu") for i in range(MESH_COUNT_PARTS)})


def mesh_child(part: str) -> int:
    """``chip_smoke.py --mesh-child PART``: one part of the mesh phase in a
    process of its own (one default process group per process); prints its
    lines and last one JSON line with its result."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if part.startswith("count"):
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = MESH_CHILDREN[part]()
    print(json.dumps({"part": part, "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


def start_mesh_child(part: str):
    """``chip_smoke.py --mesh-child PART`` started, its output to temporary
    files (a pipe left unread would stall it)."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-child", part],
                            stdout=out, stderr=err, text=True, cwd=ROOT)
    proc.files = (out, err)
    return proc


def stop_mesh_child(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for fh in proc.files:
        fh.close()


def join_mesh_child(proc) -> dict:
    """The child's result; its lines but the last are printed here.  A
    child that fails or outlives MESH_CHILD_TIMEOUT raises."""
    try:
        proc.wait(timeout=MESH_CHILD_TIMEOUT)
        out, err = proc.files
        out.seek(0)
        err.seek(0)
        lines = out.read().strip().splitlines()
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"mesh child {proc.args[-1]} exited {proc.returncode}: "
                               f"{err.read()[-4000:]}")
    finally:
        stop_mesh_child(proc)
    for line in lines[:-1]:
        print(line, flush=True)
    return json.loads(lines[-1])


def _mesh_cell_row(rec, one_card) -> dict:
    row = dict(case="cell", arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
               status=rec["status"])
    if rec["status"] != "ok":
        row["reason"] = rec.get("reason", rec.get("error"))
        return row
    r = rec["roofline"]
    peak = rec["memory"]["peak_bytes_per_device"]
    row.update(flops=r["flops_per_device"], bytes=r["hbm_bytes_per_device"],
               peak_gb=peak / 1e9, fits_80gb=peak <= 80e9,
               collectives=rec["collectives"], compute_s=r["compute_s"],
               memory_s=r["memory_s"], collective_s=r["collective_s"],
               bottleneck=r["bottleneck"], count_s=rec["compile_s"],
               replication=r["flops_per_device"] * MESH_CHIPS
               / one_card["roofline"]["flops_per_device"])
    return row


def _count_diff(a, b) -> list:
    """The keys in which two records of one cell differ (empty: equal)."""
    keys = [k for k in ("status", "memory", "collectives") if a.get(k) != b.get(k)]
    if a["status"] == "ok" and b["status"] == "ok":
        keys += [k for k in ("flops_per_device", "hbm_bytes_per_device",
                             "collective_bytes_per_device")
                 if a["roofline"][k] != b["roofline"][k]]
    return keys


def _mesh_kernel_rows(peaks, real_rows) -> dict:
    """Each kernel at the per-device arguments of (b)'s steps, as the count
    recorded its calls there (each distinct call once): its device ms
    (CUDA-graph replay), bound and library ms, held to its plain version
    on the same inputs element by element, with TOL or SSD_TOL.  Flash is
    called through its wrapper (``kernels.ops.flash_attention``); its plain
    version runs over query slices of MESH_PLAIN_ROWS rows, each with its
    causal offset, and ``plain_ms`` is that run's (eager, CUDA events);
    ``library_ms`` is SDPA's where the call is the square product."""
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_reference
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    for real in real_rows:
        for name, calls in sorted(real["kernel_calls"].items()):
            for n, call in enumerate(calls):
                key = f"{'flash' if name == 'flash_attention' else 'ssd'}_{real['arch']}" \
                    + (f"_{n}" if len(calls) > 1 else "")
                dtype = getattr(torch, call["dtype"])
                if name == "flash_attention":
                    row = _mesh_flash_row(call["args"], dtype, gen, peaks, flash_attention,
                                          attention_reference)
                else:
                    row = _mesh_ssd_row(call["args"], dtype, gen, peaks, ssd_scan_cuda,
                                        ssd_chunked)
                row["calls_per_step"] = call["calls"]
                torch.cuda.empty_cache()
                emit("mesh", case="kernel_at_local_shape", at=key, **row)
                if not row["ok"]:
                    raise RuntimeError(f"kernel at the mesh's local shape disagrees: {row}")
                rows[key] = row
    return rows


def _mesh_flash_row(args, dtype, gen, peaks, kernel, plain_fn) -> dict:
    import torch

    (B, Sq, H, hd), (_, Sk, KV, _), _, causal, q_offset = args
    dev = torch.device("cuda")
    q = torch.randn(B, Sq, H, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=gen, device=dev).to(dtype)

    def run():
        return kernel(q, k, v, causal=causal, q_offset=q_offset)

    def plain():
        R = MESH_PLAIN_ROWS
        return torch.cat([plain_fn(q[:, i:i + R], k, v, causal=causal,
                                   q_offset=q_offset + i if causal else 0)
                          for i in range(0, Sq, R)], dim=1)

    out = run()
    ref = plain()
    diff = (out.float() - ref.float()).abs()
    tol = TOL[str(dtype).removeprefix("torch.")]
    ok = bool((diff <= tol + tol * ref.float().abs()).all()) and bool(torch.isfinite(out).all())
    err = float(diff.max())
    del out, ref, diff
    library_ms = None
    if q_offset == 0 and (Sq == Sk or not causal):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps=5)
    bound, by = attention_bound(B, Sq, Sk, H, KV, hd, causal, dtype, peaks, q_offset)
    return dict(kernel="flash_attention", shape=[B, Sq, Sk, H, KV, hd], causal=causal,
                q_offset=q_offset, dtype=str(dtype).removeprefix("torch."),
                kernel_route=FLASH_ROUTE[str(dtype).removeprefix("torch.")],
                max_abs_err=err, tol=tol, ok=ok, ms=cuda_ms(run, reps=5),
                plain_ms=eager_ms(plain, reps=2, warm=1), library_ms=library_ms,
                bound_ms=bound, bound_by=by)


def _mesh_ssd_row(args, dtype, gen, peaks, kernel, plain_fn) -> dict:
    import torch

    (B, S, nh, hp), _, _, (_, _, n), _, chunk = args
    dev = torch.device("cuda")
    x = torch.randn(B, S, nh, hp, generator=gen, device=dev).to(dtype)
    dts = (torch.rand(B, S, nh, generator=gen, device=dev) * 0.1).to(dtype)
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device=dev).to(dtype)
    Bc = torch.randn(B, S, n, generator=gen, device=dev).to(dtype)
    Cc = torch.randn(B, S, n, generator=gen, device=dev).to(dtype)
    y, h = kernel(x, dts, A, Bc, Cc, chunk=chunk)
    yr, hr = plain_fn(x, dts, A, Bc, Cc, chunk)
    tol = SSD_TOL[str(dtype).removeprefix("torch.")]
    err = max(float((y - yr).abs().max()), float((h - hr).abs().max()))
    ok = all(bool(((a - b).abs() <= tol + tol * b.abs()).all())
             for a, b in ((y, yr), (h, hr)))
    bound, by, _, _ = ssd_bound_ms(B, S, nh, hp, n, dtype, peaks)
    return dict(kernel="ssd_scan", shape=[B, S, nh, hp, n, chunk],
                dtype=str(dtype).removeprefix("torch."), kernel_route="cuda_core_f32",
                max_abs_err=err, tol=tol, ok=ok,
                ms=cuda_ms(lambda: kernel(x, dts, A, Bc, Cc, chunk=chunk), reps=5),
                plain_ms=cuda_ms(lambda: plain_fn(x, dts, A, Bc, Cc, chunk), reps=5),
                library_ms=None, bound_ms=bound, bound_by=by)


def phase_mesh(one_card, peaks) -> tuple:
    """(a) the 16x16 counts on CUDA fakes against CPU fakes, with each
    cell's replication factor over the one-card count, in
    MESH_COUNT_PARTS children per device, all at once, after every timed
    phase; (b) rank 0's real steps; (c) the 1x1 NCCL mesh; then each
    kernel at (b)'s per-device arguments.  Returns the kernels' launches
    on the mesh path ((b)'s steps and (c)'s prefill) and the kernel rows."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.config import SHAPES, cell_is_supported

    children = {(dev, i): start_mesh_child(f"count_{dev}_{i}")
                for dev in ("cuda", "cpu") for i in range(MESH_COUNT_PARTS)}
    try:
        parts = {key: join_mesh_child(proc) for key, proc in children.items()}
    finally:
        for proc in children.values():
            stop_mesh_child(proc)
    cuda, cpu, seconds = {}, {}, {"cuda": [], "cpu": []}
    for (dev, _), part in parts.items():
        (cuda if dev == "cuda" else cpu).update(part["records"])
        seconds[dev].append(part["seconds"])
    failed = []
    for key, rec in cuda.items():
        arch, shape = key.split()
        ok, why = cell_is_supported(ARCHS[arch], SHAPES[shape])
        row = _mesh_cell_row(rec, one_card.get((arch, shape)))
        diff = _count_diff(rec, cpu[key])
        row["card_equals_cpu"] = not diff
        if diff:
            row["cpu"] = {k: cpu[key].get(k, cpu[key].get("roofline", {}).get(k))
                          for k in diff}
        emit("mesh", **row)
        if rec["status"] != ("ok" if ok else "skipped") or rec.get("reason", "") != why:
            failed.append(f"{key} gave {rec}")
        if diff:
            failed.append(f"{key} differs card vs CPU in {diff}")
        if rec["status"] == "ok" and not rec["roofline"]["collective_bytes_per_device"] > 0:
            failed.append(f"{key} moves no collective byte")
    if len(cuda) != len(ARCHS) * len(DRYRUN_SHAPES) or set(cuda) != set(cpu):
        failed.append(f"counted {len(cuda)} cells on the card, {len(cpu)} on the CPU")
    if failed:
        raise RuntimeError("mesh counts: " + "; ".join(failed))
    emit("mesh", case="counts", seconds=seconds, cells=len(cuda))
    real = join_mesh_child(start_mesh_child("real"))
    nccl = join_mesh_child(start_mesh_child("nccl"))
    launches = {"flash_attention": nccl["flash_launches"], "ssd_scan": 0}
    for row in real["rows"]:
        for name, n in row["launches"].items():
            launches[name] += n
    return launches, _mesh_kernel_rows(peaks, real["rows"])


def main(kernels_only: bool = False) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch under {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)

    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = seconds.get(phase, 0.0) + time.perf_counter() - t0
        return out

    smi, name, peaks = timed("device", phase_device)
    timed("build", phase_build)
    if kernels_only:
        timed("kernel", phase_kernel, peaks)
        timed("decode", phase_decode, peaks)
        timed("ssd", phase_ssd, peaks)
        emit("seconds", **seconds)
        print(smi, flush=True)
        return 0
    return _main_phases(seconds, timed, smi, name, peaks)


def _main_phases(seconds, timed, smi, name, peaks) -> int:
    import torch

    from repro_torch.configs.registry import get_arch

    flash, flash_at = timed("kernel", phase_kernel, peaks)
    decode = timed("decode", phase_decode, peaks)
    ssd, ssd_at = timed("ssd", phase_ssd, peaks)

    launches = {}
    for arch, check, fn, arg in (
            ("qwen2-1.5b", "parity", phase_parity, (512, 512)),
            ("zamba2-1.2b", "parity", phase_parity, (512, 500)),
            ("granite-moe-3b-a800m", "parity", phase_parity_moe, (512, 512)),
            ("falcon-mamba-7b", "decode_check", phase_decode_check, 512),
            ("whisper-large-v3", "parity", phase_parity_encdec, (224, 200))):
        cfg = get_arch(arch)
        launches[arch] = timed(f"serve {arch}", phase_serve, cfg)
        torch.cuda.empty_cache()
        timed(f"{check} {arch}", fn, cfg, arg)
        torch.cuda.empty_cache()
    launches["train"] = timed("train", phase_train, peaks)
    torch.cuda.empty_cache()
    timed("planner", phase_planner)
    eager = timed("continuum", phase_continuum)
    timed("replay", phase_replay, eager)
    timed("fleet", phase_fleet)
    timed("green", phase_green)
    torch.cuda.empty_cache()
    one_card = timed("dryrun", phase_dryrun)
    torch.cuda.empty_cache()
    launches["mesh"], at_mesh = timed("mesh", phase_mesh, one_card, peaks)
    emit("seconds", **seconds)

    entries = []
    decode_at = {"at_long_prompt": decode["long_prompt"], "at_long_doc": decode["long_doc"]}
    for spec, row, also in ((FLASH, flash, flash_at), (DECODE, decode["chat"], decode_at),
                            (SSD, ssd, ssd_at)):
        per_path = {arch: n.get(spec["name"], 0) for arch, n in launches.items()}
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
        for key, at in at_mesh.items():
            if at["kernel"] == spec["name"]:
                entry[f"at_mesh_{key.split('_', 1)[1]}"] = {
                    k: v for k, v in at.items() if k not in ("kernel", "ok", "tol")}
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-child"]:
        sys.exit(mesh_child(sys.argv[2]))
    sys.exit(main(kernels_only=sys.argv[1:2] == ["--kernels"]))
