#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  — the card's name and power limit (nvidia-smi), torch/CUDA
               versions; TF32 is turned off for matmuls and cuDNN.
  2. build   — nvcc builds every kernel under src/repro_torch/kernels/csrc,
               one process per source, all started together.
  3. kernel  — flash attention against its plain PyTorch version on the card
               at the serving shapes (qwen2-1.5b and zamba2-1.2b's shared
               block) and the repo's test shapes, with its time, the plain
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
  5. serve   — per model (qwen2-1.5b, then zamba2-1.2b) at full width and
               depth in bf16, seeded random weights, ServeEngine(slots=4,
               max_len=1088): 8 requests of 1024 prompt tokens and 32 new
               tokens each.  Launch counts are zeroed just before and read
               just after; each kernel of the model's path must run exactly
               once per layer (flash: per attention layer or shared-block
               application; ssd: per mamba2 layer) per admitted request.
  6. parity  — the same model in float32, 2 requests (512 and 512 tokens
               for qwen2, 512 and 500 for zamba2), 8 new tokens, with the
               kernels and with the plain torch paths: equal greedy tokens,
               prefill logits within 1e-3.

Then one line {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises, so the script exits
non-zero and prints no result; so does a run without a card or outside a
checkout of the repository.
"""
from __future__ import annotations

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
    for (B, S, H, KV, hd) in ATTN_SHAPES:
        for dt in ("float32", "bfloat16"):
            for causal in (True, False):
                cases.append(((B, S, S, H, KV, hd), causal, dt, 1.0, "tests"))
    cases.append(((1, 96, 96, 2, 2, 16), True, "float32", 1.0, "S=96"))
    cases.append(((2, 64, 128, 4, 4, 32), False, "float32", 1.0, "cross"))
    cases.append(((1, 128, 128, 2, 2, 32), True, "float32", 8.0, "logits~40"))

    main_entry = zamba_entry = None
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
        if what in ("slice", "zamba2"):
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
            elif Sq == 1024 and dt == "bfloat16":
                main_entry = row
        emit("kernel", **row)
        if not ok:
            raise RuntimeError(f"flash_attention disagrees with its plain version: {row}")
    return main_entry, zamba_entry


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

    smi, name, peaks = phase_device()
    phase_build()
    flash, flash_zamba = phase_kernel(peaks)
    ssd = phase_ssd(peaks)

    launches = {}
    for arch, prompt_lens in (("qwen2-1.5b", (512, 512)),
                              ("zamba2-1.2b", (512, 500))):
        cfg = get_arch(arch)
        launches[arch] = phase_serve(cfg)
        torch.cuda.empty_cache()
        phase_parity(cfg, prompt_lens)
        torch.cuda.empty_cache()

    entries = []
    for spec, row, also in ((FLASH, flash, flash_zamba), (SSD, ssd, None)):
        per_path = {arch: n[spec["name"]] for arch, n in launches.items()}
        entry = dict(spec, launches=sum(per_path.values()),
                     launches_per_path=per_path, max_abs_err=row["max_abs_err"],
                     ms=row["ms"], plain_ms=row["plain_ms"],
                     bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=row["library_ms"], shape=row["shape"],
                     dtype=row["dtype"], kernel_route=row["kernel_route"])
        if "pass_ms" in row:
            entry["pass_ms"] = row["pass_ms"]
        if also is not None:
            entry["at_zamba2"] = {k: also[k] for k in (
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
