"""Tests of the port that need the card (marker ``cuda``): the CUDA kernels
against their plain versions, and the engine on the card.  They skip where
there is no CUDA device; on the card run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances, as in tests/test_kernels.py: flash attention f32 2e-5 and bf16
2e-2; the SSD scan f32 5e-4 and bf16 5e-2.  Flash attention takes two
routes by dtype: bfloat16 runs on the tensor cores, float32 on the CUDA
cores; both are held to the same plain version.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, flash_attention, reset_launches, ssd_scan
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", [
    (1, 1024, 1024, 12, 2, 128, True),
    (1, 1000, 1000, 12, 2, 128, True),
    (2, 96, 96, 8, 2, 64, True),
    (2, 64, 128, 4, 4, 32, False),
    (1, 300, 77, 6, 1, 16, False),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(card, B, Sq, Sk, H, KV, hd, causal, dtype):
    g = torch.Generator(device=card).manual_seed(Sq + hd)
    q = torch.randn(B, Sq, H, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=card).to(dtype)
    reset_launches()
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    ref = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _flash_check(card, B, Sq, Sk, H, KV, hd, causal, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=card).to(dtype)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [8, 16, 32, 64, 80, 96, 128, 192, 256])
def test_bf16_tensor_core_route_every_head_dim(card, hd, causal):
    """Every head dim the kernel lists; hd 8 is zero-padded to 16."""
    _flash_check(card, 2, 130, 130, 6, 2, hd, causal, torch.bfloat16, seed=hd)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,causal", [
    (1, 1, 1, 6, 1, True),            # S = 1
    (2, 17, 17, 6, 1, True),          # S = 17, GQA 6:1
    (1, 1000, 1000, 12, 2, True),     # ragged against the 64-row tiles
    (1, 1000, 1000, 8, 8, True),      # MHA
    (2, 17, 300, 4, 4, False),        # Sq < Sk
    (1, 300, 17, 6, 1, False),        # Sq > Sk
])
def test_bf16_tensor_core_route_shapes(card, B, Sq, Sk, H, KV, causal):
    _flash_check(card, B, Sq, Sk, H, KV, 128, causal, torch.bfloat16, seed=Sq + Sk)


def test_kernel_reads_strided_views(card):
    """q/k/v as views into a fused (B, S, H + 2 KV, hd) projection."""
    g = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn(2, 200, 8 + 2 * 2, 64, generator=g, device=card)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("offset", [0, 1])
def test_bf16_kernel_reads_strided_views(card, offset):
    """bf16 q/k/v as views into a fused projection (GQA 6:1, hd 128); with
    offset 1 no row starts on 16 bytes and the tiles load synchronously."""
    B, S, H, KV, hd = 2, 200, 12, 2, 128
    g = torch.Generator(device=card).manual_seed(1)
    flat = torch.randn(B * S * (H + 2 * KV) * hd + offset, generator=g,
                       device=card).to(torch.bfloat16)
    qkv = flat[offset:].view(B, S, H + 2 * KV, hd)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_engine_on_card_launches_kernel_per_layer(card):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.models.testing import reduced
    from repro_torch.serve import Request, ServeEngine

    cfg = reduced(ARCHS["qwen2-1.5b"])
    params = init_from_schema(0, build_schema(cfg), torch.float32, card)
    rng = np.random.default_rng(0)
    reset_launches()
    engine = ServeEngine(cfg, params, slots=2, max_len=48)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=12), max_new_tokens=4)
            for i in range(3)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert LAUNCHES["flash_attention"] == 3 * cfg.n_layers
    assert all(len(r.generated) == 4 for r in reqs)


def _ssd_inputs(card, B, S, nh, hp, n, seed):
    """x, B, C standard normal; dt log-uniform in [1e-3, 1e-1] and
    A = -(1..nh), the ranges of the model's ``dt_bias`` and ``A_log`` init."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(B, S, nh, hp, generator=g, device=card)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(B, S, nh, generator=g, device=card))
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device=card)
    Bc = torch.randn(B, S, n, generator=g, device=card)
    Cc = torch.randn(B, S, n, generator=g, device=card)
    return x, dt, A, Bc, Cc


def _ssd_close(out, ref, dtype):
    tol = 5e-2 if dtype == torch.bfloat16 else 5e-4
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,nh,hp,n,chunk", [
    (1, 1024, 64, 64, 64, 256),      # zamba2's prefill shape
    (1, 1000, 64, 64, 64, 256),      # ragged last chunk
    (2, 77, 3, 40, 6, 16),           # partial column block, n not a multiple of 4
    (1, 50, 2, 16, 8, 64),           # one chunk shorter than the chunk size
    (2, 333, 3, 72, 70, 64),         # 6 chunks, ragged; hp and n past one 64 tile
    (1, 600, 2, 64, 256, 128),       # the largest state, 5 chunks, ragged
    (2, 130, 4, 16, 16, 100),        # chunk not a multiple of the 64-step tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_on_card(card, B, S, nh, hp, n, chunk, dtype):
    x, dt, A, Bc, Cc = _ssd_inputs(card, B, S, nh, hp, n, seed=S + n)
    x, dt, Bc, Cc = (t.to(dtype) for t in (x, dt, Bc, Cc))
    reset_launches()
    out = ssd_scan(x, dt, A, Bc, Cc, chunk=chunk)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1
    assert all(t.dtype == torch.float32 for t in out)
    _ssd_close(out, ssd_scan_plain(x, dt, A, Bc, Cc, chunk=chunk), dtype)


def test_ssd_kernel_reads_strided_views(card):
    """x, B, C as views into one fused projection, dt with a head stride."""
    B, S, nh, hp, n = 2, 300, 4, 32, 16
    g = torch.Generator(device=card).manual_seed(1)
    proj = torch.randn(B, S, nh * hp + 2 * n, generator=g, device=card)
    x = proj[..., : nh * hp].unflatten(-1, (nh, hp))
    Bc, Cc = proj[..., nh * hp: nh * hp + n], proj[..., nh * hp + n:]
    dt = 0.05 * torch.rand(B, S, 2 * nh, generator=g, device=card)[..., ::2]
    A = -torch.arange(1, nh + 1, dtype=torch.float32, device=card)
    out = ssd_scan(x, dt, A, Bc, Cc, chunk=64)
    ref = ssd_scan_plain(*(t.contiguous() for t in (x, dt, A, Bc, Cc)), chunk=64)
    _ssd_close(out, ref, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_state_handoff_to_decode_on_card(card, dtype):
    """The kernel's final state, after 7 chunks with a ragged last one,
    continues into the one-step recurrence as the step oracle does."""
    from repro_torch.kernels.ref import ssd_ref

    B, S, nh, hp, n = 2, 200, 3, 24, 12
    x, dt, A, Bc, Cc = _ssd_inputs(card, B, S + 1, nh, hp, n, seed=5)
    x, dt, Bc, Cc = (t.to(dtype) for t in (x, dt, Bc, Cc))
    y_all, h_all = ssd_ref(x, dt, A, Bc, Cc)
    _, h = ssd_scan(x[:, :S], dt[:, :S], A, Bc[:, :S], Cc[:, :S], chunk=32)
    xf, dtf, Bf, Cf = (t[:, S].float() for t in (x, dt, Bc, Cc))
    h_next = h * torch.exp(dtf * A)[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dtf, xf, Bf)
    y_next = torch.einsum("bhpn,bn->bhp", h_next, Cf)
    _ssd_close((y_next, h_next), (y_all[:, -1], h_all), dtype)


def test_mamba2_decode_continues_kernel_prefill_on_card(card):
    """Reduced zamba2, layer 0: prefill through the SSD kernel, then one
    decode step from its state, against a plain-torch prefill of one token
    more (f32, 5e-4)."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.ops import ShardCtx
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.models.ssm import mamba2_block
    from repro_torch.models.testing import reduced

    cfg = reduced(ARCHS["zamba2-1.2b"])
    params = init_from_schema(0, build_schema(cfg), torch.float32, card)
    p = {k: v[0] for k, v in params["layers"].items()}
    S = 5 * cfg.ssm.chunk + 3
    g = torch.Generator(device=card).manual_seed(2)
    x = torch.randn(2, S + 1, cfg.d_model, generator=g, device=card)
    _, state = mamba2_block(p, x[:, :S], cfg, ShardCtx(ssm_impl="kernel"),
                            return_state=True)
    cache = {k: v.contiguous() for k, v in state.items()}
    out, _ = mamba2_block(p, x[:, S:], cfg, ShardCtx(), cache=cache)
    ref, _ = mamba2_block(p, x, cfg, ShardCtx(ssm_impl="torch"))
    torch.testing.assert_close(out[:, 0], ref[:, -1], atol=5e-4, rtol=5e-4)


def test_hybrid_engine_on_card_launches_kernels(card):
    """Reduced zamba2: the SSD kernel once per mamba2 layer and the flash
    kernel once per shared-block application, per admitted request."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.models.testing import reduced
    from repro_torch.serve import Request, ServeEngine

    cfg = reduced(ARCHS["zamba2-1.2b"])
    params = init_from_schema(0, build_schema(cfg), torch.float32, card)
    rng = np.random.default_rng(0)
    reset_launches()
    engine = ServeEngine(cfg, params, slots=2, max_len=48)
    reqs = [Request(i, rng.integers(0, cfg.vocab, size=13), max_new_tokens=4)
            for i in range(3)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    assert LAUNCHES["ssd_scan"] == 3 * cfg.n_layers
    assert LAUNCHES["flash_attention"] == 3 * (cfg.n_layers // cfg.shared_attn_period)
    assert all(len(r.generated) == 4 for r in reqs)


def _plan_card_and_cpu(problem, cfg_factory):
    from repro_torch.core.scheduler import GreenScheduler

    card = GreenScheduler(cfg_factory(), device="cuda").plan(problem)
    cpu = GreenScheduler(cfg_factory(), device="cpu").plan(problem)
    return card, cpu


def _assert_same_plans(a, b):
    for name in ("placed", "fcur", "ncur", "emissions_g"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.plans == b.plans


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("profile", ["green", "baseline", "oracle"])
def test_planner_card_decides_as_cpu_on_boutique(card, n, profile):
    from repro_torch.configs import boutique
    from repro_torch.core.pipeline import GreenConstraintPipeline
    from repro_torch.core.scheduler import SchedulerConfig

    pipe = GreenConstraintPipeline()
    problem = pipe.problem_for(pipe.run(*boutique.scenario(n)))
    card_res, cpu_res = _plan_card_and_cpu(
        problem, getattr(SchedulerConfig, profile))
    assert card_res.stats.device.startswith("cuda")
    _assert_same_plans(card_res, cpu_res)


@pytest.mark.parametrize("backend,S,N,B", [
    ("dense", 200, 100, 1), ("dense", 200, 100, 4), ("sparse", 500, 100, 1),
    ("sparse", 200, 100, 4)])
def test_planner_card_decides_as_cpu_on_dyadic_synth(card, backend, S, N, B):
    from repro_torch.configs.synth import synth, to_dyadic
    from repro_torch.core.lowering import ScenarioBatch
    from repro_torch.core.problem import PlacementProblem
    from repro_torch.core.scheduler import SchedulerConfig

    # four links per service: several terms in each communication sum
    problem = PlacementProblem.build(*to_dyadic(synth(S, N, links=4)),
                                     backend=backend)
    if B > 1:
        scale = np.arange(4, 4 + B)[:, None] / 4.0
        problem = problem.with_scenarios(
            ScenarioBatch(ci=problem.lowering.ci[None, :] * scale))
    card_res, cpu_res = _plan_card_and_cpu(
        problem, lambda: SchedulerConfig(emission_weight=0.25,
                                         local_search_rounds=2))
    _assert_same_plans(card_res, cpu_res)


def test_planner_sparse_card_runs_are_bitwise_equal(card):
    """The sparse segment sums add in one order on the card, so repeated
    runs of the planner give the same decisions and its move score the
    same bits (float inputs with fan-in: four links per (service,
    flavour), eight into each service; B=2)."""
    from repro_torch.configs.synth import synth
    from repro_torch.core.lowering import ScenarioBatch
    from repro_torch.core.problem import PlacementProblem
    from repro_torch.core.scheduler import (
        GreenScheduler,
        SchedulerConfig,
        _sparse_move_score,
    )

    problem = PlacementProblem.build(*synth(500, 100, links=8),
                                     backend="sparse")
    problem = problem.with_scenarios(ScenarioBatch(
        ci=problem.lowering.ci[None, :] * np.array([[1.0], [0.7]])))
    sched = GreenScheduler(SchedulerConfig(emission_weight=0.3,
                                           local_search_rounds=2))
    first = sched.plan(problem)
    for _ in range(2):
        _assert_same_plans(sched.plan(problem), first)

    low = problem.lowering
    esrc, ef, edst, ek = (torch.tensor(a, device=card).expand(2, -1)
                          for a in low.comm.planner_args())
    w = ek * torch.tensor([[1.0], [0.7]], dtype=torch.float64,
                                device=card)
    static = torch.zeros((2, low.S, low.F, low.N), dtype=torch.float64,
                         device=card)
    state = [torch.tensor(a, device=card)
             for a in (first.placed, first.fcur, first.ncur)]
    want = _sparse_move_score(static, esrc, ef, edst, w, *state)[0]
    for _ in range(4):
        got = _sparse_move_score(static, esrc, ef, edst, w, *state)[0]
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def _continuum_run(device, ticks, scanned=False):
    """chip_smoke.py's paper-scale continuum week (the continuum
    benchmark's scenario), adaptive policy, on ``device``: the eager loop,
    or the fused replay (``scanned``)."""
    from repro_torch.continuum import (
        REGION_PRESETS, CarbonTrace, ContinuumRuntime, RuntimeConfig,
        WhatIfPlanner, WorkloadTrace)
    from repro_torch.core.pipeline import GreenConstraintPipeline
    from repro_torch.core.scheduler import GreenScheduler, SchedulerConfig
    from repro_torch.core.types import (
        Application, CommunicationLink, Flavour, FlavourRequirements,
        Infrastructure, Node, NodeCapabilities, Service)

    services = tuple(Service(f"svc{i}", flavours=(
        Flavour("large", FlavourRequirements(cpu=2.0, ram_gb=4.0)),
        Flavour("small", FlavourRequirements(cpu=1.0, ram_gb=2.0))))
        for i in range(12))
    links = tuple(CommunicationLink(f"svc{i}", f"svc{(i + 1) % 12}")
                  for i in range(0, 12, 2))
    app = Application("continuum-bench", services, links)
    infra = Infrastructure("continuum-bench", tuple(
        Node(f"{r}-{k}", region=r, cost_per_cpu_hour=0.5,
             capabilities=NodeCapabilities(cpu=5.0, ram_gb=24.0))
        for r in ("solar-south", "wind-north", "coal-east")
        for k in range(2)))
    runtime = ContinuumRuntime(
        app, infra, CarbonTrace(REGION_PRESETS, hours=24 + ticks + 25,
                                seed=0),
        WorkloadTrace(app, seed=0),
        config=RuntimeConfig(scenarios=8, hysteresis_g=30.0),
        pipeline=GreenConstraintPipeline(device=device),
        planner=WhatIfPlanner(GreenScheduler(
            SchedulerConfig(emission_weight=1.0), device=device)))
    if scanned:
        result = runtime.run_scanned(24, ticks)
        assert runtime.last_scanned_fallback is None
        return result
    result = runtime.run(24, ticks)
    assert runtime.last_result.plan_stats.device.startswith(device)
    return result


def test_continuum_card_decides_as_cpu(card):
    """Every TickRecord field but the wall-clock timings, and the final
    assignment, equal on the card and on the CPU over 24 ticks."""
    import dataclasses

    timing = ("rebuild_s", "replan_s", "constraint_s", "tick_fused_s")

    def records(result):
        return [{k: v for k, v in dataclasses.asdict(r).items()
                 if k not in timing} for r in result.ticks]

    on_card, on_cpu = _continuum_run("cuda", 24), _continuum_run("cpu", 24)
    assert records(on_card) == records(on_cpu)
    assert on_card.final_assignment == on_cpu.final_assignment


def test_continuum_scanned_card_decides_as_cpu(card):
    """The fused replay of the same 24 ticks: on the card as on the CPU,
    and as the eager loop, every TickRecord field but the timings."""
    import dataclasses

    timing = ("rebuild_s", "replan_s", "constraint_s", "tick_fused_s",
              "compiles")

    def records(result):
        return [{k: v for k, v in dataclasses.asdict(r).items()
                 if k not in timing} for r in result.ticks]

    on_card = _continuum_run("cuda", 24, scanned=True)
    on_cpu = _continuum_run("cpu", 24, scanned=True)
    eager = _continuum_run("cpu", 24)
    assert records(on_card) == records(on_cpu) == records(eager)
    assert on_card.final_assignment == on_cpu.final_assignment \
        == eager.final_assignment


def _fleet_records(device, coupling):
    """plan_many of a 5-app dyadic synthetic fleet on ``device``."""
    from repro_torch.configs.synth import synth_fleet
    from repro_torch.core.problem import PlacementProblem
    from repro_torch.core.scheduler import GreenScheduler, SchedulerConfig
    from repro_torch.fleet import FleetProblem, plan_many

    probs = tuple(PlacementProblem.build(*p)
                  for p in synth_fleet(5, 40, 32, dyadic=True))
    fleet = FleetProblem(apps=probs, coupling=coupling,
                         priority=(5.0, 4.0, 3.0, 2.0, 1.0))
    res = plan_many(fleet, GreenScheduler(
        SchedulerConfig(emission_weight=0.25, local_search_rounds=2),
        device=device))
    stats = res.stats.to_dict()
    stats.pop("plan_time_s")
    stats.pop("compiles")
    return ([(r.placed.tobytes(), r.fcur.tobytes(), r.ncur.tobytes(),
              r.emissions_g.tobytes(), r.plans) for r in res.results],
            res.capacity.cpu_load.tobytes(), res.capacity.ram_load.tobytes(),
            res.capacity.violations, stats)


@pytest.mark.parametrize("coupling", ["none", "waterfill", "price"])
def test_fleet_card_decides_as_cpu(card, coupling):
    """plan_many of one dyadic fleet: every app's decisions, the capacity
    report and the stats equal on the card and on the CPU."""
    on_card = _fleet_records("cuda", coupling)
    assert on_card == _fleet_records("cpu", coupling)
    if coupling == "waterfill":
        assert on_card[3] == 0


def _fleet_runtime_run(device):
    """Three tenants of test_fleet.py's shape on six shared nodes,
    waterfilled, observed, for 3 ticks."""
    import dataclasses

    from repro_torch.continuum import (
        REGION_PRESETS, CarbonTrace, RuntimeConfig, WorkloadTrace)
    from repro_torch.core.types import (
        Application, CommunicationLink, Flavour, FlavourRequirements,
        Infrastructure, Node, NodeCapabilities, Service)
    from repro_torch.fleet import FleetApp, FleetRuntime
    from repro_torch.obs import Observability, billing_report

    def app(tag, n):
        return Application(tag, tuple(
            Service(f"{tag}-svc{i}", flavours=(
                Flavour("large", FlavourRequirements(cpu=2.0, ram_gb=4.0)),
                Flavour("small", FlavourRequirements(cpu=1.0, ram_gb=2.0))))
            for i in range(n)),
            (CommunicationLink(f"{tag}-svc0", f"{tag}-svc1"),))

    infra = Infrastructure("shared", tuple(
        Node(f"{r}-{k}", region=r, cost_per_cpu_hour=0.5,
             capabilities=NodeCapabilities(cpu=8.0, ram_gb=32.0))
        for r in ("solar-south", "wind-north", "coal-east")
        for k in range(2)))
    tenants = [FleetApp(f"tenant{i}", app(f"t{i}", 3 + i),
                        WorkloadTrace(app(f"t{i}", 3 + i), seed=i,
                                      noise=0.0),
                        priority=float(3 - i)) for i in range(3)]
    frt = FleetRuntime(tenants, infra,
                       CarbonTrace(REGION_PRESETS, hours=24, seed=3),
                       config=RuntimeConfig(horizon_h=4),
                       obs=Observability(), device=device)
    res = frt.run(0, 3)
    timing = ("rebuild_s", "replan_s", "constraint_s", "tick_fused_s",
              "compiles")
    records = [{name: {k: v for k, v in dataclasses.asdict(r).items()
                       if k not in timing}
                for name, r in fr.records.items()} for fr in res.ticks]
    return (records, {k: r.final_assignment for k, r in res.results.items()},
            billing_report(frt.obs.ledger),
            sum(fr.violations for fr in res.ticks))


def test_fleet_runtime_card_runs_as_cpu(card):
    on_card = _fleet_runtime_run("cuda")
    assert on_card == _fleet_runtime_run("cpu")
    assert on_card[3] == 0


# --------------------------------------------------------------------------
# the MoE and mamba1 families, and green placement
# --------------------------------------------------------------------------


def _reduced_on_both(name, card):
    """A reduced config (granite keeps padded experts: 5 of 8) and its seeded
    float32 weights on the CPU and on the card."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import cast_params
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.models.testing import reduced

    cfg = reduced(ARCHS[name])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=5, n_experts_padded=8))
    cpu = init_from_schema(0, build_schema(cfg), torch.float32, "cpu")
    return cfg, cpu, cast_params(cpu, torch.float32, card)


def _engine_tokens(cfg, params, device, prompts):
    from repro_torch.serve import Request, ServeEngine

    engine = ServeEngine(cfg, params, slots=2, max_len=48, device=device)
    reqs = [Request(i, p, max_new_tokens=5) for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "falcon-mamba-7b"])
def test_new_families_on_card_match_cpu(card, name):
    """Reduced granite-moe and falcon-mamba on the card against the CPU:
    train and prefill logits (float32; flash's f32 route against its plain
    version) within 1e-4 of their magnitude, prefill + decode against the
    full forward within 2e-3, equal greedy engine tokens, and the flash
    kernel once per attention layer and admission (none for mamba1)."""
    from repro_torch.models import model as tm

    cfg, cpu, gpu = _reduced_on_both(name, card)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 13)))
    for mode in (tm.TRAIN, tm.PREFILL):
        ref, _, ref_aux = tm.forward(cpu, cfg, {"tokens": tokens}, mode=mode)
        out, _, aux = tm.forward(gpu, cfg, {"tokens": tokens.to(card)}, mode=mode)
        scale = max(1.0, float(ref.abs().max()))
        torch.testing.assert_close(out.cpu(), ref, atol=1e-4 * scale, rtol=1e-4)
        assert set(aux) == set(ref_aux)
        for key in ref_aux:
            torch.testing.assert_close(aux[key].cpu(), ref_aux[key],
                                       atol=1e-4, rtol=1e-4)
    last, cache, _ = tm.forward(gpu, cfg, {"tokens": tokens.to(card)}, mode=tm.PREFILL)
    for key in ("k", "v"):
        if key in cache:
            cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 4))
    nxt = torch.argmax(last[:, -1, : cfg.vocab], dim=-1)[:, None]
    dl, _, _ = tm.forward(gpu, cfg, {"tokens": nxt}, mode=tm.DECODE, cache=cache)
    full, _, _ = tm.forward(gpu, cfg, {"tokens": torch.cat([tokens.to(card), nxt], 1)})
    assert float((dl[:, -1] - full[:, -1]).abs().max()) < 2e-3
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (12, 9, 14)]
    reset_launches()
    on_card = _engine_tokens(cfg, gpu, card, prompts)
    per_request = 0 if cfg.moe is None else cfg.n_layers
    assert LAUNCHES == {"flash_attention": 3 * per_request, "ssd_scan": 0}
    assert on_card == _engine_tokens(cfg, cpu, "cpu", prompts)


@pytest.mark.parametrize("rows", [False, True])
def test_moe_combine_is_bitwise_repeatable_on_card(card, rows):
    """granite's routing width (48 padded experts, top-8) over 512 tokens in
    bfloat16: the combine adds each token's contributions in a fixed order,
    so two runs give the same bits."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.moe import moe_mlp
    from repro_torch.models.ops import ShardCtx

    cfg = dataclasses.replace(ARCHS["granite-moe-3b-a800m"], d_model=256, d_ff=128)
    Ep, d, ff = cfg.moe.n_experts_padded, cfg.d_model, cfg.d_ff
    g = torch.Generator(device=card).manual_seed(3)
    p = {"ln": torch.ones(d, device=card, dtype=torch.bfloat16),
         "router": (torch.randn(d, Ep, generator=g, device=card) / 16).bfloat16()}
    for key, shape in (("w_gate", (Ep, d, ff)), ("w_up", (Ep, d, ff)),
                       ("w_down", (Ep, ff, d))):
        p[key] = (torch.randn(*shape, generator=g, device=card)
                  / math.sqrt(shape[1])).bfloat16()
    x = torch.randn(2, 256, d, generator=g, device=card).bfloat16()
    ctx = ShardCtx(moe_row_dispatch=rows)
    a, aux = moe_mlp(p, x, cfg, ctx)
    b, _ = moe_mlp(p, x, cfg, ctx)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert torch.isfinite(a.float()).all() and float(aux["drop_fraction"]) < 0.5


def test_green_placement_card_decides_as_cpu(card):
    """GreenPlacement's four placements of tests/test_green_placement.py and
    its 6-tick run_continuum: card and CPU decide alike, no tolerance."""
    import dataclasses

    from repro_torch.launch.green_placement import (
        GreenPlacement, JobSpec, PodSpec, TrafficSpec)

    train = {"compute_s": 1.2, "memory_s": 8.5, "collective_s": 3.9}
    jobs = [JobSpec("train-a", "yi-9b", "train_4k", {"perf": train}),
            JobSpec("prefill", "yi-9b", "prefill_32k",
                    {"perf": {"compute_s": 0.37, "memory_s": 2.5,
                              "collective_s": 1.15}}, steps_per_h=900.0),
            JobSpec("decode", "yi-9b", "decode_32k",
                    {"perf": {"compute_s": 0.0003, "memory_s": 0.035,
                              "collective_s": 0.003}}, steps_per_h=3.6e6)]
    pods = [PodSpec("clean", "france", carbon=16.0, cost_per_chip_hour=1.3),
            PodSpec("mid", "finland", carbon=120.0, cost_per_chip_hour=1.1),
            PodSpec("dirty", "texas", carbon=410.0, cost_per_chip_hour=0.8)]
    traffic = [TrafficSpec("prefill", "decode", gb_per_h=7200.0),
               TrafficSpec("train-a", "prefill", gb_per_h=40.0)]
    full = [JobSpec(f"train-{i}", "yi-9b", "train_4k", {"perf": train})
            for i in range(5)] + [JobSpec("opt", "yi-9b", "train_4k",
                                          {"perf": train}, must_deploy=False)]
    only = [PodSpec("only", "france", carbon=16.0)]
    for args in ((jobs, pods, ()), (jobs, pods, traffic), (full, only, ()),
                 (full[:4] + full[-1:], only, ())):
        plan, out, stats = GreenPlacement(device="cuda").place(*args)
        plan_c, out_c, stats_c = GreenPlacement(device="cpu").place(*args)
        assert plan == plan_c and stats == stats_c
        assert list(out.constraints) == list(out_c.constraints)
    roof = {"tuned": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5},
            "default": {"compute_s": 1.3, "memory_s": 2.6, "collective_s": 0.6}}
    week = ([JobSpec(f"job{i}", "yi-9b", "train_4k", roofline=roof,
                     flavours_order=("tuned", "default"), steps_per_h=100.0)
             for i in range(3)],
            [PodSpec("pod-ss", "solar-south"), PodSpec("pod-wn", "wind-north")],
            [TrafficSpec("job0", "job1", gb_per_h=20.0)])
    res = GreenPlacement(device="cuda").run_continuum(*week, ticks=6)
    res_c = GreenPlacement(device="cpu").run_continuum(*week, ticks=6)
    strip = dict(compiles=0, rebuild_s=0.0, replan_s=0.0, constraint_s=0.0,
                 tick_fused_s=0.0)
    assert [dataclasses.replace(r, **strip) for r in res.ticks] == \
        [dataclasses.replace(r, **strip) for r in res_c.ticks]
    assert res.final_assignment == res_c.final_assignment
