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

from repro_torch.kernels import (
    LAUNCHES,
    decode_attention,
    flash_attention,
    reset_launches,
    ssd_scan,
)
from repro_torch.kernels.flash_attention import attention_reference
from repro_torch.kernels.ssd_scan import ssd_chunked

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
    ref = attention_reference(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _flash_check(card, B, Sq, Sk, H, KV, hd, causal, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=card).to(dtype)
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("Sq,Sk,q_offset", [(64, 1024, 960), (256, 1024, 512),
                                            (100, 333, 200), (1000, 1000, 0),
                                            (37, 130, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_causal_query_slice_on_card(card, Sq, Sk, q_offset, dtype):
    """A causal slice of query rows against every key (a shard of a
    sequence-sharded q): the kernel against the plain version and against
    the same rows of the square product."""
    g = torch.Generator(device=card).manual_seed(Sq + q_offset)
    q = torch.randn(1, Sk, 6, 64, generator=g, device=card).to(dtype)
    k = torch.randn(1, Sk, 2, 64, generator=g, device=card).to(dtype)
    v = torch.randn(1, Sk, 2, 64, generator=g, device=card).to(dtype)
    rows = q[:, q_offset:q_offset + Sq]
    out = flash_attention(rows, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    ref = attention_reference(rows, k, v, causal=True, q_offset=q_offset)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    square = attention_reference(q, k, v, causal=True)[:, q_offset:q_offset + Sq]
    torch.testing.assert_close(out.float(), square.float(), atol=tol, rtol=tol)


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


@pytest.mark.parametrize("S", [2048, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_the_scale_on_card(card, S, dtype):
    """granite-4.0-h-small's NoPE attention: 32/8 heads of 128, causal,
    scores times 1/128 (not 1/sqrt(128)); q and k drawn so the scores have
    unit variance.  The kernel matches the plain version at that scale and
    differs from its own default-scale output."""
    g = torch.Generator(device=card).manual_seed(S)
    w = 128 ** 0.25
    q = (w * torch.randn(1, S, 32, 128, generator=g, device=card)).to(dtype)
    k = (w * torch.randn(1, S, 8, 128, generator=g, device=card)).to(dtype)
    v = torch.randn(1, S, 8, 128, generator=g, device=card).to(dtype)
    out = flash_attention(q, k, v, causal=True, scale=1 / 128)
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v, causal=True, scale=1 / 128)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    default = flash_attention(q, k, v, causal=True)
    assert float((default.float() - out.float()).abs().max()) > 0.1


def test_kernel_reads_strided_views(card):
    """q/k/v as views into a fused (B, S, H + 2 KV, hd) projection."""
    g = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn(2, 200, 8 + 2 * 2, 64, generator=g, device=card)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = flash_attention(q, k, v, causal=True)
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(),
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
    ref = attention_reference(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


# --------------------------------------------------------------------------
# decode attention
# --------------------------------------------------------------------------

def _decode_close(out, ref):
    """float32 within 1e-5 absolute and relative (the plain version's
    float32 arithmetic in another order of sums); bfloat16 within that plus
    one bf16 ulp of the larger of the two values (each side rounds its
    float32 result once, and the two may fall either side of a rounding
    boundary)."""
    diff = (out.float() - ref.float()).abs()
    lim = 1e-5 + 1e-5 * ref.float().abs()
    if out.dtype == torch.bfloat16:
        a = torch.maximum(out.float().abs(), ref.float().abs())
        lim = lim + torch.exp2(torch.floor(torch.log2(
            a.clamp_min(torch.finfo(torch.bfloat16).tiny))) - 7)
    assert torch.isfinite(out).all()
    assert bool((diff <= lim).all()), float((diff - lim).max())


@pytest.mark.parametrize("B,Sk,H,KV,hd,lens", [
    (256, 2048, 24, 8, 64, "ragged"),     # chat's pool, kv_len 1..2048
    (48, 4016, 24, 8, 64, "ragged"),      # long-prompt's
    (4, 1088, 12, 2, 128, "ragged"),      # qwen2: hd 128, G 6
    (4, 448, 20, 20, 64, "ragged"),       # whisper's self-attention: G 1
    (4, 1536, 20, 20, 64, None),          # its cross-attention: the whole lane
    (3, 40, 4, 2, 16, "ragged"),          # the reduced twins
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_on_card(card, B, Sk, H, KV, hd, lens, dtype):
    g = torch.Generator(device=card).manual_seed(Sk + hd)
    q = torch.randn(B, 1, H, hd, generator=g, device=card).to(dtype)
    k = torch.randn(B, Sk, KV, hd, generator=g, device=card).to(dtype)
    v = torch.randn(B, Sk, KV, hd, generator=g, device=card).to(dtype)
    kv_len = None
    if lens is not None:
        kv_len = torch.randint(1, Sk + 1, (B,), generator=g, device=card, dtype=torch.int32)
        kv_len[0], kv_len[-1] = 1, Sk
    reset_launches()
    out = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == 1
    _decode_close(out, attention_reference(q, k, v, causal=False, kv_len=kv_len))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_takes_the_scale_on_card(card, dtype):
    """granite-4.0-h-small's pool shape (32/8 heads of 128, lanes of 12,800,
    ragged live lengths) with scores times 1/128: the kernel matches the
    plain version at that scale and differs from its default-scale output."""
    B, Sk = 32, 12800
    g = torch.Generator(device=card).manual_seed(128)
    w = 128 ** 0.25
    q = (w * torch.randn(B, 1, 32, 128, generator=g, device=card)).to(dtype)
    k = (w * torch.randn(B, Sk, 8, 128, generator=g, device=card)).to(dtype)
    v = torch.randn(B, Sk, 8, 128, generator=g, device=card).to(dtype)
    kv_len = torch.randint(1, Sk + 1, (B,), generator=g, device=card, dtype=torch.int32)
    kv_len[0], kv_len[-1] = 1, Sk
    out = decode_attention(q, k, v, kv_len, scale=1 / 128)
    torch.cuda.synchronize()
    _decode_close(out, attention_reference(q, k, v, causal=False, kv_len=kv_len,
                                            scale=1 / 128))
    default = decode_attention(q, k, v, kv_len)
    assert float((default.float() - out.float()).abs().max()) > 0.1


def test_decode_kernel_reads_only_the_live_prefix(card):
    """Keys and values past a slot's kv_len are never read: NaN there
    leaves the output finite and unchanged."""
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(8, 1, 24, 64, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(8, 1000, 8, 64, generator=g, device=card).to(torch.bfloat16)
    v = torch.randn(8, 1000, 8, 64, generator=g, device=card).to(torch.bfloat16)
    kv_len = torch.tensor([1, 255, 256, 257, 511, 512, 999, 1000], device=card,
                          dtype=torch.int32)
    out = decode_attention(q, k, v, kv_len)
    for b, n in enumerate(kv_len.tolist()):
        k[b, n:] = float("nan")
        v[b, n:] = float("nan")
    again = decode_attention(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert torch.isfinite(again).all() and torch.equal(out, again)


def test_decode_step_on_card_launches_the_kernel_per_layer(card):
    """A 256-slot engine's decode step on the card (granite's 24/8 heads at
    hd 64, two layers, bf16): the operator once per layer and two kernels
    named decode_attn_* per call in the device trace, which starts after
    the engine captured its decode graph (the first tick), as the
    benchmark's traced slice does: the step traced is a replay.  Then three steps
    from the engine's cache in float32 (where no router tie can flip) on
    both routes: logits within 1e-4 of their magnitude, and no
    synchronisation the plain route does not also make.  The weights are
    the seeded init with attention rescaled to its contracted width, as
    chip_smoke.py's parity phases use them: on the raw init the softmax
    saturates and two orders of the same sums part by ~2e-4 of the logits
    within three steps."""
    import dataclasses
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.train import rescale_attention
    from repro_torch.models.config import CellTuning, MoEConfig
    from repro_torch.models.ops import ShardCtx
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train.steps import make_serve_step

    cfg = dataclasses.replace(
        ARCHS["granite-moe-3b-a800m"], n_layers=2, vocab=1000,
        moe=MoEConfig(n_experts=8, top_k=2, n_experts_padded=8, capacity_factor=4.0))
    params = init_from_schema(0, build_schema(cfg), torch.float32, card)
    rescale_attention(params)
    engine = ServeEngine(cfg, params, slots=256, max_len=512,
                         tuning=CellTuning(compute_dtype="bfloat16"))
    rng = np.random.default_rng(2)
    for i in range(40):
        engine.submit(Request(i, rng.integers(0, cfg.vocab, size=int(rng.integers(8, 300))),
                              max_new_tokens=50))
    engine.tick()                           # admits all 40, one step, the capture
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.tick()
    torch.cuda.synchronize()
    assert engine.stats.decode_graph_replays == 1
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "decode_attn_" in e.name]
    assert LAUNCHES["decode_attention"] == cfg.n_layers
    assert len(kernels) == 2 * cfg.n_layers

    steps = {impl: make_serve_step(cfg, ShardCtx(attention_impl=impl))
             for impl in ("kernel", "torch")}
    caches = {impl: {k: v.float() for k, v in engine.cache.items()} for impl in steps}
    for cache in caches.values():
        cache["pos"] = torch.as_tensor(engine.slot_pos, device=card)
    toks = torch.as_tensor(engine._next_tok[:, None], device=card)
    syncs = {}
    for _ in range(3):
        logits = {}
        for impl, step in steps.items():
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    logits[impl], _ = step(params, caches[impl], toks)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs[impl] = sum("called a synchronizing" in str(w.message) for w in seen)
            caches[impl]["pos"] = caches[impl]["pos"] + 1
        scale = max(1.0, float(logits["torch"].abs().max()))
        torch.testing.assert_close(logits["kernel"], logits["torch"],
                                   atol=1e-4 * scale, rtol=1e-4)
        assert syncs["kernel"] == syncs["torch"]
        toks = logits["torch"][:, : cfg.vocab].argmax(-1)[:, None]


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
    _ssd_close(out, ssd_chunked(x, dt, A, Bc, Cc, chunk), dtype)


@pytest.mark.parametrize("S", [2048, 3000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_granite_4_h_shape_on_card(card, S, dtype):
    """granite-4.0-h-small's mixer: 128 heads of 64, d_state 128, chunk
    256; 2,048 tokens and a ragged 3,000."""
    x, dt, A, Bc, Cc = _ssd_inputs(card, 1, S, 128, 64, 128, seed=S)
    x, dt, Bc, Cc = (t.to(dtype) for t in (x, dt, Bc, Cc))
    out = ssd_scan(x, dt, A, Bc, Cc, chunk=256)
    torch.cuda.synchronize()
    _ssd_close(out, ssd_chunked(x, dt, A, Bc, Cc, 256), dtype)


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
    ref = ssd_chunked(*(t.contiguous() for t in (x, dt, A, Bc, Cc)), 64)
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


# --------------------------------------------------------------------------
# the decode step replayed as a CUDA graph
# --------------------------------------------------------------------------

GRAPH_ARCHS = ["granite-moe-3b-a800m", "granite-4.0-h-small", "qwen2-1.5b",
               "zamba2-1.2b", "falcon-mamba-7b", "whisper-large-v3"]

# (tick, prompt length, max new tokens): staggered admissions into 3 slots,
# more requests than slots (slot reuse), idle slots between them; request 2
# also stops at an EOS (``_graph_schedule``)
GRAPH_REQUESTS = ((0, 11, 6), (2, 7, 12), (2, 14, 9), (5, 9, 8), (9, 5, 5), (9, 13, 4))


def _graph_twin(name, device):
    """A reduced twin of ``name`` (granite-4.0-h-small: two periods' worth
    of M and A layers, 8 experts top-2 plus the shared expert), its seeded
    float32 weights with attention rescaled, on ``device``."""
    import dataclasses

    from repro_torch.configs.granite_4_0_h_small import ARCH as GRANITE_4_H
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.train import rescale_attention
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.models.testing import reduced

    if name == "granite-4.0-h-small":
        cfg = dataclasses.replace(
            reduced(dataclasses.replace(GRANITE_4_H, n_layers=4, layer_pattern="MAMM")),
            moe=MoEConfig(n_experts=8, top_k=2, n_experts_padded=8, capacity_factor=4.0,
                          shared_d_ff=48))
    else:
        cfg = reduced(ARCHS[name])
    params = init_from_schema(0, build_schema(cfg), torch.float32, device)
    rescale_attention(params)
    return cfg, params


def _graph_schedule(cfg, eos=None):
    from repro_torch.serve import Request

    rng = np.random.default_rng(4)
    return [(tick, Request(i, rng.integers(0, cfg.vocab, size=n), max_new_tokens=m,
                           eos_token=eos if i == 2 else None))
            for i, (tick, n, m) in enumerate(GRAPH_REQUESTS)]


def _lockstep(engines, schedule):
    """Tick ``engines`` (name -> engine) side by side on the same requests
    until all are drained.  Returns, per tick, each engine's decode logits
    (None where it decoded nothing), its cache leaves and the kernel calls
    it counted; and each engine's requests."""
    import copy

    reqs = {k: [(t, copy.deepcopy(r)) for t, r in schedule] for k in engines}
    seen = {}
    for name, eng in engines.items():
        step = eng._decode

        def record(params, cache, toks, step=step, name=name):
            logits, new = step(params, cache, toks)
            seen[name] = logits.clone()
            return logits, new

        eng._decode = record
    ticks = []
    for tick in range(200):
        if tick > max(t for t, _ in schedule) and all(
                not e.queue and all(r is None for r in e.slot_req) for e in engines.values()):
            break
        row = {}
        for name, eng in engines.items():
            for t, r in reqs[name]:
                if t == tick:
                    eng.submit(r)
            seen[name] = None
            before = dict(LAUNCHES)
            eng.tick()
            row[name] = (seen[name], {k: v.clone() for k, v in eng.cache.items()},
                         {k: LAUNCHES[k] - before[k] for k in LAUNCHES})
        ticks.append(row)
    return ticks, {k: [r for _, r in v] for k, v in reqs.items()}


@pytest.mark.parametrize("name", GRAPH_ARCHS)
def test_replayed_decode_step_equals_the_eager_step(card, name):
    """Each family's reduced twin in bf16 on 3 slots, over ten or more ticks
    of staggered admissions, slot reuse, idle slots and an EOS: the engine
    that replays its captured decode graph and one that runs the eager step
    every tick give the same logits and the same cache lanes, bit for bit,
    after every tick, count the same kernel calls, and the graph engine
    replays on every decoding tick but the first (its capture)."""
    from repro_torch.models.config import CellTuning
    from repro_torch.serve import ServeEngine

    cfg, params = _graph_twin(name, card)

    def engines():
        out = {kind: ServeEngine(cfg, params, slots=3, max_len=40,
                                 tuning=CellTuning(compute_dtype="bfloat16"))
               for kind in ("graph", "eager")}
        out["eager"]._decode = out["eager"]._graph.step
        return out

    # the EOS: request 2's third token on a first run without one
    _, probe = _lockstep({"eager": engines()["eager"]}, _graph_schedule(cfg))
    eos = probe["eager"][2].generated[2]
    eng = engines()
    ticks, reqs = _lockstep(eng, _graph_schedule(cfg, eos))
    decoding = [i for i, row in enumerate(ticks) if row["eager"][0] is not None]
    assert len(decoding) >= 10
    for i, row in enumerate(ticks):
        (lg, cache, launches), (le, cache_e, launches_e) = row["graph"], row["eager"]
        assert (lg is None) == (le is None), i
        if lg is not None:
            assert torch.equal(lg, le), (i, float((lg.float() - le.float()).abs().max()))
        for key in cache_e:
            assert torch.equal(cache[key], cache_e[key]), (i, key)
        assert launches == launches_e, i
    assert [r.generated for r in reqs["graph"]] == [r.generated for r in reqs["eager"]]
    stop = reqs["eager"][2]
    assert stop.generated[-1] == eos and len(stop.generated) < GRAPH_REQUESTS[2][2]
    assert eng["graph"].stats.decode_graph_replays == len(decoding) - 1
    assert eng["eager"].stats.decode_graph_replays == 0


def test_replay_on_other_cache_tensors_raises(card):
    """The graph holds the pool's tensors: a cache whose leaves were
    replaced after the capture cannot be replayed."""
    from repro_torch.serve import Request, ServeEngine

    cfg, params = _graph_twin("qwen2-1.5b", card)
    engine = ServeEngine(cfg, params, slots=2, max_len=32)
    engine.submit(Request(0, np.arange(5) % cfg.vocab, max_new_tokens=8))
    engine.tick()                           # eager step, then the capture
    engine.tick()                           # a replay
    assert engine.stats.decode_graph_replays == 1
    engine.cache = {k: v.clone() for k, v in engine.cache.items()}
    with pytest.raises(RuntimeError, match="captured on other"):
        engine.tick()


def test_a_failing_capture_raises(card):
    """A step that copies from the host cannot be captured: the runner's
    first call runs it eagerly, then the capture raises, and nothing falls
    back.  In a process of its own, as a failed capture leaves its stream's
    allocations to the graph's pool."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    code = textwrap.dedent("""
        import torch
        from repro_torch.serve.engine import DecodeGraph

        def step(params, cache, tokens):
            # a pageable host-to-device copy, which synchronises
            return tokens * torch.tensor(2, device=tokens.device), cache

        runner = DecodeGraph(step)
        cache = {"pos": torch.zeros(2, dtype=torch.int32, device="cuda")}
        toks = torch.ones(2, 1, dtype=torch.int64, device="cuda")
        try:
            runner({"w": torch.zeros(2, device="cuda")}, cache, toks)
        except RuntimeError as e:
            print("raised:", str(e).splitlines()[0])
        print("graph:", runner._cuda_graph is not None, "replays:", runner.replays)
        """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([src, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "raised:" in out.stdout, out.stdout
    assert "graph: False replays: 0" in out.stdout, out.stdout


# --------------------------------------------------------------------------
# the B=1 prefill replayed as CUDA graphs at 128-token length buckets
# --------------------------------------------------------------------------

# (tick, prompt length, max new tokens): lengths on both sides of bucket
# edges (128, 256), one at the cap (2,048) and one past it (2,049: eager)
PREFILL_REQUESTS = ((0, 5, 4), (0, 127, 5), (1, 128, 4), (1, 129, 6), (3, 300, 5),
                    (4, 2048, 3), (5, 2049, 3), (6, 120, 4), (6, 250, 3))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_prefill_graphs_give_the_eager_engines_tokens(card, name):
    """The dense and the MoE twin in float32 on 3 slots, staggered
    admissions across bucket edges and past the cap: the engine that pads
    and replays its prefill generates the tokens of one that prefills each
    prompt eagerly at its own length.  It captures each bucket it meets
    once (128, 256, 384, 2,048), replays every later prompt of a bucket,
    and prefills the prompt past the cap eagerly."""
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.engine import PREFILL_GRAPH_MAX, prefill_bucket

    cfg, params = _graph_twin(name, card)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=n) for _, n, _ in PREFILL_REQUESTS]
    out = {}
    for kind in ("graph", "eager"):
        engine = ServeEngine(cfg, params, slots=3, max_len=2064)
        if kind == "eager":
            engine._prefill = engine._prefill_graphs.step
        reqs = [Request(i, p, max_new_tokens=m)
                for i, (p, (_, _, m)) in enumerate(zip(prompts, PREFILL_REQUESTS))]
        for tick in range(100):
            for r, (t, _, _) in zip(reqs, PREFILL_REQUESTS):
                if t == tick:
                    engine.submit(r)
            engine.tick()
            if tick > PREFILL_REQUESTS[-1][0] and all(r.done for r in reqs):
                break
        out[kind] = ([r.generated for r in reqs], engine)
    assert out["graph"][0] == out["eager"][0]
    assert all(len(g) == m for g, (_, _, m) in zip(out["graph"][0], PREFILL_REQUESTS))
    graphed = [prefill_bucket(n) for _, n, _ in PREFILL_REQUESTS
               if prefill_bucket(n) <= PREFILL_GRAPH_MAX]
    runner = out["graph"][1]._prefill_graphs
    assert sorted(runner._buckets) == sorted(set(graphed)) == [128, 256, 384, 2048]
    assert out["graph"][1].stats.prefill_graph_replays == len(graphed) - len(set(graphed)) == 4
    assert out["eager"][1].stats.prefill_graph_replays == 0


def test_a_prefill_bucket_is_captured_once_then_replayed(card):
    """Three prompts of one bucket through the granite twin's runner in
    bf16: the first runs eagerly and captures, the others replay.  A
    replay of the first prompt gives the first call's logits and K/V rows
    bit for bit, and each call counts the flash kernel once per layer."""
    from repro_torch.models.config import CellTuning
    from repro_torch.serve import ServeEngine

    cfg, params = _graph_twin("granite-moe-3b-a800m", card)
    engine = ServeEngine(cfg, params, slots=2, max_len=160,
                         tuning=CellTuning(compute_dtype="bfloat16"))
    runner = engine._prefill_graphs
    rng = np.random.default_rng(7)
    first, other = (torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, n)), device=card)
                    for n in (100, 128))
    reset_launches()
    logits, cache = runner(engine.params, {"tokens": first})
    logits, cache = logits.clone(), {k: v[:, :, :100].clone() for k, v in cache.items()
                                     if k != "pos"}
    assert list(runner._buckets) == [128] and runner.replays == 0
    runner(engine.params, {"tokens": other})
    again, cache2 = runner(engine.params, {"tokens": first})
    torch.cuda.synchronize()
    assert list(runner._buckets) == [128] and runner.replays == 2
    assert LAUNCHES["flash_attention"] == 3 * cfg.n_layers
    assert torch.equal(again, logits)
    for key, rows in cache.items():
        assert torch.equal(cache2[key][:, :, :100], rows), key
    with pytest.raises(RuntimeError, match="captured on other"):
        runner(dict(engine.params), {"tokens": first})


def _pool_bytes(pool) -> int:
    """Bytes the card's allocator holds in the graph memory pool ``pool``."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def test_prefill_buckets_share_one_memory_pool(card):
    """A MoE twin wide enough that a prefill's work buffers dominate its
    outputs: capturing the buckets 512, 384, 256 and 128 takes no more of
    the card than capturing 512 alone, plus the smaller buckets' outputs
    (which stay live) and 2 MiB of segment rounding a bucket."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema
    from repro_torch.models.testing import reduced
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(reduced(ARCHS["granite-moe-3b-a800m"]), d_model=512, d_ff=1024)
    params = init_from_schema(0, build_schema(cfg), torch.float32, card)
    rng = np.random.default_rng(8)
    held, outputs = {}, 0
    for buckets in ([512], [512, 384, 256, 128]):
        engine = ServeEngine(cfg, params, slots=1, max_len=520)
        runner = engine._prefill_graphs
        for Sb in buckets:
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, Sb - 3)), device=card)
            runner(engine.params, {"tokens": tokens})
        torch.cuda.synchronize()
        assert sorted(runner._buckets) == sorted(buckets)
        held[len(buckets)] = _pool_bytes(runner._pool)
        if len(buckets) > 1:
            outputs = sum(t.nbytes for Sb in buckets[1:]
                          for t in [runner._buckets[Sb][1][0], *runner._buckets[Sb][1][1].values()])
    assert held[1] > 16 * 2 ** 20, held
    assert held[4] <= held[1] + outputs + 3 * 2 * 2 ** 20, (held, outputs)


@pytest.mark.parametrize("name", ["granite-4.0-h-small", "zamba2-1.2b", "falcon-mamba-7b",
                                  "whisper-large-v3"])
def test_engines_with_state_or_cross_lanes_never_replay_a_prefill(card, name):
    """The hybrid-MoE (granite-4.0-h), hybrid, SSM and encoder-decoder
    twins on the card: their caches hold state lanes or cross K/V, so
    every admission prefills eagerly and no bucket is captured."""
    from repro_torch.serve import Request, ServeEngine

    cfg, params = _graph_twin(name, card)
    engine = ServeEngine(cfg, params, slots=2, max_len=40)
    rng = np.random.default_rng(9)
    for i, n in enumerate((5, 13, 9)):
        engine.submit(Request(i, rng.integers(0, cfg.vocab, size=n), max_new_tokens=4))
    stats = engine.run_until_drained()
    assert stats.finished == 3 and stats.decode_graph_replays > 0
    assert not engine._prefill_graphs.pads
    assert stats.prefill_graph_replays == 0 and engine._prefill_graphs._buckets == {}


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


# decode steps of ``_engine_tokens``: two of its three requests run their 5
# steps side by side on the 2 slots, then the third runs its 5
ENGINE_STEPS = 10


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
    assert LAUNCHES == {"flash_attention": 3 * per_request,
                        "decode_attention": ENGINE_STEPS * per_request, "ssd_scan": 0}
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


# --------------------------------------------------------------------------
# the encoder-decoder family (whisper): flash's non-causal route
# --------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,causal", [(1536, False), (224, False), (224, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_whisper_shapes(card, Sq, causal, dtype):
    """whisper-large-v3's three attentions, 20/20 heads at hd 64: the
    encoder (1536 frames, non-causal), the decoder's cross-attention (224
    prompt tokens over 1536 frames, non-causal) and its self-attention
    (224, causal)."""
    Sk = Sq if causal else 1536
    reset_launches()
    _flash_check(card, 1, Sq, Sk, 20, 20, 64, causal, dtype, seed=Sq + causal)
    assert LAUNCHES["flash_attention"] == 1


def test_whisper_engine_on_card_matches_cpu(card):
    """Reduced whisper (attention rescaled to its contracted width, nonzero
    biases) in float32: prefill logits and all four cache leaves within
    1e-4 of their magnitude of the CPU's, equal greedy engine tokens, and
    the flash kernel three times per decoder layer and admission (encoder,
    decoder self, cross)."""
    import math

    from repro_torch.models import model as tm

    cfg, cpu, _ = _reduced_on_both("whisper-large-v3", card)
    g = torch.Generator().manual_seed(2)
    for group, blocks in (("enc_layers", ("attn",)), ("layers", ("attn", "cross"))):
        for blk in blocks:
            attn = cpu[group][blk]
            d, H, hd = attn["wq"].shape[-3:]
            attn["wq"].mul_(math.sqrt(H / d))
            attn["wk"].mul_(math.sqrt(H / d))
            attn["wv"].mul_(math.sqrt(H / d))
            attn["wo"].mul_(math.sqrt(1.0 / H))
            for key in ("bq", "bk", "bv"):
                attn[key].copy_(0.1 * torch.randn(attn[key].shape, generator=g))
        for key in ("b_up", "b_down"):
            cpu[group]["mlp"][key].copy_(
                0.1 * torch.randn(cpu[group]["mlp"][key].shape, generator=g))
    gpu = tm.cast_params(cpu, torch.float32, card)
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 13)))
    frames = 0.02 * torch.randn(2, cfg.enc_len, cfg.d_model, generator=g)
    ref, ref_cache, _ = tm.forward(cpu, cfg, {"tokens": tokens, "enc_embeds": frames},
                                   mode=tm.PREFILL)
    out, cache, _ = tm.forward(gpu, cfg, {"tokens": tokens.to(card),
                                          "enc_embeds": frames.to(card)}, mode=tm.PREFILL)
    for got, want in [(out, ref)] + [(cache[k], ref_cache[k])
                                     for k in ("k", "v", "cross_k", "cross_v")]:
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, atol=1e-4 * scale, rtol=1e-4)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (12, 9, 14)]
    reset_launches()
    on_card = _engine_tokens(cfg, gpu, card, prompts)
    assert LAUNCHES == {"flash_attention": 3 * 3 * cfg.n_layers,
                        "decode_attention": ENGINE_STEPS * 2 * cfg.n_layers, "ssd_scan": 0}
    assert on_card == _engine_tokens(cfg, cpu, "cpu", prompts)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------


def test_kernels_raise_under_autograd_on_card(card):
    """No kernel has a backward: on a CUDA tensor that needs a gradient
    the wrapper raises before it launches."""
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(1, 64, 4, 32, generator=g, device=card, requires_grad=True)
    k = torch.randn(1, 64, 2, 32, generator=g, device=card)
    x = torch.randn(1, 64, 2, 16, generator=g, device=card, requires_grad=True)
    dt = 0.1 * torch.rand(1, 64, 2, generator=g, device=card)
    A = -torch.rand(2, generator=g, device=card)
    Bc = torch.randn(1, 64, 8, generator=g, device=card)
    reset_launches()
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(x, dt, A, Bc, Bc, chunk=32)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q[:, :1], k, k)
    assert LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    with torch.no_grad():
        flash_attention(q, k, k)
        ssd_scan(x, dt, A, Bc, Bc, chunk=32)
        decode_attention(q[:, :1], k, k)
    assert LAUNCHES == {"flash_attention": 1, "decode_attention": 1, "ssd_scan": 1}


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-1.2b", "whisper-large-v3"])
def test_train_step_on_card_matches_cpu(card, name):
    """Three steps of make_train_step (2 micro-batches, float32, remat) on
    the card and on the CPU from the same weights and batches: loss within
    1e-5 relative, grad_norm within 1e-4, params within 1e-4 of their
    magnitude (Adam eps 1e-3, as tests/test_torch_train.py), and no kernel
    launched on the card.  The weights are the seeded init with attention
    rescaled to its contracted width, as the training CLI's ``--full`` and
    chip_smoke.py's train phase use them: on the raw init the softmax
    saturates, gradient norms reach 47 (qwen2) to 1,132 (whisper), and the
    card and the CPU part by up to 1.1e-3 of them."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import rescale_attention
    from repro_torch.models.config import CellTuning
    from repro_torch.models.model import cast_params
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves

    cfg, cpu, _ = _reduced_on_both(name, card)
    rescale_attention(cpu)
    gpu = cast_params(cpu, torch.float32, card)
    opt = adamw.OptimizerConfig(lr=1e-3, warmup_steps=2, decay_steps=20, eps=1e-3)
    step = make_train_step(cfg, opt, CellTuning(num_microbatches=2, remat=True,
                                                compute_dtype="float32"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=2,
                      enc_len=cfg.enc_len, d_model=cfg.d_model)
    states = {"cpu": (cpu, adamw.init(opt, cpu)), "cuda": (gpu, adamw.init(opt, gpu))}
    reset_launches()
    for i in range(3):
        batch = batch_for_step(dcfg, i)
        metrics = {}
        for dev, (params, state) in states.items():
            b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            params, state, metrics[dev] = step(params, state, b)
            states[dev] = (params, state)
        assert float(metrics["cuda"]["loss"]) == pytest.approx(
            float(metrics["cpu"]["loss"]), rel=1e-5)
        assert float(metrics["cuda"]["grad_norm"]) == pytest.approx(
            float(metrics["cpu"]["grad_norm"]), rel=1e-4)
    assert LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    for got, want in zip(leaves(states["cuda"][0]), leaves(states["cpu"][0])):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got.cpu(), want, atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("arch,shape", [("falcon-mamba-7b", "decode_32k"),
                                        ("zamba2-1.2b", "long_500k")])
def test_dryrun_count_matches_real_step_on_card(card, arch, shape):
    """A cell that fits on the card, counted on fakes on the card
    (``run_cell``) and run for real with the plan's dtypes (seeded weights,
    the cache's zeros): the FLOPs that FlopCounterMode counts on the real
    tensors equal the fake count exactly, and the real peak
    (``max_memory_allocated`` above what was allocated before the
    arguments) is within 5% or 0.5 GB, the larger, of the fake peak."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.plan import build_plan
    from repro_torch.models.model import cache_schema
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema

    rec = run_cell(arch, shape, device=card)
    assert rec["status"] == "ok" and rec["device"] == "cuda"
    plan = build_plan(arch, shape, device=card)
    cfg, B, S = plan.arch, plan.shape.global_batch, plan.shape.seq_len
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=card).manual_seed(0)
    args = (init_from_schema(0, build_schema(cfg),
                             getattr(torch, plan.tuning.param_dtype), card),
            init_from_schema(0, cache_schema(cfg, B, S, enc_len=cfg.enc_len),
                             getattr(torch, plan.tuning.compute_dtype), card),
            torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=card,
                          dtype=torch.int32))
    with FlopCounterMode(display=False) as fc:
        plan.step_fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, _ = plan.step_fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert fc.get_total_flops() == rec["roofline"]["flops_per_device"]
    fake_peak = rec["memory"]["peak_bytes_per_device"]
    assert abs(peak - fake_peak) <= max(0.05 * fake_peak, 0.5e9), (peak, fake_peak)
    assert bool(torch.isfinite(logits).all())


# -- the mesh ------------------------------------------------------------------

@pytest.fixture
def nccl_world(card):
    """A real NCCL process group of one rank on the card, destroyed after."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def _card_mesh():
    from repro_torch.launch.mesh import make_mesh_from_shape

    return make_mesh_from_shape((1, 1), ("data", "model"), "cuda")


@pytest.mark.parametrize("rule", ["replicated", "batch", "heads"])
def test_flash_strategy_on_one_card_mesh_is_the_plain_call(card, nccl_world, rule):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = _card_mesh()
    pl = {"replicated": Replicate(), "batch": Shard(0), "heads": Shard(2)}[rule]
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(2, 256, H, 64, generator=g, device=card).to(torch.bfloat16)
               for H in (8, 2, 2))
    want = flash_attention(q, k, v, causal=True)
    reset_launches()
    got = flash_attention(*(DTensor.from_local(t, mesh, (pl, pl)) for t in (q, k, v)),
                          causal=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert got.placements == (pl, pl)
    assert torch.equal(got.to_local(), want)


@pytest.mark.parametrize("rule", ["replicated", "batch", "heads"])
def test_ssd_strategy_on_one_card_mesh_is_the_plain_call(card, nccl_world, rule):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = _card_mesh()
    R = Replicate()
    pls = {"replicated": (R,) * 5,
           "batch": (Shard(0), Shard(0), R, Shard(0), Shard(0)),
           "heads": (Shard(2), Shard(2), Shard(0), R, R)}[rule]
    g = torch.Generator(device=card).manual_seed(6)
    B, S, nh, hp, n = 2, 256, 4, 32, 16
    x = torch.randn(B, S, nh, hp, generator=g, device=card)
    dt = torch.rand(B, S, nh, generator=g, device=card) * 0.1
    A = -torch.rand(nh, generator=g, device=card)
    Bc = torch.randn(B, S, n, generator=g, device=card)
    Cc = torch.randn(B, S, n, generator=g, device=card)
    want = ssd_scan(x, dt, A, Bc, Cc, chunk=64)
    reset_launches()
    got = ssd_scan(*(DTensor.from_local(t, mesh, (p, p))
                     for t, p in zip((x, dt, A, Bc, Cc), pls)), chunk=64)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_scan"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a.to_local(), b)


MESH_FAMILY_CELLS = [("yi-6b", "prefill_32k"), ("phi3.5-moe-42b-a6.6b", "decode_32k"),
                     ("falcon-mamba-7b", "long_500k"), ("zamba2-1.2b", "prefill_32k"),
                     ("whisper-large-v3", "decode_32k")]


def _reduced_cell(monkeypatch, arch, shape):
    """The registry arch shrunk as ``models.testing.reduced`` and the shape
    cut to 256 positions, as tests/test_torch_sharding.py counts them."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.config import SHAPES
    from repro_torch.models.testing import reduced

    monkeypatch.setitem(ARCHS, arch, reduced(ARCHS[arch]))
    monkeypatch.setitem(SHAPES, shape, dataclasses.replace(SHAPES[shape], seq_len=256))


@pytest.mark.parametrize("arch,shape", MESH_FAMILY_CELLS)
def test_multi_pod_count_on_card_fakes_equals_cpu_fakes(card, monkeypatch, arch, shape):
    from repro_torch.launch.dryrun import run_cell

    _reduced_cell(monkeypatch, arch, shape)
    on_card = run_cell(arch, shape, multi_pod=True, device="cuda")
    on_cpu = run_cell(arch, shape, multi_pod=True, device="cpu")
    assert on_card["status"] == on_cpu["status"] == "ok"
    for key in ("memory", "collectives"):
        assert on_card[key] == on_cpu[key], key
    assert on_card["roofline"] == on_cpu["roofline"]


def test_rank0_real_step_meets_its_fake_count_on_card(card, monkeypatch):
    """Rank 0 of a fake 16x16 world runs zamba2's reduced prefill on real
    CUDA shards: FlopCounterMode's count of its local operators equals the
    fake per-device count, and each kernel launches as often as the count
    calls its operator (``launch.cost.LocalFlopCounter``: DTensor-level
    calls declined, DTensor's own runs at the global shapes skipped)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import cost
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.launch.plan import build_plan
    from repro_torch.tree import leaves

    _reduced_cell(monkeypatch, "zamba2-1.2b", "prefill_32k")
    plan = build_plan("zamba2-1.2b", "prefill_32k", multi_pod=False, device=card)
    with fake_world(plan.chips):
        mesh = make_production_mesh(device_type="cuda")
        with FakeTensorMode():
            fakes = plan.abstract_args(mesh=mesh)
        totals, by_op = cost.analyze_by_op(plan.step_fn, *fakes)
        args = plan.abstract_args(mesh=mesh)
        g = torch.Generator(device=card).manual_seed(0)
        for t in leaves(args):
            local = t.to_local()
            if local.is_floating_point():
                local.normal_(0.0, 0.02, generator=g)
            else:
                local.random_(0, plan.arch.vocab, generator=g)
        reset_launches()
        with cost.LocalFlopCounter() as fc:
            plan.step_fn(*args)
        torch.cuda.synchronize()
    assert fc.get_total_flops() == totals.flops
    for name in ("flash_attention", "ssd_scan"):
        assert LAUNCHES[name] == by_op[name][2] > 0, name
