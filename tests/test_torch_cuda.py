"""Tests of the port that need the card (marker ``cuda``): the CUDA kernels
against their plain versions, and the engine on the card.  They skip where
there is no CUDA device; on the card run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances, as in tests/test_kernels.py: flash attention f32 2e-5 and bf16
2e-2; the SSD scan f32 5e-4 and bf16 5e-2.
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


def test_kernel_reads_strided_views(card):
    """q/k/v as views into a fused (B, S, H + 2 KV, hd) projection."""
    g = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn(2, 200, 8 + 2 * 2, 64, generator=g, device=card)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = flash_attention(q, k, v, causal=True)
    ref = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


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
