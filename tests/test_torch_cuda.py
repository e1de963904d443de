"""Tests of the port that need the card (marker ``cuda``): the CUDA kernel
against its plain version, and the engine on the card.  They skip where
there is no CUDA device; on the card run them with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Tolerances: f32 2e-5 and bf16 2e-2, as in tests/test_kernels.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, flash_attention, reset_launches
from repro_torch.kernels.flash_attention import flash_attention_plain

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
