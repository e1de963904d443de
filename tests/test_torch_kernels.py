"""The port's flash attention on the CPU (the kernel's plain version) against
the JAX package's Pallas kernel in interpret mode, on the same numpy inputs.

Tolerances are those of tests/test_kernels.py: f32 2e-5 (summation order
differs), bf16 2e-2 (both sides take the same bf16 inputs and compute in f32;
the output is rounded to bf16 once, which is within one bf16 ulp at |o| < 1),
and 1e-4 for logits around 40.  The JAX wrapper runs at its default blocks
(one block per sequence at these sizes) to keep interpret mode fast; its
tiling is covered by tests/test_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash
from repro_torch.kernels import LAUNCHES, flash_attention, reset_launches
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.ref import attention_ref

# the shape list of tests/test_kernels.py: (B, S, H, KV, hd)
ATTN_SHAPES = [
    (1, 128, 4, 4, 32),      # MHA
    (2, 256, 8, 2, 64),      # GQA 4:1
    (1, 192, 6, 1, 16),      # MQA
    (2, 64, 4, 4, 128),      # single block
    (1, 512, 2, 2, 8),       # long seq, tiny heads
]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def _inputs(B, Sq, Sk, H, KV, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = scale * rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = scale * rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    return q, k, v


def _both(q, k, v, *, causal, dtype="float32"):
    """(port output, JAX output) as float32 numpy arrays."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ours = flash_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                           causal=causal)
    ref = jax_flash(*(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal,
                    interpret=True)
    assert ours.dtype == td
    return ours.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_kernel(B, S, H, KV, hd, dtype, causal):
    q, k, v = _inputs(B, S, S, H, KV, hd, seed=S + H)
    ours, ref = _both(q, k, v, causal=causal, dtype=dtype)
    np.testing.assert_allclose(ours, ref, **_tol(dtype))


def test_flash_attention_s96():
    q, k, v = _inputs(1, 96, 96, 2, 2, 16, seed=0)
    ours, ref = _both(q, k, v, causal=True)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)


def test_flash_attention_cross_lengths_non_causal():
    q, k, v = _inputs(2, 64, 128, 4, 4, 32, seed=3)
    ours, ref = _both(q, k, v, causal=False)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)


def test_flash_attention_large_logits():
    q, k, v = _inputs(1, 128, 128, 2, 2, 32, seed=5, scale=8.0)
    ours, ref = _both(q, k, v, causal=True)
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_naive_oracle(causal):
    """The plain version against the port's independent oracle."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 80, 80, 6, 2, 16, seed=7))
    np.testing.assert_allclose(
        flash_attention_plain(q, k, v, causal=causal).numpy(),
        attention_ref(q, k, v, causal=causal).numpy(), atol=2e-5, rtol=2e-5)


def test_cpu_call_leaves_launch_count_at_zero():
    reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 2, 1, 16, seed=1))
    flash_attention(q, k, v, causal=True)
    assert LAUNCHES == {"flash_attention": 0}


def test_causal_needs_equal_lengths():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 32, 2, 2, 8, seed=2))
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, k, v, causal=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU input raises."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 16, 2, 2, 8, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, causal=True)
