"""The port's mamba2 ops (``repro_torch.models.ssm``) against the JAX package's
``repro.models.ssm``, on the same numpy inputs and the same weights (JAX
``init_from_schema`` carried across with ``params_from_numpy``), float32 on
the CPU.

Tolerances: 1e-5 for the convolutions and one mamba2 block (float32, only
the summation order differs); 1e-4 for the SSD scan paths and the state
handoff, as tests/test_kernels.py holds the TPU kernel to the chunked path
and to the decode recurrence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import ssm as jssm
from repro.models.ops import NOSHARD as JAX_NOSHARD
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import init_from_schema as jax_init
from repro.models.testing import reduced as jax_reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ref import ssd_ref
from repro_torch.kernels.ssd_scan import segsum, ssd_chunked
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ops import ShardCtx
from repro_torch.models.testing import reduced

TOL = dict(atol=1e-5, rtol=1e-5)
SSD_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _ssd_inputs(B, S, nh, hp, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, hp), dtype=np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, nh))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh)).astype(np.float32)
    Bc = rng.standard_normal((B, S, n), dtype=np.float32)
    Cc = rng.standard_normal((B, S, n), dtype=np.float32)
    return x, dt, A, Bc, Cc


def test_causal_conv_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    b = rng.standard_normal(24, dtype=np.float32)
    _close(tssm.causal_conv(_t(x), _t(w), _t(b)), jssm.causal_conv(x, w, b))


def test_conv_step_matches():
    rng = np.random.default_rng(1)
    x_t = rng.standard_normal((3, 24), dtype=np.float32)
    state = rng.standard_normal((3, 3, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    b = rng.standard_normal(24, dtype=np.float32)
    out, new = tssm.conv_step(_t(x_t), _t(state), _t(w), _t(b))
    jout, jnew = jssm.conv_step(x_t, state, w, b)
    _close(out, jout)
    _close(new, jnew)


def test_segsum_matches():
    dtA = -np.abs(np.random.default_rng(2).standard_normal((3, 9), dtype=np.float32))
    ours = segsum(_t(dtA)).numpy()
    ref = np.asarray(jssm.segsum(dtA))
    np.testing.assert_array_equal(np.isinf(ours), np.isinf(ref))
    live = ~np.isinf(ref)
    np.testing.assert_allclose(ours[live], ref[live], **TOL)


@pytest.mark.parametrize("S,chunk", [(128, 32), (100, 32), (20, 64)])
def test_ssd_chunked_matches_jax(S, chunk):
    args = _ssd_inputs(2, S, 4, 16, 8, seed=S)
    y, h = ssd_chunked(*(_t(a) for a in args), chunk)
    yj, hj = jssm.ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    _close(y, yj, **SSD_TOL)
    _close(h, hj, **SSD_TOL)


@pytest.mark.parametrize("scan", ["kernel", "chunked"])
def test_ssd_state_handoff_to_decode(scan):
    """The prefill state continues exactly into the one-step recurrence, as
    tests/test_kernels.py checks for the TPU kernel: the serve path depends
    on it."""
    B, S, nh, hp, n = 1, 64, 2, 16, 8
    x, dt, A, Bc, Cc = (_t(a) for a in _ssd_inputs(B, S + 1, nh, hp, n, seed=11))
    y_all, h_all = ssd_ref(x, dt, A, Bc, Cc)
    first = (x[:, :S], dt[:, :S], A, Bc[:, :S], Cc[:, :S])
    if scan == "kernel":
        _, h = ssd_scan(*first, chunk=32)
    else:
        _, h = ssd_chunked(*first, 32)
    dt_l = dt[:, S]
    upd = torch.einsum("bh,bhp,bn->bhpn", dt_l, x[:, S], Bc[:, S])
    h_next = h * torch.exp(dt_l * A)[..., None, None] + upd
    y_next = torch.einsum("bhpn,bn->bhp", h_next, Cc[:, S])
    _close(h_next, h_all.numpy(), **SSD_TOL)
    _close(y_next, y_all[:, -1].numpy(), **SSD_TOL)


# --------------------------------------------------------------------------
# mamba2 block
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """Layer 1 of reduced zamba2's weights, with nonzero conv biases so the
    bias path is exercised."""
    jcfg = jax_reduced(JAX_ARCHS["zamba2-1.2b"])
    jparams = jax_init(jax.random.PRNGKey(0), jax_build_schema(jcfg), jnp.float32)
    lp = {k: np.array(v[1]) for k, v in jparams["layers"].items()}
    rng = np.random.default_rng(3)
    for key in ("conv_x_b", "conv_B_b", "conv_C_b"):
        lp[key] = (0.1 * rng.standard_normal(lp[key].shape)).astype(np.float32)
    cfg = reduced(ARCHS["zamba2-1.2b"])
    return cfg, params_from_numpy(lp, "cpu"), jcfg, {k: jnp.asarray(v) for k, v in lp.items()}


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("S", [16, 13])
def test_mamba2_block_prefill_matches(block, impl, S):
    """Prefill with state; S = 13 is not a multiple of the chunk (8)."""
    cfg, p, jcfg, jp = block
    x = np.random.default_rng(4).standard_normal((2, S, cfg.d_model), dtype=np.float32)
    out, st = tssm.mamba2_block(p, _t(x), cfg, ShardCtx(ssm_impl=impl),
                                return_state=True)
    jctx = dataclasses.replace(JAX_NOSHARD, ssm_impl="pallas" if impl == "kernel" else "xla")
    jout, jst = jssm.mamba2_block(jp, jnp.asarray(x), jcfg, jctx, return_state=True)
    _close(out, jout)
    assert set(st) == set(jst) == set(tssm.STATE_KEYS)
    for key in tssm.STATE_KEYS:
        assert tuple(st[key].shape) == jst[key].shape
        _close(st[key], jst[key])
    assert st["ssm"].dtype == torch.float32


def test_mamba2_block_decode_matches_and_updates_in_place(block):
    cfg, p, jcfg, jp = block
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    K, di, n = cfg.ssm.d_conv, cfg.d_inner, cfg.ssm.d_state
    nh = di // cfg.ssm.head_dim
    cache = {"conv_x": rng.standard_normal((3, K - 1, di), dtype=np.float32),
             "conv_B": rng.standard_normal((3, K - 1, n), dtype=np.float32),
             "conv_C": rng.standard_normal((3, K - 1, n), dtype=np.float32),
             "ssm": 0.1 * rng.standard_normal((3, nh, cfg.ssm.head_dim, n),
                                              dtype=np.float32)}
    ours_cache = {k: _t(v) for k, v in cache.items()}
    lanes = dict(ours_cache)
    out, new = tssm.mamba2_block(p, _t(x), cfg, ShardCtx(), cache=ours_cache)
    jout, jnew = jssm.mamba2_block(jp, jnp.asarray(x), jcfg, JAX_NOSHARD,
                                   cache={k: jnp.asarray(v) for k, v in cache.items()})
    _close(out, jout)
    for key in tssm.STATE_KEYS:
        assert new[key] is lanes[key]          # written in place
        _close(new[key], jnew[key])
