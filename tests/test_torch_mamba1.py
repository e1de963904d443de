"""The port's mamba1 half (falcon-mamba: the selective scan, the block's
prefill and O(1) decode step, the SSM stack and its cache) against the JAX
package, on the same weights (JAX ``init_from_schema`` carried across with
``params_from_numpy``) and the same numpy inputs, in float32 on the CPU.

Tolerance: the hybrid family's 1e-4, taken of the largest magnitude of the
reference tensor (``test_torch_models.py``'s scaling).  The port's scan is
the reference's odd/even ``associative_scan`` recursion in PyTorch, so its
products associate alike; exp, softplus and the C.h contraction still
round in their own order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model as jm
from repro.models import ops as jops
from repro.models import ssm as jssm
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import init_from_schema as jax_init
from repro.models.testing import reduced as jax_reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models.config import CellTuning
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ops import NOSHARD
from repro_torch.models.testing import reduced
from repro_torch.serve import Request, ServeEngine

from test_torch_serve import _both, _prompts

NAME = "falcon-mamba-7b"
TOL = 1e-4
B = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_scaled(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().float().numpy(), ref,
                               atol=tol * scale, rtol=tol)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced(JAX_ARCHS[NAME])
    jparams = jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(4), jax_build_schema(jcfg), jnp.float32))
    return reduced(ARCHS[NAME]), params_from_numpy(jparams, "cpu"), jcfg, jparams


def _layer(jparams, i=0):
    return {k: v[i] for k, v in jparams["layers"].items()}


# --------------------------------------------------------------------------
# the scan
# --------------------------------------------------------------------------


def _scan_inputs(S, di=16, n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, di), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, n))).astype(np.float32)
    Bc = rng.standard_normal((B, S, n), dtype=np.float32)
    Cc = rng.standard_normal((B, S, n), dtype=np.float32)
    h0 = rng.standard_normal((B, di, n), dtype=np.float32)
    return x, dt, A, Bc, Cc, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [1, 2, 7, 13, 64])
def test_mamba1_scan_matches(S, with_h0):
    x, dt, A, Bc, Cc, h0 = _scan_inputs(S, seed=S)
    h0 = h0 if with_h0 else None
    jy, jh = jssm.mamba1_scan(*map(jnp.asarray, (x, dt, A, Bc, Cc)),
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.mamba1_scan(*map(_t, (x, dt, A, Bc, Cc)),
                              h0=None if h0 is None else _t(h0))
    assert ty.shape == (B, S, 16) and th.shape == (B, 16, 8)
    _close_scaled(ty, jy)
    _close_scaled(th, jh)


def test_mamba1_scan_is_the_recurrence():
    """The log-depth scan equals the step recurrence h_t = a_t h + b_t."""
    x, dt, A, Bc, Cc, h0 = _scan_inputs(29, seed=3)
    tx, tdt, tA, tB, tC, th0 = map(_t, (x, dt, A, Bc, Cc, h0))
    y, hS = tssm.mamba1_scan(tx, tdt, tA, tB, tC, h0=th0)
    h, ys = th0, []
    for t in range(29):
        h = torch.exp(tdt[:, t, :, None] * tA) * h \
            + (tdt[:, t] * tx[:, t])[..., None] * tB[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, tC[:, t]))
    torch.testing.assert_close(y, torch.stack(ys, 1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(hS, h, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------


def test_mamba1_block_prefill_matches(setup):
    cfg, params, jcfg, jparams = setup
    lp = _layer(jparams)
    x = np.random.default_rng(5).standard_normal((B, 11, cfg.d_model),
                                                 dtype=np.float32)
    jout, jst = jssm.mamba1_block(lp, x, jcfg, jops.NOSHARD, return_state=True)
    tout, tst = tssm.mamba1_block(params_from_numpy(lp, "cpu"), _t(x), cfg,
                                  NOSHARD, return_state=True)
    _close_scaled(tout, jout)
    assert set(tst) == set(jst) == {"conv", "ssm"}
    for key in jst:
        assert tuple(tst[key].shape) == jst[key].shape
        _close_scaled(tst[key], jst[key])
    assert tst["ssm"].dtype == torch.float32
    # the states own their storage: no view keeps the whole scan or the
    # input projection alive until the cache is stacked
    for key in ("conv", "ssm"):
        t = tst[key]
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_mamba1_block_decode_matches(setup):
    """One decode step from the reference's prefill state; the port updates
    the cache tensors in place and returns them."""
    cfg, params, jcfg, jparams = setup
    lp = _layer(jparams, 1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 9, cfg.d_model), dtype=np.float32)
    _, jst = jssm.mamba1_block(lp, x, jcfg, jops.NOSHARD, return_state=True)
    x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
    jout, jnew = jssm.mamba1_block(lp, x1, jcfg, jops.NOSHARD, cache=jst)
    cache = {k: _t(v) for k, v in jst.items()}
    tout, tnew = tssm.mamba1_block(params_from_numpy(lp, "cpu"), _t(x1), cfg,
                                   NOSHARD, cache=cache)
    _close_scaled(tout, jout)
    for key in ("conv", "ssm"):
        assert tnew[key] is cache[key]
        _close_scaled(tnew[key], jnew[key])


def test_mamba1_decode_continues_the_scan(setup):
    """Prefill over S tokens then one decode step equals the prefill over
    S + 1 at the last position (the recurrence against the scan)."""
    cfg, params, _, jparams = setup
    lp = params_from_numpy(_layer(jparams, 2), "cpu")
    x = _t(np.random.default_rng(7).standard_normal((B, 10, cfg.d_model),
                                                    dtype=np.float32))
    _, st = tssm.mamba1_block(lp, x[:, :9], cfg, NOSHARD, return_state=True)
    step, _ = tssm.mamba1_block(lp, x[:, 9:], cfg, NOSHARD, cache=st)
    full, _ = tssm.mamba1_block(lp, x, cfg, NOSHARD)
    torch.testing.assert_close(step[:, 0], full[:, -1], atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# the stack
# --------------------------------------------------------------------------


def _tokens(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, n)).astype(np.int32)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_forward_matches(setup, mode):
    cfg, params, jcfg, jparams = setup
    tokens = _tokens(cfg, 8, 13)
    ours, cache, aux = tm.forward(params, cfg, {"tokens": _t(tokens)}, mode=mode)
    ref, jcache, jaux = jm.forward(jparams, jcfg, {"tokens": tokens}, mode=mode,
                                   compute_dtype=jnp.float32)
    assert ours.shape == (B, 13, cfg.vocab_padded) and aux == jaux == {}
    _close_scaled(ours, ref)
    if mode == "train":
        assert cache is None
        return
    assert set(cache) == set(jcache) == {"conv", "ssm", "pos"}
    for key in ("conv", "ssm"):
        assert tuple(cache[key].shape) == jcache[key].shape
        _close_scaled(cache[key], jcache[key])
    assert cache["ssm"].dtype == torch.float32
    assert int(cache["pos"]) == int(jcache["pos"]) == 13


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches(setup, per_slot):
    """One decode step after the reference's prefill; positions as a
    scalar or per slot (the SSM stack only counts them)."""
    cfg, params, jcfg, jparams = setup
    _, jcache, _ = jm.forward(jparams, jcfg, {"tokens": _tokens(cfg, 9, 13)},
                              mode=jm.PREFILL, compute_dtype=jnp.float32)
    pos = np.array([13, 13], np.int32) if per_slot else np.int32(13)
    jcache = dict(jcache, pos=jnp.asarray(pos))
    nxt = np.array([[3], [250]], np.int32)
    jl, jc, _ = jm.forward(jparams, jcfg, {"tokens": nxt}, mode=jm.DECODE,
                           cache=jcache, compute_dtype=jnp.float32)
    cache = {k: _t(v) for k, v in jcache.items()}
    tl, tc, _ = tm.forward(params, cfg, {"tokens": _t(nxt).long()},
                           mode=tm.DECODE, cache=cache)
    _close_scaled(tl, jl)
    for key in ("conv", "ssm"):
        _close_scaled(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_prefill_decode_matches_full_forward(setup):
    """tests/test_models.py's consistency check, within 2e-3."""
    cfg, params, _, _ = setup
    tokens = _t(_tokens(cfg, 10, 16)).long()
    last, cache, _ = tm.forward(params, cfg, {"tokens": tokens}, mode=tm.PREFILL)
    nxt = torch.argmax(last[:, -1, : cfg.vocab], dim=-1)[:, None]
    dl, cache2, _ = tm.forward(params, cfg, {"tokens": nxt}, mode=tm.DECODE,
                               cache=cache)
    assert int(cache2["pos"]) == 17
    full, _, _ = tm.forward(params, cfg, {"tokens": torch.cat([tokens, nxt], 1)})
    err = float((dl[:, -1] - full[:, -1]).abs().max())
    assert err < 2e-3, err


def test_cache_schema_matches_jax():
    cfg = reduced(ARCHS[NAME])
    ours = tm.cache_schema(cfg, batch=3, max_len=40)
    ref = jm.cache_schema(jax_reduced(JAX_ARCHS[NAME]), batch=3, max_len=40)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert ours["ssm"].dtype == torch.float32 and ours["pos"].dtype == torch.int32
    full = tm.cache_schema(ARCHS[NAME], batch=4, max_len=1088)
    jfull = jm.cache_schema(JAX_ARCHS[NAME], batch=4, max_len=1088)
    assert {k: tuple(v.shape) for k, v in full.items()} == \
        {k: tuple(v.shape) for k, v in jfull.items()}


def test_params_from_numpy_carries_mamba1_leaves(setup):
    cfg, params, _, jparams = setup
    assert set(params["layers"]) == set(jparams["layers"]) == {
        "ln", "w_in", "conv_w", "conv_b", "w_xproj", "w_dt", "dt_bias",
        "A_log", "D", "w_out"}
    for key, w in jparams["layers"].items():
        assert tuple(params["layers"][key].shape) == w.shape
        np.testing.assert_array_equal(params["layers"][key].numpy(), w)


# --------------------------------------------------------------------------
# the engine: state lanes written whole
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["lockstep", "staggered", "slot_reuse"])
def test_engine_matches_jax(setup, mode):
    cfg = setup[0]
    if mode == "lockstep":
        prompts, new, kw = _prompts(40, [12] * 3, cfg.vocab), [5] * 3, {}
    elif mode == "staggered":
        prompts, new, kw = _prompts(41, [13, 9], cfg.vocab), [6, 4], \
            dict(ticks_before=3)
    else:
        prompts, new, kw = _prompts(42, [10, 7, 11, 10, 6], cfg.vocab), [3] * 5, {}
    (toks, stats), (jtoks, jstats) = _both(setup, prompts, new, slots=2,
                                           max_len=40, **kw)
    assert toks == jtoks and stats == jstats
    assert stats[1] == len(prompts)


def test_engine_cache_lanes(setup):
    """The pool holds the SSM schema's leaves; the SSM state stays float32
    under a bfloat16 compute dtype, and both lanes take an admission whole."""
    cfg, params = setup[:2]
    engine = ServeEngine(cfg, params, slots=2, max_len=24, device="cpu",
                         tuning=CellTuning(compute_dtype="bfloat16"))
    assert set(engine.cache) == {"conv", "ssm", "pos"}
    assert engine.cache["ssm"].dtype == torch.float32
    assert engine.cache["conv"].dtype == torch.bfloat16
    engine.submit(Request(0, _prompts(43, [10], cfg.vocab)[0], max_new_tokens=3))
    engine._admit()
    assert float(engine.cache["ssm"][:, 0].abs().max()) > 0
    assert float(engine.cache["ssm"][:, 1].abs().max()) == 0
    stats = engine.run_until_drained()
    assert stats.finished == 1 and stats.decoded_tokens == 3
