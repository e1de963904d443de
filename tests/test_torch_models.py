"""The port's model ops and dense forward against the JAX package, on the same
weights (JAX ``init_from_schema`` carried across with ``params_from_numpy``)
and the same numpy inputs, in float32 on the CPU.

Tolerance 1e-5 throughout: both sides compute in float32 and differ only in
summation order.  For KV caches the 1e-5 is taken of the tensor's largest
magnitude: their entries grow to ~15 by the last layer on random weights,
where float32 ordering differences of a few ulp, carried through the layers,
exceed an absolute 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model as jm
from repro.models import ops as jops
from repro.models.config import CellTuning as JaxTuning
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import ParamSchema as JaxPS
from repro.models.sharding import init_from_schema as jax_init
from repro.models.testing import reduced as jax_reduced
from repro.train.steps import make_prefill_step as jax_prefill_step
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model as tm
from repro_torch.models import ops as tops
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ops import ShardCtx
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import ParamSchema, init_from_schema
from repro_torch.models.testing import reduced
from repro_torch.train.steps import make_prefill_step

TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 16
IMPLS = ["kernel", "torch"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().float().numpy(),
                               np.asarray(ref, np.float32), **(tol or TOL))


def _close_cache(ours, ref):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    _close(ours, ref, atol=1e-5 * scale, rtol=1e-5)


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    s = rng.standard_normal(64, dtype=np.float32)
    _close(tops.rms_norm(_t(x), _t(s), 1e-5), jops.rms_norm(x, s, 1e-5))


@pytest.mark.parametrize("per_slot", [False, True])
def test_rotary_matches(per_slot):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 4, 16), dtype=np.float32)
    if per_slot:   # (B, S) positions, as the per-slot decode path builds
        pos = rng.integers(0, 1000, size=(3, 7))
    else:
        pos = np.arange(7) + 100
    _close(tops.rotary(_t(x), _t(pos), 1e6), jops.rotary(x, jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("kv_len", [None, 9, "vector"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches(kv_len, causal):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 4, 4, 16), dtype=np.float32)
    k = rng.standard_normal((3, 12, 2, 16), dtype=np.float32)
    v = rng.standard_normal((3, 12, 2, 16), dtype=np.float32)
    if kv_len == "vector":    # (B,) per-slot lengths of continuous batching
        kv_len = np.array([3, 12, 7], np.int32)
    ours = tops.attention_reference(
        _t(q), _t(k), _t(v), causal=causal, q_offset=5,
        kv_len=None if kv_len is None else torch.as_tensor(kv_len))
    ref = jops.attention_reference(
        q, k, v, causal=causal, q_offset=5,
        kv_len=None if kv_len is None else jnp.asarray(kv_len))
    _close(ours, ref)


def test_attention_chunked_matches():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 48, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 48, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 48, 2, 16), dtype=np.float32)
    _close(tops.attention_chunked(_t(q), _t(k), _t(v), causal=True, q_chunk=16),
           jops.attention_chunked(q, k, v, causal=True, q_chunk=16))


# --------------------------------------------------------------------------
# schema and init
# --------------------------------------------------------------------------


def _shapes(schema, leaf_type):
    if isinstance(schema, leaf_type):
        return tuple(schema.shape)
    return {k: _shapes(v, leaf_type) for k, v in schema.items()}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_schema_and_init_shapes_match_jax(name):
    assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(JAX_ARCHS[name])
    full = _shapes(build_schema(ARCHS[name]), ParamSchema)
    assert full == _shapes(jax_build_schema(JAX_ARCHS[name]), JaxPS)
    small = reduced(ARCHS[name])
    params = init_from_schema(0, build_schema(small), torch.float32, "cpu")
    got = jax.tree.map(lambda t: tuple(t.shape), params)
    assert got == _shapes(jax_build_schema(jax_reduced(JAX_ARCHS[name])), JaxPS)


def test_init_is_seeded():
    cfg = reduced(ARCHS["qwen2-1.5b"])
    a = init_from_schema(3, build_schema(cfg), torch.float32, "cpu")
    b = init_from_schema(3, build_schema(cfg), torch.float32, "cpu")
    c = init_from_schema(4, build_schema(cfg), torch.float32, "cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-1.2b",
                                  "whisper-large-v3", "phi3.5-moe-42b-a6.6b"])
def test_unported_family_raises(name):
    cfg = reduced(ARCHS[name])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tm.forward({}, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)})


# --------------------------------------------------------------------------
# dense forward: train, prefill, decode
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    jcfg = jax_reduced(JAX_ARCHS["qwen2-1.5b"])
    jparams = jax_init(jax.random.PRNGKey(0), jax_build_schema(jcfg), jnp.float32)
    # nonzero qkv biases, so the bias path is exercised
    rng = np.random.default_rng(9)
    attn = dict(jparams["layers"]["attn"])
    for key in ("bq", "bk", "bv"):
        attn[key] = jnp.asarray(0.1 * rng.standard_normal(attn[key].shape), jnp.float32)
    jparams = dict(jparams, layers=dict(jparams["layers"], attn=attn))
    cfg = reduced(ARCHS["qwen2-1.5b"])
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return cfg, params, jcfg, jparams, tokens


@pytest.mark.parametrize("impl", IMPLS)
def test_train_forward_matches(qwen, impl):
    cfg, params, jcfg, jparams, tokens = qwen
    ours, cache, _ = tm.forward(params, cfg, {"tokens": _t(tokens)},
                                ctx=ShardCtx(impl), mode=tm.TRAIN)
    ref, _, _ = jm.forward(jparams, jcfg, {"tokens": tokens}, mode=jm.TRAIN,
                           compute_dtype=jnp.float32)
    assert cache is None and ours.shape == (B, S, cfg.vocab_padded)
    _close(ours, ref)


def _jax_prefill(jcfg, jparams, tokens):
    return jm.forward(jparams, jcfg, {"tokens": tokens}, mode=jm.PREFILL,
                      compute_dtype=jnp.float32)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_forward_and_cache_match(qwen, impl):
    cfg, params, jcfg, jparams, tokens = qwen
    ours, cache, _ = tm.forward(params, cfg, {"tokens": _t(tokens)},
                                ctx=ShardCtx(impl), mode=tm.PREFILL)
    ref, jcache, _ = _jax_prefill(jcfg, jparams, tokens)
    _close(ours, ref)
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        _close_cache(cache[key], jcache[key])
    assert int(cache["pos"]) == int(jcache["pos"]) == S


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_step_last_logits_match(qwen, impl):
    cfg, params, jcfg, jparams, tokens = qwen
    last, _ = make_prefill_step(cfg, ShardCtx(impl))(params, {"tokens": _t(tokens)})
    jlast, _ = jax_prefill_step(jcfg, JaxTuning(compute_dtype="float32"))(
        jparams, {"tokens": tokens})
    _close(last, jlast)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches(qwen, per_slot):
    """One decode step against a padded prefill cache; per-slot positions
    put each sequence at its own length (lane-indexed writes, per-slot rope
    and kv_len)."""
    cfg, params, jcfg, jparams, tokens = qwen
    _, jcache, _ = _jax_prefill(jcfg, jparams, tokens)
    pad = [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]
    kc, vc = (np.pad(np.asarray(jcache[k]), pad) for k in ("k", "v"))
    pos = np.array([S, S - 5], np.int32) if per_slot else np.int32(S)
    nxt = np.array([[3], [250]], np.int32)
    jl, jc, _ = jm.forward(jparams, jcfg, {"tokens": nxt}, mode=jm.DECODE,
                           cache={"k": kc, "v": vc, "pos": jnp.asarray(pos)},
                           compute_dtype=jnp.float32)
    cache = {"k": _t(kc), "v": _t(vc), "pos": torch.as_tensor(pos)}
    tl, tc, _ = tm.forward(params, cfg, {"tokens": _t(nxt).long()},
                           mode=tm.DECODE, cache=cache)
    _close(tl, jl)
    for key in ("k", "v"):
        _close_cache(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_needs_cache(qwen):
    cfg, params, _, _, tokens = qwen
    with pytest.raises(ValueError):
        tm.forward(params, cfg, {"tokens": _t(tokens)}, mode=tm.DECODE)


def test_cache_schema_matches_jax():
    cfg = reduced(ARCHS["yi-6b"])
    ours = tm.cache_schema(cfg, batch=3, max_len=40)
    ref = jm.cache_schema(jax_reduced(JAX_ARCHS["yi-6b"]), batch=3, max_len=40)
    assert _shapes(ours, ParamSchema) == _shapes(ref, JaxPS)
    assert ours["pos"].dtype == torch.int32


def test_cast_params_casts_once_and_keeps_non_float32():
    p = {"a": torch.ones(2), "b": {"c": torch.ones(2, dtype=torch.int32)}}
    out = tm.cast_params(p, torch.bfloat16, "cpu")
    assert out["a"].dtype == torch.bfloat16 and out["b"]["c"].dtype == torch.int32
    assert tm.cast_params(out, torch.bfloat16, "cpu")["a"] is out["a"]
