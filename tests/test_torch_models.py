"""The port's model ops and dense forward against the JAX package, on the same
weights (JAX ``init_from_schema`` carried across with ``params_from_numpy``)
and the same numpy inputs, in float32 on the CPU.

Tolerance 1e-5 for the dense family: both sides compute in float32 and
differ only in summation order.  For KV caches the 1e-5 is taken of the
tensor's largest magnitude: their entries grow to ~15 by the last layer on
random weights, where float32 ordering differences of a few ulp, carried
through the layers, exceed an absolute 1e-5.

The hybrid family (reduced zamba2: 5 mamba2 layers, the shared block
applied twice) is held at 1e-4, the tolerance tests/test_kernels.py holds
the SSD kernel to against the chunked path: one mamba2 block agrees to
~1e-6 of its output (tests/test_torch_ssm.py), and the differences grow
through nine blocks to ~5e-5 of logits of magnitude ~5.  The JAX side runs
with ``ssm_impl="pallas"`` (interpret mode) and with ``"xla"``.
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
from repro_torch.kernels.flash_attention import attention_reference
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


def _rotary_building_freqs(x, positions, theta):
    """``rotary`` as it was before its frequencies were kept: built from a
    host copy of ``theta`` on every call."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    angles = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x2 = x.reshape(*x.shape[:-1], half, 2)
    x_even, x_odd = x2[..., 0], x2[..., 1]
    out = torch.stack([x_even * cos - x_odd * sin, x_even * sin + x_odd * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["prefill", "decode"])
@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
@pytest.mark.parametrize("hd", [64, 128])
def test_rotary_with_kept_freqs_is_bit_equal(hd, theta, where, dtype):
    """The kept frequencies give the bits the per-call build gave: at the
    prefill's positions (arange S) and the decode step's per-slot
    positions ((B, 1): each slot's own pos), on a first call and again."""
    g = torch.Generator().manual_seed(hd)
    if where == "prefill":
        x = torch.randn(1, 37, 4, hd, generator=g).to(dtype)
        pos = torch.arange(37)
    else:
        x = torch.randn(5, 1, 4, hd, generator=g).to(dtype)
        pos = torch.tensor([0, 3, 511, 2047, 12799])[:, None] + torch.arange(1)
    want = _rotary_building_freqs(x, pos, theta)
    for _ in range(2):
        assert torch.equal(tops.rotary(x, pos, theta), want)


def test_rotary_reuses_its_kept_freqs(monkeypatch):
    """A second call with the same (half, theta, device) reuses the tensor
    the first built, and builds nothing: no host copy of theta.  The kept
    tensor is no inference tensor, so a training step can use it after a
    serving step kept it; a fake mode's call keeps nothing."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    with torch.inference_mode():
        first = tops.rotary_freqs(24, 12345.0, "cpu")
    assert not first.is_inference()
    assert tops.rotary_freqs(24, 12345.0, torch.device("cpu")) is first
    assert tops.rotary_freqs(24, 54321.0, "cpu") is not first

    def no_build(*args):
        raise AssertionError("rotary built its frequencies again")

    monkeypatch.setattr(tops, "_freqs", no_build)
    x = torch.randn(2, 3, 4, 48)
    tops.rotary(x, torch.arange(3), 12345.0)
    kept = dict(tops._FREQS)
    monkeypatch.undo()
    with FakeTensorMode():
        fake = tops.rotary_freqs(24, 777.0, "cpu")
    assert isinstance(fake, FakeTensor)
    assert tops._FREQS == kept


@pytest.mark.parametrize("kv_len", [None, 9, "vector"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches(kv_len, causal):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 4, 4, 16), dtype=np.float32)
    k = rng.standard_normal((3, 12, 2, 16), dtype=np.float32)
    v = rng.standard_normal((3, 12, 2, 16), dtype=np.float32)
    if kv_len == "vector":    # (B,) per-slot lengths of continuous batching
        kv_len = np.array([3, 12, 7], np.int32)
    ours = attention_reference(
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


def _reference_fields_and_port_defaults(ours, ref):
    """``ours`` (a port config dataclass) as a dict of the fields ``ref``
    (the JAX package's) has, nested configs alike, and of those the port
    adds, which must hold their defaults."""
    shared, added = {}, {}
    for f in dataclasses.fields(ours):
        v = getattr(ours, f.name)
        if not hasattr(ref, f.name):
            added[f.name] = (v, f.default)
        elif dataclasses.is_dataclass(v):
            shared[f.name], more = _reference_fields_and_port_defaults(v, getattr(ref, f.name))
            added.update({f"{f.name}.{k}": x for k, x in more.items()})
        else:
            shared[f.name] = v
    return shared, added


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_schema_and_init_shapes_match_jax(name):
    shared, added = _reference_fields_and_port_defaults(ARCHS[name], JAX_ARCHS[name])
    assert shared == dataclasses.asdict(JAX_ARCHS[name])
    assert all(value == default for value, default in added.values()), added
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


# --------------------------------------------------------------------------
# hybrid forward (zamba2): train, prefill, decode
# --------------------------------------------------------------------------

HYB_TOL = dict(atol=1e-4, rtol=1e-4)
JAX_IMPLS = ["pallas", "xla"]


def _close_scaled(ours, ref, tol=1e-4):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    _close(ours, ref, atol=tol * scale, rtol=tol)


@pytest.fixture(scope="module")
def zamba():
    """Reduced zamba2 on the JAX weights, and the JAX package's train and
    prefill outputs for each of its implementations (computed once)."""
    jcfg = jax_reduced(JAX_ARCHS["zamba2-1.2b"])
    jparams = jax_init(jax.random.PRNGKey(1), jax_build_schema(jcfg), jnp.float32)
    cfg = reduced(ARCHS["zamba2-1.2b"])
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(10).integers(0, cfg.vocab, size=(B, 13)).astype(np.int32)
    ref = {}
    for jimpl in JAX_IMPLS:
        jctx = dataclasses.replace(jops.NOSHARD, attention_impl=jimpl, ssm_impl=jimpl)
        train, _, _ = jm.forward(jparams, jcfg, {"tokens": tokens}, ctx=jctx,
                                 mode=jm.TRAIN, compute_dtype=jnp.float32)
        pre, cache, _ = jm.forward(jparams, jcfg, {"tokens": tokens}, ctx=jctx,
                                   mode=jm.PREFILL, compute_dtype=jnp.float32)
        ref[jimpl] = (np.asarray(train), np.asarray(pre),
                      jax.tree.map(np.asarray, cache))
    return cfg, params, jcfg, jparams, tokens, ref


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_hybrid_train_forward_matches(zamba, impl, jimpl):
    """13 tokens: not a multiple of the reduced chunk (8)."""
    cfg, params, _, _, tokens, ref = zamba
    ours, cache, _ = tm.forward(params, cfg, {"tokens": _t(tokens)},
                                ctx=ShardCtx(impl, impl), mode=tm.TRAIN)
    assert cache is None and ours.shape == (B, 13, cfg.vocab_padded)
    _close(ours, ref[jimpl][0], **HYB_TOL)


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_hybrid_prefill_forward_and_cache_match(zamba, impl, jimpl):
    cfg, params, _, _, tokens, ref = zamba
    ours, cache, _ = tm.forward(params, cfg, {"tokens": _t(tokens)},
                                ctx=ShardCtx(impl, impl), mode=tm.PREFILL)
    _, jlogits, jcache = ref[jimpl]
    _close(ours, jlogits, **HYB_TOL)
    assert set(cache) == set(jcache)
    for key in jcache:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _close_scaled(cache[key], jcache[key])
    assert cache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("impl,jimpl", [("kernel", "pallas"), ("torch", "xla")])
def test_hybrid_decode_step_matches(zamba, per_slot, impl, jimpl):
    """One decode step after each side's own prefill, the sequence leaves
    padded by 4; per-slot positions put each sequence at its own length."""
    cfg, params, jcfg, jparams, tokens, ref = zamba
    _, cache, _ = tm.forward(params, cfg, {"tokens": _t(tokens)},
                             ctx=ShardCtx(impl, impl), mode=tm.PREFILL)
    jcache = dict(ref[jimpl][2])
    pad = [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]
    for key in ("shared_k", "shared_v"):
        jcache[key] = np.pad(jcache[key], pad)
        cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 4))
    pos = np.array([13, 8], np.int32) if per_slot else np.int32(13)
    jcache["pos"] = jnp.asarray(pos)
    cache["pos"] = torch.as_tensor(pos)
    nxt = np.array([[3], [250]], np.int32)
    jl, jc, _ = jm.forward(jparams, jcfg, {"tokens": nxt}, mode=jm.DECODE,
                           cache=jcache, compute_dtype=jnp.float32)
    tl, tc, _ = tm.forward(params, cfg, {"tokens": _t(nxt).long()},
                           ctx=ShardCtx(impl, impl), mode=tm.DECODE, cache=cache)
    _close(tl, jl, **HYB_TOL)
    for key in jc:
        if key != "pos":
            _close_scaled(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_hybrid_cache_schema_matches_jax():
    cfg = reduced(ARCHS["zamba2-1.2b"])
    ours = tm.cache_schema(cfg, batch=3, max_len=40)
    ref = jm.cache_schema(jax_reduced(JAX_ARCHS["zamba2-1.2b"]), batch=3, max_len=40)
    assert _shapes(ours, ParamSchema) == _shapes(ref, JaxPS)
    assert ours["ssm"].dtype == torch.float32 and ours["pos"].dtype == torch.int32
    full = tm.cache_schema(ARCHS["zamba2-1.2b"], batch=4, max_len=1088)
    jfull = jm.cache_schema(JAX_ARCHS["zamba2-1.2b"], batch=4, max_len=1088)
    assert _shapes(full, ParamSchema) == _shapes(jfull, JaxPS)


def test_ssm_impl_is_validated():
    with pytest.raises(ValueError, match="ssm_impl"):
        ShardCtx(ssm_impl="pallas")
