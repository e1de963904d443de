"""The port's encoder-decoder family (reduced whisper-large-v3: 4 encoder
and 4 decoder layers, d 64, 4 heads of hd 16, enc_len 16) against the JAX
package, on the same weights (JAX ``init_from_schema`` carried across with
``params_from_numpy``) and the same numpy frames and tokens, float32 on the
CPU.

The weights are the reference's init with nonzero qkv and MLP biases
(0.1 N(0, 1), so the zero frames the engines feed still give a nonzero
encoder output) and every attention block's projections (encoder, decoder
self, cross) rescaled to their contracted width, as ``chip_smoke.py``'s
``_weights`` does at full size: on the raw init the q.k logits saturate the
softmax and float32 ordering differences grow to ~6e-3 of the logits
through eight layers, which says nothing of the port.

Tolerances: the dense family's 1e-5, taken of the reference tensor's
largest magnitude (``test_torch_models.py``'s scaling), for logits and all
four cache leaves, with the JAX side on ``attention_impl="xla"`` and
``"pallas"`` (interpret mode); prefill + one decode step against the full
forward within 2e-3 (tests/test_models.py's gate); greedy tokens and
engine counters exactly equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import model as jm
from repro.models import ops as jops
from repro.models.config import CellTuning as JaxTuning
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import ParamSchema as JaxPS
from repro.models.sharding import init_from_schema as jax_init
from repro.models.testing import reduced as jax_reduced
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro.train.steps import make_prefill_step as jax_prefill_step
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.serve import serve_batch
from repro_torch.models import model as tm
from repro_torch.models.config import CellTuning
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ops import ShardCtx
from repro_torch.models.sharding import ParamSchema
from repro_torch.models.testing import reduced
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.steps import make_prefill_step

NAME = "whisper-large-v3"
B, S = 2, 13                   # 13 decoder tokens against 16 frames
IMPLS = ["kernel", "torch"]
JAX_IMPLS = ["xla", "pallas"]
COUNTERS = ("admitted", "finished", "ticks", "decoded_tokens")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_scaled(ours, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().float().numpy(), ref,
                               atol=tol * scale, rtol=tol)


def _rescale_attention(attn):
    d, H, hd = attn["wq"].shape[-3:]
    KV = attn["wk"].shape[-2]
    attn["wq"] = attn["wq"] * math.sqrt(H / d)
    attn["wk"] = attn["wk"] * math.sqrt(KV / d)
    attn["wv"] = attn["wv"] * math.sqrt(KV / d)
    attn["wo"] = attn["wo"] * math.sqrt(1.0 / H)


def _jctx(jimpl):
    return dataclasses.replace(jops.NOSHARD, attention_impl=jimpl)


@pytest.fixture(scope="module")
def setup():
    """Both configs and weights, numpy frames and tokens, and the JAX
    package's train and prefill outputs per implementation (computed once)."""
    jcfg = jax_reduced(JAX_ARCHS[NAME])
    cfg = reduced(ARCHS[NAME])
    jparams = jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), jax_build_schema(jcfg), jnp.float32))
    rng = np.random.default_rng(30)
    for group, blocks in (("enc_layers", ("attn",)), ("layers", ("attn", "cross"))):
        for blk in blocks:
            attn = jparams[group][blk]
            _rescale_attention(attn)
            for key in ("bq", "bk", "bv"):
                attn[key] = (0.1 * rng.standard_normal(attn[key].shape)).astype(np.float32)
        mlp = jparams[group]["mlp"]
        for key in ("b_up", "b_down"):
            mlp[key] = (0.1 * rng.standard_normal(mlp[key].shape)).astype(np.float32)
    params = params_from_numpy(jparams, "cpu")
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    frames = (0.02 * rng.standard_normal((B, cfg.enc_len, cfg.d_model))).astype(np.float32)
    batch = {"tokens": tokens, "enc_embeds": frames}
    ref = {}
    for jimpl in JAX_IMPLS:
        train, _, _ = jm.forward(jparams, jcfg, batch, ctx=_jctx(jimpl),
                                 mode=jm.TRAIN, compute_dtype=jnp.float32)
        pre, cache, _ = jm.forward(jparams, jcfg, batch, ctx=_jctx(jimpl),
                                   mode=jm.PREFILL, compute_dtype=jnp.float32)
        ref[jimpl] = (np.asarray(train), np.asarray(pre),
                      jax.tree.map(np.asarray, cache))
    return cfg, params, jcfg, jparams, batch, ref


def _batch(batch):
    return {"tokens": _t(batch["tokens"]).long(), "enc_embeds": _t(batch["enc_embeds"])}


# --------------------------------------------------------------------------
# forward: train, prefill, decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_train_forward_matches(setup, impl, jimpl):
    cfg, params, _, _, batch, ref = setup
    ours, cache, aux = tm.forward(params, cfg, _batch(batch), ctx=ShardCtx(impl),
                                  mode=tm.TRAIN)
    assert cache is None and aux == {}
    assert ours.shape == (B, S, cfg.vocab_padded)
    _close_scaled(ours, ref[jimpl][0])


@pytest.mark.parametrize("jimpl", JAX_IMPLS)
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_forward_and_cache_match(setup, impl, jimpl):
    cfg, params, _, _, batch, ref = setup
    ours, cache, _ = tm.forward(params, cfg, _batch(batch), ctx=ShardCtx(impl),
                                mode=tm.PREFILL)
    _, jlogits, jcache = ref[jimpl]
    _close_scaled(ours, jlogits)
    assert set(cache) == set(jcache) == {"k", "v", "cross_k", "cross_v", "pos"}
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _close_scaled(cache[key], jcache[key])
    assert cache["cross_k"].shape[2] == cfg.enc_len
    assert int(cache["pos"]) == int(jcache["pos"]) == S


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_step_last_logits_match(setup, impl):
    cfg, params, jcfg, jparams, batch, _ = setup
    last, cache = make_prefill_step(cfg, ShardCtx(impl))(params, _batch(batch))
    jlast, _ = jax_prefill_step(jcfg, JaxTuning(compute_dtype="float32"))(jparams, batch)
    assert last.shape == (B, cfg.vocab_padded) and "cross_k" in cache
    _close_scaled(last, jlast)


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches(setup, per_slot):
    """One decode step against the JAX prefill cache, self k/v padded by 4
    and the cross K/V as they are; per-slot positions put each sequence at
    its own length."""
    cfg, params, jcfg, jparams, _, ref = setup
    jcache = dict(ref["xla"][2])
    pad = [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]
    for key in ("k", "v"):
        jcache[key] = np.pad(jcache[key], pad)
    pos = np.array([S, S - 5], np.int32) if per_slot else np.int32(S)
    jcache["pos"] = pos
    nxt = np.array([[3], [250]], np.int32)
    cache = {key: _t(val) for key, val in jcache.items()}
    jl, jc, _ = jm.forward(jparams, jcfg, {"tokens": nxt}, mode=jm.DECODE,
                           cache=dict(jcache, pos=jnp.asarray(pos)),
                           compute_dtype=jnp.float32)
    tl, tc, _ = tm.forward(params, cfg, {"tokens": _t(nxt).long()},
                           mode=tm.DECODE, cache=cache)
    _close_scaled(tl, jl)
    for key in ("k", "v", "cross_k", "cross_v"):
        _close_scaled(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_decode_matches_full_forward(setup, impl):
    """tests/test_models.py's consistency check: prefill S tokens, decode
    the greedy next one against a cache padded by 4 (the encoder does not
    run again), and compare with the full forward over S + 1 tokens at the
    last position, within 2e-3."""
    cfg, params, _, _, batch, _ = setup
    ctx = ShardCtx(impl)
    pre, cache, _ = tm.forward(params, cfg, _batch(batch), ctx=ctx, mode=tm.PREFILL)
    for key in ("k", "v"):
        cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 4))
    nxt = torch.argmax(pre[:, -1, : cfg.vocab], dim=-1)[:, None]
    dl, cache2, _ = tm.forward(params, cfg, {"tokens": nxt}, ctx=ctx,
                               mode=tm.DECODE, cache=cache)
    assert int(cache2["pos"]) == S + 1
    full, _, _ = tm.forward(params, cfg, dict(
        _batch(batch), tokens=torch.cat([_t(batch["tokens"]).long(), nxt], 1)), ctx=ctx)
    err = float((dl[:, -1] - full[:, -1]).abs().max())
    assert err < 2e-3, err


def test_encoder_needs_frames(setup):
    cfg, params, _, _, batch, _ = setup
    for mode in (tm.TRAIN, tm.PREFILL):
        with pytest.raises(ValueError, match="enc_embeds"):
            tm.forward(params, cfg, {"tokens": _t(batch["tokens"]).long()}, mode=mode)


def test_encoder_casts_frames_to_the_weights_dtype(setup):
    """bf16 weights and float32 frames: the frames are cast, as the
    reference's ``forward`` casts them to its compute dtype."""
    cfg, params, _, _, batch, _ = setup
    p16 = tm.cast_params(params, torch.bfloat16, "cpu")
    logits, cache, _ = tm.forward(p16, cfg, _batch(batch), mode=tm.PREFILL)
    assert logits.dtype == cache["cross_k"].dtype == torch.bfloat16
    assert bool(torch.isfinite(logits).all())


def test_cache_schema_matches_jax():
    for cfg, jcfg, max_len in ((reduced(ARCHS[NAME]), jax_reduced(JAX_ARCHS[NAME]), 40),
                               (ARCHS[NAME], JAX_ARCHS[NAME], 448)):
        ours = tm.cache_schema(cfg, batch=4, max_len=max_len, enc_len=cfg.enc_len)
        ref = jm.cache_schema(jcfg, batch=4, max_len=max_len, enc_len=jcfg.enc_len)
        assert {k: tuple(v.shape) for k, v in ours.items() if isinstance(v, ParamSchema)} \
            == {k: tuple(v.shape) for k, v in ref.items() if isinstance(v, JaxPS)}
        assert ours["cross_k"].shape == (cfg.n_layers, 4, cfg.enc_len, cfg.n_kv_heads, cfg.hd)
        assert ours["pos"].dtype == torch.int32


def test_params_from_numpy_carries_whisper_leaves(setup):
    _, params, _, jparams, _, _ = setup
    assert set(params) == set(jparams) == {
        "embed", "enc_layers", "enc_final_norm", "layers", "final_norm", "lm_head"}
    assert set(params["layers"]) == {"attn", "cross", "mlp"}
    for group in ("enc_layers", "layers"):
        for blk, ws in jparams[group].items():
            for key, w in ws.items():
                np.testing.assert_array_equal(params[group][blk][key].numpy(), w)


# --------------------------------------------------------------------------
# the engine and serve_batch
# --------------------------------------------------------------------------


def _prompts(seed, sizes, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=s).astype(np.int32) for s in sizes]


def _run(engine_cls, request_cls, cfg, params, prompts, max_new, *, slots,
         max_len, ticks_before=None, **kw):
    engine = engine_cls(cfg, params, slots=slots, max_len=max_len, **kw)
    reqs = [request_cls(i, p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    if ticks_before is None:
        for r in reqs:
            engine.submit(r)
    else:
        engine.submit(reqs[0])
        for _ in range(ticks_before):
            engine.tick()
        for r in reqs[1:]:
            engine.submit(r)
    stats = engine.run_until_drained()
    return [r.generated for r in reqs], tuple(getattr(stats, c) for c in COUNTERS)


@pytest.mark.parametrize("mode", ["lockstep", "staggered", "slot_reuse"])
def test_engine_matches_jax(setup, mode):
    """Zero frames in both engines; every admission writes its slot's cross
    K/V lanes whole, over what a finished or idle slot left behind."""
    cfg, params, jcfg, jparams, _, _ = setup
    if mode == "lockstep":
        prompts, new, kw = _prompts(40, [12] * 3, cfg.vocab), [5] * 3, {}
    elif mode == "staggered":
        prompts, new, kw = _prompts(41, [13, 9], cfg.vocab), [6, 4], dict(ticks_before=3)
    else:
        prompts, new, kw = _prompts(42, [10, 7, 11, 10, 6], cfg.vocab), [3] * 5, {}
    ours = _run(ServeEngine, Request, cfg, params, prompts, new, slots=2,
                max_len=40, device="cpu", **kw)
    ref = _run(JaxEngine, JaxRequest, jcfg, jparams, prompts, new, slots=2,
               max_len=40, **kw)
    assert ours == ref
    assert ours[1][1] == len(prompts)


def test_engine_kernel_and_torch_impls_agree(setup):
    cfg, params = setup[:2]
    prompts = _prompts(43, [9, 14], cfg.vocab)
    outs = [_run(ServeEngine, Request, cfg, params, prompts, [5, 5], slots=2,
                 max_len=32, device="cpu",
                 tuning=CellTuning(compute_dtype="float32", attention_impl=impl))
            for impl in IMPLS]
    assert outs[0] == outs[1]


def test_engine_cache_lanes(setup):
    """The pool holds the encoder-decoder schema's leaves in the compute
    dtype; an admission fills its slot's cross lanes with the prefill's
    cross K/V over the engine's zero frames, and leaves the other slot's."""
    cfg, params = setup[:2]
    engine = ServeEngine(cfg, params, slots=2, max_len=24, device="cpu",
                         tuning=CellTuning(compute_dtype="bfloat16"))
    assert set(engine.cache) == {"k", "v", "cross_k", "cross_v", "pos"}
    assert engine.cache["cross_k"].shape == (cfg.n_layers, 2, cfg.enc_len, cfg.n_kv_heads, cfg.hd)
    assert engine.cache["cross_v"].dtype == engine._enc_embeds.dtype == torch.bfloat16
    (prompt,) = _prompts(44, [10], cfg.vocab)
    engine.submit(Request(0, prompt, max_new_tokens=3))
    engine._admit()
    _, cache1 = engine._prefill(engine.params, {
        "tokens": torch.as_tensor(prompt[None]).long(),
        "enc_embeds": torch.zeros(1, cfg.enc_len, cfg.d_model)})
    for key in ("cross_k", "cross_v"):
        assert torch.equal(engine.cache[key][:, 0], cache1[key][:, 0])
        assert float(engine.cache[key][:, 0].abs().max()) > 0
        assert float(engine.cache[key][:, 1].abs().max()) == 0
    stats = engine.run_until_drained()
    assert stats.finished == 1 and stats.decoded_tokens == 3


def test_serve_batch_matches_jax(setup):
    """The reference's frames (0.02 N(0, 1) from ``jax.random``) passed in."""
    cfg, params, jcfg, jparams, _, _ = setup
    prompts = np.stack(_prompts(45, [11, 11, 11], cfg.vocab))
    frames = np.array(0.02 * jax.random.normal(
        jax.random.PRNGKey(0), (3, cfg.enc_len, cfg.d_model)))
    ours = serve_batch(cfg, params, prompts, 7, enc_embeds=frames, device="cpu")
    ref = jax_serve_batch(jcfg, jparams, jnp.asarray(prompts), 7, seed=0)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_serve_batch_draws_seeded_frames(setup):
    """Without frames, serve_batch draws them from its seed: the same seed
    serves the same tokens, and equals passing those draws in."""
    cfg, params = setup[:2]
    prompts = np.stack(_prompts(46, [8, 8], cfg.vocab))
    a = serve_batch(cfg, params, prompts, 4, seed=3, device="cpu")
    b = serve_batch(cfg, params, prompts, 4, seed=3, device="cpu")
    frames = 0.02 * torch.randn(2, cfg.enc_len, cfg.d_model,
                                generator=torch.Generator().manual_seed(3))
    c = serve_batch(cfg, params, prompts, 4, enc_embeds=frames, device="cpu")
    assert torch.equal(a, b) and torch.equal(a, c)
    assert a.shape == (2, 12)
