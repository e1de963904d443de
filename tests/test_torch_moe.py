"""The port's MoE MLP and MoE decoder against the JAX package, on the same
weights (JAX ``init_from_schema`` carried across with ``params_from_numpy``)
and the same numpy inputs, in float32 on the CPU.

Two reduced configurations: phi3.5-moe's (4 experts, top-2, none padded)
and granite-moe's with its padding kept (5 experts padded to 8, top-2:
the padded experts' logits are -1e30).  Both ``moe_mlp`` layouts run: the
global sort (the serving default) and the per-row capacity
(``ShardCtx.moe_row_dispatch``).

Tolerance: the dense family's 1e-5, taken of the largest magnitude of the
reference tensor (``test_torch_models.py``'s scaling).  Routing is a
discontinuous function of the router logits, so equal outputs also say
that both packages chose the same experts and dropped the same tokens.

The whole-model cases run on the reference's init with each attention
block's projections rescaled to their contracted width, as
``chip_smoke.py``'s ``_rescale_attention`` does at full size: the raw init
scales by the head count, the q.k logits saturate the softmax, and f32
summation-order differences of a few ulp in the residual stream (|h| ~ 70)
then reach 3e-5 of the separate lm_head's logits.  The raw init is held in
``test_forward_on_raw_init_matches`` at the hybrid family's 1e-4.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models import ops as jops
from repro.models.config import MoEConfig as JaxMoE
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import init_from_schema as jax_init
from repro.models.testing import reduced as jax_reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ops import ShardCtx
from repro_torch.models.testing import reduced

from test_torch_serve import _both, _prompts

B, S = 2, 13
VARIANTS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")
LAYOUTS = ("global", "rows")
IMPLS = ["kernel", "torch"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_scaled(ours, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().float().numpy(), ref,
                               atol=tol * scale, rtol=tol)


def configs(name, **moe_over):
    """The reduced config in both packages; granite keeps padded experts."""
    jcfg, cfg = jax_reduced(JAX_ARCHS[name]), reduced(ARCHS[name])
    over = dict(n_experts=5, n_experts_padded=8) \
        if name.startswith("granite") else {}
    over.update(moe_over)
    if over:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **over))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over))
    assert isinstance(jcfg.moe, JaxMoE) and isinstance(cfg.moe, MoEConfig)
    return jcfg, cfg


def _rescale_attention(attn):
    d, H, hd = attn["wq"].shape[-3:]
    KV = attn["wk"].shape[-2]
    attn["wq"] = attn["wq"] * math.sqrt(H / d)
    attn["wk"] = attn["wk"] * math.sqrt(KV / d)
    attn["wv"] = attn["wv"] * math.sqrt(KV / d)
    attn["wo"] = attn["wo"] * math.sqrt(1.0 / H)


def model_setup(name, seed=0, rescale=True):
    jcfg, cfg = configs(name)
    jparams = jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(seed), jax_build_schema(jcfg), jnp.float32))
    if rescale:
        _rescale_attention(jparams["layers"]["attn"])
    return cfg, params_from_numpy(jparams, "cpu"), jcfg, jparams


@pytest.fixture(scope="module", params=VARIANTS)
def setup(request):
    return model_setup(request.param)


def _layer_moe(jparams, i=0):
    return {k: v[i] for k, v in jparams["layers"]["moe"].items()}


def _both_moe(jcfg, cfg, lp, x, layout):
    rows = layout == "rows"
    jy, jaux = jmoe.moe_mlp(lp, x, jcfg,
                            dataclasses.replace(jops.NOSHARD, moe_row_dispatch=rows))
    ty, taux = tmoe.moe_mlp(params_from_numpy(lp, "cpu"), _t(x), cfg,
                            ShardCtx(moe_row_dispatch=rows))
    return (jy, jaux), (ty, taux)


def _assert_moe_equal(j, t):
    (jy, jaux), (ty, taux) = j, t
    _close_scaled(ty, jy)
    assert set(taux) == set(jaux) == {"load_balance", "router_z", "drop_fraction"}
    for key in jaux:
        _close_scaled(taux[key], jaux[key])


# --------------------------------------------------------------------------
# the MoE MLP alone
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", VARIANTS)
def test_moe_mlp_matches(name, layout):
    jcfg, cfg = configs(name)
    lp = _layer_moe(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(3), jax_build_schema(jcfg), jnp.float32)))
    x = 3 * np.random.default_rng(4).standard_normal((B, S, cfg.d_model),
                                                     dtype=np.float32)
    j, t = _both_moe(jcfg, cfg, lp, x, layout)
    _assert_moe_equal(j, t)
    assert float(t[1]["drop_fraction"]) == 0.0   # capacity factor 4.0


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", VARIANTS)
def test_moe_mlp_capacity_drops_match(name, layout):
    """Capacity factor 1.0 and a router skewed to expert 0: every token
    ranks expert 0 in its top 2, far past its capacity (global: 13 of 26
    slots; rows: 8 of 13), so both packages must drop the same tokens."""
    jcfg, cfg = configs(name, capacity_factor=1.0)
    lp = _layer_moe(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(5), jax_build_schema(jcfg), jnp.float32)))
    lp["router"] = lp["router"].copy()
    lp["router"][:, 0] += 0.5
    x = np.random.default_rng(6).standard_normal((B, S, cfg.d_model),
                                                 dtype=np.float32) + 1.0
    j, t = _both_moe(jcfg, cfg, lp, x, layout)
    _assert_moe_equal(j, t)
    assert float(t[1]["drop_fraction"]) > 0.2


def _jax_topk(lp, x, jcfg):
    xn = jops.rms_norm(jnp.asarray(x).reshape(-1, x.shape[-1]), lp["ln"],
                       jcfg.norm_eps)
    logits = (xn @ lp["router"]).astype(jnp.float32)
    E, Ep = jcfg.moe.n_experts, jcfg.moe.n_experts_padded
    logits = jnp.where(jnp.arange(Ep)[None] >= E, -1e30, logits)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.moe.top_k)[1])


@pytest.mark.parametrize("ties", ["all_equal", "pairs"])
@pytest.mark.parametrize("name", VARIANTS)
def test_router_ties_break_as_lax_top_k(name, ties):
    """Equal router logits: lax.top_k takes the lower index first; so must
    the port (torch.topk promises no order on ties)."""
    jcfg, cfg = configs(name)
    lp = _layer_moe(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(7), jax_build_schema(jcfg), jnp.float32)))
    router = lp["router"].copy()
    if ties == "all_equal":
        router[:] = 0.0
    else:                     # experts 2 and 3 equal, 0 and 1 equal
        router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
    lp["router"] = router
    x = np.random.default_rng(8).standard_normal((B, S, cfg.d_model),
                                                 dtype=np.float32)
    want = _jax_topk(lp, x, jcfg)
    tp = params_from_numpy(lp, "cpu")
    xn = tm.rms_norm(_t(x).reshape(-1, cfg.d_model), tp["ln"], cfg.norm_eps)
    _, _, _, idx = tmoe._route(xn, tp, cfg)
    np.testing.assert_array_equal(idx.numpy(), want)
    if ties == "all_equal":
        assert (want == np.arange(cfg.moe.top_k)).all()
    for layout in LAYOUTS:
        _assert_moe_equal(*_both_moe(jcfg, cfg, lp, x, layout))


def test_padded_experts_never_chosen():
    jcfg, cfg = configs("granite-moe-3b-a800m")
    lp = _layer_moe(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(9), jax_build_schema(jcfg), jnp.float32)))
    lp["router"] = lp["router"].copy()
    lp["router"][:, cfg.moe.n_experts:] += 100.0     # would win unmasked
    tp = params_from_numpy(lp, "cpu")
    x = _t(np.random.default_rng(10).standard_normal((B * S, cfg.d_model),
                                                     dtype=np.float32) + 1.0)
    _, probs, _, idx = tmoe._route(tm.rms_norm(x, tp["ln"], cfg.norm_eps), tp, cfg)
    assert int(idx.max()) < cfg.moe.n_experts
    assert float(probs[:, cfg.moe.n_experts:].max()) == 0.0


def test_combine_is_repeatable_in_bf16():
    """The combine sums each token's contributions in a fixed order: two
    runs in bfloat16 give the same bits."""
    jcfg, cfg = configs("granite-moe-3b-a800m")
    lp = _layer_moe(jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(11), jax_build_schema(jcfg), jnp.float32)))
    tp = params_from_numpy(lp, "cpu", torch.bfloat16)
    x = _t(np.random.default_rng(12).standard_normal((B, S, cfg.d_model),
                                                     dtype=np.float32)).bfloat16()
    for rows in (False, True):
        ctx = ShardCtx(moe_row_dispatch=rows)
        a, _ = tmoe.moe_mlp(tp, x, cfg, ctx)
        b, _ = tmoe.moe_mlp(tp, x, cfg, ctx)
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_params_from_numpy_carries_stacked_experts(setup):
    cfg, params, _, jparams = setup
    L, Ep, d, ff = cfg.n_layers, cfg.moe.n_experts_padded, cfg.d_model, cfg.d_ff
    moe = params["layers"]["moe"]
    assert tuple(moe["w_up"].shape) == (L, Ep, d, ff)
    assert tuple(moe["w_down"].shape) == (L, Ep, ff, d)
    assert tuple(moe["router"].shape) == (L, d, Ep)
    for key, w in jparams["layers"]["moe"].items():
        np.testing.assert_array_equal(moe[key].numpy(), w)


# --------------------------------------------------------------------------
# the decoder: train, prefill, decode, engine
# --------------------------------------------------------------------------


def _tokens(cfg, seed=20, n=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, n)).astype(np.int32)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("impl", IMPLS)
def test_train_forward_matches(setup, impl, layout):
    cfg, params, jcfg, jparams = setup
    tokens = _tokens(cfg)
    rows = layout == "rows"
    ours, cache, aux = tm.forward(params, cfg, {"tokens": _t(tokens)},
                                  ctx=ShardCtx(impl, moe_row_dispatch=rows),
                                  mode=tm.TRAIN)
    ref, _, jaux = jm.forward(jparams, jcfg, {"tokens": tokens}, mode=jm.TRAIN,
                              ctx=dataclasses.replace(jops.NOSHARD,
                                                      moe_row_dispatch=rows),
                              compute_dtype=jnp.float32)
    assert cache is None and ours.shape == (B, S, cfg.vocab_padded)
    _close_scaled(ours, ref)
    assert set(aux) == set(jaux)
    for key in jaux:
        _close_scaled(aux[key], jaux[key])


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_forward_and_cache_match(setup, impl):
    cfg, params, jcfg, jparams = setup
    tokens = _tokens(cfg)
    ours, cache, aux = tm.forward(params, cfg, {"tokens": _t(tokens)},
                                  ctx=ShardCtx(impl), mode=tm.PREFILL)
    ref, jcache, jaux = jm.forward(jparams, jcfg, {"tokens": tokens},
                                   mode=jm.PREFILL, compute_dtype=jnp.float32)
    _close_scaled(ours, ref)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == jcache[key].shape
        _close_scaled(cache[key], jcache[key])
    assert int(cache["pos"]) == int(jcache["pos"]) == S
    for key in jaux:
        _close_scaled(aux[key], jaux[key])


def test_forward_on_raw_init_matches():
    """The reference's init as it is (saturated attention), both variants."""
    for name in VARIANTS:
        cfg, params, jcfg, jparams = model_setup(name, seed=1, rescale=False)
        tokens = _tokens(cfg, seed=21)
        ours, _, _ = tm.forward(params, cfg, {"tokens": _t(tokens)})
        ref, _, _ = jm.forward(jparams, jcfg, {"tokens": tokens},
                               compute_dtype=jnp.float32)
        _close_scaled(ours, ref, tol=1e-4)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_decode_matches_full_forward(setup, impl):
    """tests/test_models.py's consistency check: prefill S tokens, decode
    the greedy next one against a cache padded by 4, and compare with the
    full forward over S + 1 tokens at the last position, within 2e-3."""
    cfg, params, _, _ = setup
    tokens = _t(_tokens(cfg, seed=22, n=16)).long()
    ctx = ShardCtx(impl)
    last, cache, _ = tm.forward(params, cfg, {"tokens": tokens}, ctx=ctx,
                                mode=tm.PREFILL)
    for key in ("k", "v"):
        cache[key] = torch.nn.functional.pad(cache[key], (0, 0, 0, 0, 0, 4))
    nxt = torch.argmax(last[:, -1, : cfg.vocab], dim=-1)[:, None]
    dl, cache2, _ = tm.forward(params, cfg, {"tokens": nxt}, ctx=ctx,
                               mode=tm.DECODE, cache=cache)
    assert int(cache2["pos"]) == 17
    full, _, _ = tm.forward(params, cfg, {"tokens": torch.cat([tokens, nxt], 1)},
                            ctx=ctx)
    err = float((dl[:, -1] - full[:, -1]).abs().max())
    assert err < 2e-3, err


def test_cache_schema_matches_jax():
    jcfg, cfg = configs("granite-moe-3b-a800m")
    ours = tm.cache_schema(cfg, batch=3, max_len=40)
    ref = jm.cache_schema(jcfg, batch=3, max_len=40)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    full = tm.cache_schema(ARCHS["granite-moe-3b-a800m"], batch=4, max_len=1088)
    assert tuple(full["k"].shape) == (32, 4, 1088, 8, 64)


@pytest.mark.parametrize("mode", ["lockstep", "staggered"])
def test_engine_matches_jax(setup, mode):
    cfg = setup[0]
    if mode == "lockstep":
        prompts = _prompts(30, [12, 12, 12], cfg.vocab)
        kw = dict(slots=2, max_len=40)
        new = [5] * 3
    else:
        prompts = _prompts(31, [13, 9], cfg.vocab)
        kw = dict(slots=2, max_len=40, ticks_before=3)
        new = [6, 4]
    (toks, stats), (jtoks, jstats) = _both(setup, prompts, new, **kw)
    assert toks == jtoks and stats == jstats
    assert stats[1] == len(prompts)


def test_engine_row_dispatch_decodes_alike(setup, monkeypatch):
    """CellTuning.moe_row_dispatch reaches the model (every MoE layer of
    every step runs the row layout), and with no drops (capacity factor
    4.0) both layouts give the same greedy tokens."""
    from repro_torch.models.config import CellTuning
    from repro_torch.serve import Request, ServeEngine

    calls = []
    rows_fn = tmoe._moe_mlp_rows

    def counted(*args, **kwargs):
        calls.append(1)
        return rows_fn(*args, **kwargs)

    monkeypatch.setattr(tmoe, "_moe_mlp_rows", counted)
    cfg, params = setup[:2]
    outs = []
    for rows in (False, True):
        engine = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu",
                             tuning=CellTuning(compute_dtype="float32",
                                               moe_row_dispatch=rows))
        reqs = [Request(i, p, max_new_tokens=4)
                for i, p in enumerate(_prompts(32, [9, 11], cfg.vocab))]
        for r in reqs:
            engine.submit(r)
        engine.run_until_drained()
        outs.append([r.generated for r in reqs])
        # 2 admissions and 4 decode ticks, every layer
        assert len(calls) == (6 * cfg.n_layers if rows else 0)
    assert outs[0] == outs[1]
