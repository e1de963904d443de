"""The port's training substrate: optimizer, checkpointing, fault tolerance
and data pipeline.  The cases of tests/test_substrate.py run against the
port (its loss-goes-down case is in tests/test_torch_train.py), then the
port is held against the JAX package on the same inputs:

  * ``adamw.apply``, ``schedule``, ``compress_gradient`` and
    ``global_norm``: float32 within 1e-6 relative (the same arithmetic in
    another summation order); ``step`` equal;
  * ``batch_for_step``: equal bit for bit;
  * checkpoints: a float32 tree written by either package restores in the
    other exactly; a bfloat16 tree round-trips exactly.

The data, ft and optim properties of tests/test_property.py follow
(hypothesis), against the port.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import store as jstore
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import batch_for_step as jax_batch_for_step
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.ft.manager import RestartManager, StragglerDetector, plan_elastic_mesh
from repro_torch.optim import adamw
from repro_torch.tree import describe, leaves, tree_map, unflatten

REL = 1e-6


def _zero():
    return {"x": torch.zeros(())}


# --------------------------------------------------------------------------
# optimizer (tests/test_substrate.py)
# --------------------------------------------------------------------------


def _quadratic_grad(p):
    w = p["w"].detach().requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(torch.square(w)), [w])
    return {"w": g}


def test_adamw_converges_on_quadratic():
    cfg = adamw.OptimizerConfig(lr=0.1, warmup_steps=0, decay_steps=100,
                                weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(cfg, params)
    for _ in range(200):
        params, state, _ = adamw.apply(cfg, params, _quadratic_grad(params), state)
    assert float(params["w"].abs().max()) < 1e-2


def test_adamw_clips_gradient_norm():
    cfg = adamw.OptimizerConfig(clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(cfg, params)
    huge = {"w": 1e6 * torch.ones(4)}
    _, _, metrics = adamw.apply(cfg, params, huge, state)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_schedule_warmup_and_cosine():
    cfg = adamw.OptimizerConfig(lr=1.0, warmup_steps=10, decay_steps=110,
                                min_lr_frac=0.1)
    assert float(adamw.schedule(cfg, torch.tensor(5, dtype=torch.int32))) == pytest.approx(0.5)
    assert float(adamw.schedule(cfg, torch.tensor(10, dtype=torch.int32))) == pytest.approx(1.0)
    end = float(adamw.schedule(cfg, torch.tensor(110, dtype=torch.int32)))
    assert end == pytest.approx(0.1, rel=1e-3)


def test_error_feedback_compression_identity():
    """deq + err' == g + err exactly (the quantisation error is never
    lost — the invariant that makes EF-int8 converge)."""
    g = torch.tensor([0.5, -1.25, 3.0, 0.001])
    err = torch.tensor([0.1, 0.0, -0.2, 0.0])
    deq, err2 = adamw.compress_gradient(g, err)
    np.testing.assert_allclose((deq + err2).numpy(), (g + err).numpy(), atol=1e-6)


def test_compressed_training_tracks_uncompressed():
    outs = {}
    for compress in (False, True):
        cfg = adamw.OptimizerConfig(lr=0.05, warmup_steps=0, decay_steps=1000,
                                    weight_decay=0.0, compress_grads=compress)
        p = {"w": torch.tensor([5.0, -3.0, 2.0])}
        s = adamw.init(cfg, p)
        for _ in range(300):
            p, s, _ = adamw.apply(cfg, p, _quadratic_grad(p), s)
        outs[compress] = float(p["w"].abs().max())
    assert outs[True] < 0.05  # converges despite int8 wire format


# --------------------------------------------------------------------------
# checkpointing (tests/test_substrate.py)
# --------------------------------------------------------------------------


def _tree(x=1.0):
    return {"a": torch.full((3, 2), x), "b": {"c": torch.arange(4)}}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path)
    store.save(d, 10, _tree(2.5), extra={"loss": 1.25})
    out, extra = store.restore(d, 10, _tree(0.0))
    np.testing.assert_allclose(out["a"].numpy(), 2.5)
    assert torch.equal(out["b"]["c"], torch.arange(4))
    assert extra == {"loss": 1.25}


def test_checkpoint_latest_and_gc(tmp_path):
    d = str(tmp_path)
    for s in (10, 20, 30, 40):
        store.save(d, s, _tree(float(s)), keep=2)
    assert store.latest_step(d) == 40
    assert store.all_steps(d) == [30, 40]  # keep=2 garbage-collects


def test_partial_checkpoint_invisible(tmp_path):
    d = str(tmp_path)
    store.save(d, 10, _tree())
    # simulate a crash mid-write: directory without meta.json
    os.makedirs(os.path.join(d, "step_20"))
    assert store.latest_step(d) == 10


def test_restore_validates_shapes(tmp_path):
    d = str(tmp_path)
    store.save(d, 1, _tree())
    with pytest.raises(ValueError, match="shape"):
        store.restore(d, 1, {"a": torch.zeros((9, 9)), "b": {"c": torch.arange(4)}})
    with pytest.raises(ValueError, match="leaves"):
        store.restore(d, 1, {"a": torch.zeros((3, 2))})


# --------------------------------------------------------------------------
# fault tolerance (tests/test_substrate.py)
# --------------------------------------------------------------------------


def test_restart_manager_recovers_from_failures(tmp_path):
    mgr = RestartManager(str(tmp_path), checkpoint_every=5, max_failures=3)
    crashes = {"left": 2}

    def step_fn(state, step):
        if step == 12 and crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("injected node failure")
        return {"x": state["x"] + 1}

    out = mgr.run(_zero, step_fn, num_steps=20)
    assert float(out["x"]) == 20  # deterministic replay: no lost/dup steps
    assert mgr.failures == 0
    assert mgr.total_failures == 2


def test_restart_manager_transient_faults_do_not_accumulate(tmp_path):
    mgr = RestartManager(str(tmp_path), checkpoint_every=5, max_failures=2)
    crash_at = {7, 13, 22, 28, 36, 43}  # one per interval, 6 > cap of 2
    seen = set()

    def step_fn(state, step):
        if step in crash_at and step not in seen:
            seen.add(step)
            raise RuntimeError("transient fault")
        return {"x": state["x"] + 1}

    out = mgr.run(_zero, step_fn, num_steps=50)
    assert float(out["x"]) == 50
    assert mgr.total_failures == len(crash_at)
    assert mgr.failures == 0


def test_restart_manager_gives_up_after_max_failures(tmp_path):
    mgr = RestartManager(str(tmp_path), checkpoint_every=5, max_failures=2)

    def step_fn(state, step):
        raise RuntimeError("systematic failure")

    with pytest.raises(RuntimeError):
        mgr.run(_zero, step_fn, num_steps=10)


def test_restart_manager_resumes_from_checkpoint(tmp_path):
    d = str(tmp_path)
    mgr = RestartManager(d, checkpoint_every=5)
    mgr.run(_zero, lambda s, i: {"x": s["x"] + 1}, num_steps=7)
    state, start = RestartManager(d).resume_or_init(_zero)
    assert start == 7 and float(state["x"]) == 7


def test_straggler_detector_flags_slow_host():
    det = StragglerDetector(ratio=1.5, patience=2)
    flagged = []
    for _ in range(5):
        for h in ("h0", "h1", "h2", "h3"):
            det.observe(h, 1.0)
        det.observe("slow", 3.0)
        flagged = det.stragglers()
    assert flagged == ["slow"]


def test_straggler_detector_forgives_recovered_host():
    det = StragglerDetector(ratio=1.5, patience=3, alpha=1.0)
    for h in ("h0", "h1", "h2"):
        det.observe(h, 1.0)
    det.observe("s", 5.0)
    det.stragglers()
    det.observe("s", 1.0)  # recovered
    assert det.stragglers() == []


def test_plan_elastic_mesh():
    assert plan_elastic_mesh(512, model=16) == (4, 8, 16)
    assert plan_elastic_mesh(256, model=16) == (4, 4, 16)
    pod, data, model = plan_elastic_mesh(511, model=16)
    assert pod * data * model <= 511 and model == 16
    assert plan_elastic_mesh(8, model=16) is None


# --------------------------------------------------------------------------
# data pipeline (tests/test_substrate.py)
# --------------------------------------------------------------------------


def test_data_deterministic_per_step():
    cfg = DataConfig(vocab=256, seq_len=32, global_batch=8)
    a = batch_for_step(cfg, 5)
    b = batch_for_step(cfg, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = batch_for_step(cfg, 6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_labels_are_shifted_tokens():
    cfg = DataConfig(vocab=256, seq_len=32, global_batch=4)
    b = batch_for_step(cfg, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_learnable_structure():
    cfg = DataConfig(vocab=256, seq_len=128, global_batch=8)
    b = batch_for_step(cfg, 0)
    V = cfg.vocab
    a_, c_ = 6364136223846793005 % V or 7, 1442695040888963407 % V or 11
    pred = (a_ * b["tokens"].astype(np.int64) + c_) % V
    assert (pred == b["labels"]).mean() > 0.85  # 10% noise injected


def test_data_enc_embeds_for_encdec():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2, enc_len=4, d_model=16)
    assert batch_for_step(cfg, 0)["enc_embeds"].shape == (2, 4, 16)


def test_data_shard_count_must_divide_the_batch():
    with pytest.raises(ValueError, match="shards"):
        batch_for_step(DataConfig(vocab=64, seq_len=8, global_batch=6), 0, shard=(0, 4))


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw,step,shard", [
    (dict(vocab=257, seq_len=32, global_batch=8), 0, (0, 1)),
    (dict(vocab=151936, seq_len=512, global_batch=8, seed=7), 11, (0, 1)),
    (dict(vocab=128, seq_len=16, global_batch=8, seed=2), 3, (2, 4)),
    (dict(vocab=51866, seq_len=12, global_batch=2, enc_len=16, d_model=64), 5, (1, 2)),
])
def test_batch_for_step_equals_jax_bit_for_bit(kw, step, shard):
    ours = batch_for_step(DataConfig(**kw), step, shard)
    ref = jax_batch_for_step(JaxDataConfig(**kw), step, shard)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def _opt_inputs(seed, compress):
    """A small params tree with a 1-d and two 2-d leaves, its gradients (one
    leaf bf16 when ``compress``) and a state three steps in."""
    rng = np.random.default_rng(seed)
    p = {"b": rng.standard_normal(6).astype(np.float32),
         "w": {"u": rng.standard_normal((5, 4)).astype(np.float32),
               "v": rng.standard_normal((3, 7)).astype(np.float32)}}
    g = jax.tree.map(lambda a: (0.3 * rng.standard_normal(a.shape)).astype(np.float32), p)
    m = jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), p)
    v = jax.tree.map(lambda a: (1e-4 * rng.random(a.shape)).astype(np.float32), p)
    e = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)).astype(np.float32)
                     if compress else np.zeros((), np.float32), p)
    return p, g, m, v, e


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(ours, ref, rel=REL):
    for o, r in zip(leaves(ours), jax.tree.leaves(ref)):
        r = np.asarray(r, np.float32)
        o = o.float().numpy()
        np.testing.assert_allclose(o, r, rtol=rel, atol=rel * max(1.0, float(np.abs(r).max())))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_apply_matches_jax(state_dtype, compress, clip):
    p, g, m, v, e = _opt_inputs(3, compress)
    kw = dict(lr=1e-2, warmup_steps=5, decay_steps=50, clip_norm=clip,
              state_dtype=state_dtype, compress_grads=compress)
    jcfg, cfg = jadamw.OptimizerConfig(**kw), adamw.OptimizerConfig(**kw)
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, state_dtype)
    js = jadamw.OptState(jnp.int32(3), jax.tree.map(lambda a: jnp.asarray(a, jdt), m),
                         jax.tree.map(lambda a: jnp.asarray(a, jdt), v),
                         jax.tree.map(jnp.asarray, e))
    ts = adamw.OptState(torch.tensor(3, dtype=torch.int32),
                        tree_map(lambda t: t.to(tdt), _t(m)),
                        tree_map(lambda t: t.to(tdt), _t(v)), _t(e))
    jp, js2, jm = jadamw.apply(jcfg, jax.tree.map(jnp.asarray, p),
                               jax.tree.map(jnp.asarray, g), js)
    tp, ts2, tm = adamw.apply(cfg, _t(p), _t(g), ts)
    assert int(ts2.step) == int(js2.step) == 4
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=REL)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=REL)
    _close(tp, jp)
    state_rel = REL if state_dtype == "float32" else 2 ** -8   # one bf16 ulp
    for ours, ref in ((ts2.mu, js2.mu), (ts2.nu, js2.nu)):
        assert all(o.dtype == tdt for o in leaves(ours))
        _close(ours, jax.tree.map(lambda a: np.asarray(a, np.float32), ref), state_rel)
    _close(ts2.error, js2.error)


def test_adamw_init_matches_jax():
    p, *_ = _opt_inputs(4, False)
    for compress in (False, True):
        cfg = adamw.OptimizerConfig(compress_grads=compress, state_dtype="bfloat16")
        jcfg = jadamw.OptimizerConfig(compress_grads=compress, state_dtype="bfloat16")
        ours, ref = adamw.init(cfg, _t(p)), jadamw.init(jcfg, jax.tree.map(jnp.asarray, p))
        for o, r in zip(leaves(ours), jax.tree.leaves(ref)):
            assert tuple(o.shape) == r.shape
            assert str(o.dtype).removeprefix("torch.") == str(r.dtype)
            assert not o.any()


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 110, 200])
def test_schedule_matches_jax(step):
    kw = dict(lr=3e-3, warmup_steps=10, decay_steps=110, min_lr_frac=0.1)
    ours = adamw.schedule(adamw.OptimizerConfig(**kw), torch.tensor(step, dtype=torch.int32))
    ref = jadamw.schedule(jadamw.OptimizerConfig(**kw), jnp.int32(step))
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(float(ref), rel=REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_gradient_matches_jax(dtype):
    rng = np.random.default_rng(8)
    g = (3 * rng.standard_normal(257)).astype(np.float32)
    err = (0.01 * rng.standard_normal(257)).astype(np.float32)
    jdeq, jerr = jadamw.compress_gradient(jnp.asarray(g, getattr(jnp, dtype)), jnp.asarray(err))
    deq, err2 = adamw.compress_gradient(torch.from_numpy(g).to(getattr(torch, dtype)),
                                        torch.from_numpy(err))
    assert str(deq.dtype).removeprefix("torch.") == str(jdeq.dtype)
    np.testing.assert_allclose(deq.float().numpy(), np.asarray(jdeq, np.float32), rtol=REL, atol=REL)
    np.testing.assert_allclose(err2.numpy(), np.asarray(jerr), rtol=REL, atol=REL)


def test_tree_order_is_jax_order():
    p, g, m, v, e = _opt_inputs(9, True)
    state = jadamw.OptState(jnp.int32(1), m, v, e)
    tree = {"params": p, "opt": state, "none": None, "pair": (g, [p["b"]])}
    ref = jax.tree.leaves(tree)
    ours = leaves({"params": p, "opt": adamw.OptState(1, m, v, e), "none": None,
                   "pair": (g, [p["b"]])})
    assert len(ours) == len(ref)
    assert all(np.array_equal(np.asarray(o), np.asarray(r)) for o, r in zip(ours, ref))
    assert unflatten(tree, ref)["params"]["w"]["v"] is ref[-1]
    with pytest.raises(ValueError):
        unflatten(tree, ref[:-1])


# --------------------------------------------------------------------------
# checkpoints across the two packages
# --------------------------------------------------------------------------


def _train_state(seed, jax_side):
    p, _, m, v, e = _opt_inputs(seed, False)
    if jax_side:
        return {"params": jax.tree.map(jnp.asarray, p),
                "opt": jadamw.OptState(jnp.int32(7), jax.tree.map(jnp.asarray, m),
                                       jax.tree.map(jnp.asarray, v),
                                       jax.tree.map(jnp.asarray, e))}
    return {"params": _t(p), "opt": adamw.OptState(torch.tensor(7, dtype=torch.int32),
                                                   _t(m), _t(v), _t(e))}


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    d = str(tmp_path)
    jstore.save(d, 7, _train_state(1, jax_side=True), extra={"loss": 2.5})
    out, extra = store.restore(d, 7, _train_state(2, jax_side=False))
    assert extra == {"loss": 2.5}
    assert isinstance(out["opt"], adamw.OptState) and out["opt"].step.dtype == torch.int32
    ref = jax.tree.leaves(_train_state(1, jax_side=True))
    for o, r in zip(leaves(out), ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    d = str(tmp_path)
    store.save(d, 7, _train_state(1, jax_side=False), extra={"loss": 2.5})
    assert jstore.latest_step(d) == 7
    out, extra = jstore.restore(d, 7, _train_state(2, jax_side=True))
    assert extra == {"loss": 2.5}
    for o, r in zip(jax.tree.leaves(out), leaves(_train_state(1, jax_side=False))):
        np.testing.assert_array_equal(np.asarray(o), r.numpy())


def test_bfloat16_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path)
    g = torch.Generator().manual_seed(0)
    tree = {"m": torch.randn(4, 5, generator=g).bfloat16(),
            "step": torch.tensor(3, dtype=torch.int32), "w": torch.randn(3, generator=g)}
    store.save(d, 3, tree)
    out, _ = store.restore(d, 3, tree_map(torch.zeros_like, tree))
    assert out["m"].dtype == torch.bfloat16
    for k in tree:
        assert torch.equal(out[k], tree[k]), k


def test_bfloat16_leaf_written_by_jax_restores_exactly(tmp_path):
    d = str(tmp_path)
    a = (jnp.arange(6, dtype=jnp.float32).reshape(2, 3) * 0.37).astype(jnp.bfloat16)
    jstore.save(d, 1, {"a": a})
    out, _ = store.restore(d, 1, {"a": torch.zeros(2, 3, dtype=torch.bfloat16)})
    bits = np.asarray(a).view(np.uint16).astype(np.int32)
    np.testing.assert_array_equal(out["a"].view(torch.int16).numpy().astype(np.int32) & 0xFFFF,
                                  bits)
    assert np.asarray(a).dtype == ml_dtypes.bfloat16


def test_bfloat16_checkpoint_is_byte_equal_to_the_reference(tmp_path):
    """One bfloat16 train state (and its float32 and int32 leaves) saved by
    both packages: every ``leaf_*.npy`` byte-equal (the bf16 leaves as the
    JAX package's "<V2" raw bytes) and ``meta.json`` equal."""
    p, _, m, v, e = _opt_inputs(3, False)
    bf = lambda t: jnp.asarray(t).astype(jnp.bfloat16)
    jtree = {"params": jax.tree.map(bf, p),
             "opt": jadamw.OptState(jnp.int32(7), jax.tree.map(bf, m),
                                    jax.tree.map(bf, v), jax.tree.map(jnp.asarray, e))}
    ttree = {"params": tree_map(lambda t: t.bfloat16(), _t(p)),
             "opt": adamw.OptState(torch.tensor(7, dtype=torch.int32),
                                   tree_map(lambda t: t.bfloat16(), _t(m)),
                                   tree_map(lambda t: t.bfloat16(), _t(v)), _t(e))}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jstore.save(jd, 7, jtree, extra={"loss": 2.5})
    store.save(td, 7, ttree, extra={"loss": 2.5})
    names = sorted(os.listdir(os.path.join(jd, "step_7")))
    assert names == sorted(os.listdir(os.path.join(td, "step_7")))
    assert sum(n.startswith("leaf_") for n in names) == len(jax.tree.leaves(jtree))
    for name in names:
        with open(os.path.join(jd, "step_7", name), "rb") as a, \
                open(os.path.join(td, "step_7", name), "rb") as b:
            assert a.read() == b.read(), name


def test_describe_spells_the_jax_treedef():
    trees = [{"p": {"a": 1, "b": (2, None, [3, 4])}}, None, 5, (), (1,), [],
             (1, (2,), [None, (None,)])]
    for tree in trees:
        assert describe(tree) == str(jax.tree.structure(tree))
    opt = adamw.OptState(1, {"x": 1}, {"x": 2}, {"x": 3})
    jopt = jadamw.OptState(1, {"x": 1}, {"x": 2}, {"x": 3})
    assert describe({"o": opt}) == str(jax.tree.structure({"o": jopt}))


# --------------------------------------------------------------------------
# properties (tests/test_property.py's data, ft and optim cases)
# --------------------------------------------------------------------------


@settings(deadline=None)
@given(st.lists(st.floats(min_value=-1e4, max_value=1e4, allow_nan=False,
                          width=32),
                min_size=1, max_size=64),
       st.lists(st.floats(min_value=-10, max_value=10, allow_nan=False,
                          width=32),
                min_size=1, max_size=64))
def test_compression_error_feedback_identity(gs, es):
    n = min(len(gs), len(es))
    g = torch.tensor(gs[:n], dtype=torch.float32)
    e = torch.tensor(es[:n], dtype=torch.float32)
    deq, e2 = adamw.compress_gradient(g, e)
    np.testing.assert_allclose((deq + e2).numpy(), (g + e).numpy(), rtol=1e-5, atol=1e-5)
    assert torch.isfinite(e2).all()


@given(st.sampled_from([1, 2, 4, 8]), st.integers(min_value=0, max_value=20))
def test_data_shards_partition_global_batch(count, step):
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=8)
    full = batch_for_step(cfg, step, shard=(0, 1))
    parts = [batch_for_step(cfg, step, shard=(i, count)) for i in range(count)]
    glued = np.concatenate([p["tokens"] for p in parts], axis=0)
    assert glued.shape == full["tokens"].shape
    again = batch_for_step(cfg, step, shard=(0, count))
    np.testing.assert_array_equal(parts[0]["tokens"], again["tokens"])


@given(st.integers(min_value=0, max_value=4096), st.sampled_from([4, 8, 16]))
def test_elastic_mesh_invariants(n_devices, model):
    plan = plan_elastic_mesh(n_devices, model=model)
    if plan is None:
        assert n_devices < model
    else:
        pod, data, m = plan
        assert m == model
        assert pod * data * m <= n_devices
        assert pod * data >= (n_devices // model + 1) // 2
