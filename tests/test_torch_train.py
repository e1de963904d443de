"""The port's training path against the JAX package, on the same weights (JAX
``init_from_schema`` carried across with ``params_from_numpy``, each
attention block's projections rescaled to their contracted width as
``chip_smoke.py``'s ``_rescale_attention`` does) and the same numpy
batches, on the CPU.

Tolerances:
  * float32: the loss and metrics within 1e-5 relative; every gradient leaf
    within 1e-5 of its magnitude (largest entry).  A leaf whose gradient
    vanishes analytically (whisper's cross-attention key bias: the softmax
    over keys is shift-invariant) holds rounding noise only, so the
    magnitude is floored at 1e-2 of the largest entry in the whole tree.
  * bfloat16 compute: the loss within 2e-2 relative.  Each gradient leaf
    within 2e-2 of its norm plus twice the JAX package's own distance
    between its bfloat16 and float32 gradients.  XLA's CPU backend keeps
    chains of bfloat16 elementwise ops in float32 (excess precision) where
    eager PyTorch rounds after every op, so the two packages' bfloat16
    gradients differ by about as much as bfloat16 moves either from float32:
    1-3% of a dense leaf's norm, 9% of zamba2's ``A_log``, 28% of an MoE
    router, where a rounding flips a token's experts.
  * one train step, JAX's against the port's: params, ``mu``, ``nu`` within
    1e-5 of their magnitude (floored as above), ``step`` equal, metrics
    within 1e-5 relative.  Adam's ``eps`` is 1e-3 there: its first step is
    ``g / (|g| + eps)``, which at the default 1e-8 turns an entry whose
    gradient is rounding noise into a step of +-lr in either package.

PyTorch runs these tests on one intra-op thread (restored after each
test): the reduced models' ops are tiny, and beside the test runner's
other workers a pool of one thread per core oversubscribes the cores
(the 120 steps of ``test_loss_goes_down_end_to_end`` took 5 s alone and
1,237 s as six such processes at once).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.models import ops as jops
from repro.models.config import CellTuning as JaxTuning
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import init_from_schema as jax_init
from repro.models.testing import reduced as jax_reduced
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.kernels import flash_attention, ssd_scan
from repro_torch.models import ops as tops
from repro_torch.models.config import CellTuning
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.ops import ShardCtx
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import init_from_schema
from repro_torch.models.testing import reduced
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import leaves

B, S = 2, 16
FAMILIES = ("qwen2-1.5b", "granite-moe-3b-a800m", "zamba2-1.2b",
            "falcon-mamba-7b", "whisper-large-v3")
F32 = 1e-5
BF16 = 2e-2


def _rescale_attention(attn):
    d, H, hd = attn["wq"].shape[-3:]
    KV = attn["wk"].shape[-2]
    attn["wq"] = attn["wq"] * math.sqrt(H / d)
    attn["wk"] = attn["wk"] * math.sqrt(KV / d)
    attn["wv"] = attn["wv"] * math.sqrt(KV / d)
    attn["wo"] = attn["wo"] * math.sqrt(1.0 / H)


def _weights(name):
    """Both configs and the JAX init as numpy, attention rescaled."""
    jcfg, cfg = jax_reduced(JAX_ARCHS[name]), reduced(ARCHS[name])
    npp = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                            jax_build_schema(jcfg), jnp.float32))
    for group in ("layers", "shared", "enc_layers"):
        for blk in ("attn", "cross"):
            if blk in npp.get(group, {}):
                _rescale_attention(npp[group][blk])
    return jcfg, cfg, npp


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.enc_len:
        batch["enc_embeds"] = rng.standard_normal((B, cfg.enc_len, cfg.d_model),
                                                  dtype=np.float32)
    return batch


def _port_grads(cfg, npp, batch, tuning, ctx=steps.TRAIN_CTX):
    params = params_from_numpy(npp, "cpu")
    req = [p.requires_grad_() for p in leaves(params)]
    loss, metrics = steps.loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  ctx, tuning)
    grads = torch.autograd.grad(loss, req)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            [g.double().numpy() for g in grads])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_JAX = {}


def _jax_grads(name, dtype):
    """(jcfg, cfg, numpy weights, batch, metrics, gradient leaves) of the
    JAX ``loss_fn`` under ``jax.value_and_grad``, computed once per arch and
    dtype."""
    key = (name, dtype)
    if key not in _JAX:
        jcfg, cfg, npp = _weights(name)
        batch = _batch(cfg)
        tuning = JaxTuning(compute_dtype=dtype, remat=True)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (_, metrics), grads = jax.value_and_grad(
            lambda p: jsteps.loss_fn(p, jcfg, jb, jops.ShardCtx(enabled=False), tuning),
            has_aux=True)(jax.tree.map(jnp.asarray, npp))
        _JAX[key] = (jcfg, cfg, npp, batch,
                     {k: float(v) for k, v in metrics.items()},
                     [np.asarray(g, np.float64) for g in jax.tree.leaves(grads)])
    return _JAX[key]


def _assert_tree_close(ours, ref, tol, what=""):
    """Each leaf within ``tol`` of its largest entry, floored at 1e-2 of
    the tree's largest entry."""
    ours = [np.asarray(o, np.float64) for o in ours]
    ref = [np.asarray(r, np.float64) for r in ref]
    assert len(ours) == len(ref)
    tree_max = max(float(np.abs(r).max()) for r in ref)
    for i, (o, r) in enumerate(zip(ours, ref)):
        assert o.shape == r.shape, (what, i, o.shape, r.shape)
        scale = max(float(np.abs(r).max()), 1e-2 * tree_max)
        np.testing.assert_allclose(o, r, atol=tol * scale, rtol=0,
                                   err_msg=f"{what} leaf {i}")


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------


@pytest.mark.parametrize("vocab", [257, 512])
def test_softmax_cross_entropy_matches(vocab):
    """Vp = 512: vocab 257 masks 255 padded slots, vocab 512 none."""
    rng = np.random.default_rng(5)
    logits = (4 * rng.standard_normal((3, 7, 512))).astype(np.float32)
    labels = rng.integers(0, vocab, size=(3, 7)).astype(np.int32)
    ce, z = tops.softmax_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels), vocab)
    jce, jz = jops.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), vocab)
    assert float(ce) == pytest.approx(float(jce), rel=F32)
    assert float(z) == pytest.approx(float(jz), rel=F32)


def test_softmax_cross_entropy_bf16_logits_in_float32():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 300)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 257, size=(2, 5)))
    a = tops.softmax_cross_entropy(logits.bfloat16(), labels, 257)
    b = tops.softmax_cross_entropy(logits.bfloat16().float(), labels, 257)
    assert a[0].dtype == torch.float32
    assert float(a[0]) == float(b[0]) and float(a[1]) == float(b[1])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_every_gradient_match_jax_f32(name):
    jcfg, cfg, npp, batch, jm, jg = _jax_grads(name, "float32")
    metrics, grads = _port_grads(cfg, npp, batch, CellTuning(compute_dtype="float32"))
    assert set(metrics) == set(jm)
    for k in jm:
        assert metrics[k] == pytest.approx(jm[k], rel=F32, abs=F32), k
    _assert_tree_close(grads, jg, F32, name)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_every_gradient_match_jax_bf16(name):
    *_, jg32 = _jax_grads(name, "float32")
    jcfg, cfg, npp, batch, jm, jg = _jax_grads(name, "bfloat16")
    metrics, grads = _port_grads(cfg, npp, batch, CellTuning(compute_dtype="bfloat16"))
    assert metrics["loss"] == pytest.approx(jm["loss"], rel=BF16)
    assert metrics["ce"] == pytest.approx(jm["ce"], rel=BF16)
    for i, (g, r, r32) in enumerate(zip(grads, jg, jg32)):
        assert g.shape == r.shape
        err = np.linalg.norm(g - r)
        bound = BF16 * np.linalg.norm(r) + 2 * np.linalg.norm(r - r32)
        assert err <= bound, (name, i, err, bound)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_equals_no_remat(name):
    _, cfg, npp = _weights(name)
    batch = _batch(cfg, seed=1)
    m0, g0 = _port_grads(cfg, npp, batch, CellTuning(compute_dtype="float32", remat=False))
    m1, g1 = _port_grads(cfg, npp, batch, CellTuning(compute_dtype="float32", remat=True))
    assert m0 == pytest.approx(m1, rel=1e-6)
    _assert_tree_close(g1, g0, 1e-6, "remat")


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, decay_steps=20, eps=1e-3)


def _data(cfg, global_batch=4):
    return DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=global_batch, seed=1,
                      enc_len=cfg.enc_len, d_model=cfg.d_model)


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name):
    """Two steps of 2 micro-batches, float32, remat on."""
    jcfg, cfg, npp = _weights(name)
    jopt, opt = jadamw.OptimizerConfig(**OPT), adamw.OptimizerConfig(**OPT)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt, JaxTuning(num_microbatches=2, remat=True, compute_dtype="float32")))
    step = steps.make_train_step(
        cfg, opt, CellTuning(num_microbatches=2, remat=True, compute_dtype="float32"))
    jp = jax.tree.map(jnp.asarray, npp)
    js = jadamw.init(jopt, jp)
    params = params_from_numpy(npp, "cpu")
    state = adamw.init(opt, params)
    dcfg = _data(cfg)
    for i in range(2):
        batch = batch_for_step(dcfg, i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, metrics = step(params, state, _to_torch(batch))
        assert int(state.step) == int(js.step) == i + 1
        assert set(metrics) == set(jm)
        for k in jm:
            assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=F32, abs=F32), k
        _assert_tree_close(leaves(params), jax.tree.leaves(jp), F32, "params")
        _assert_tree_close(leaves(state.mu), jax.tree.leaves(js.mu), F32, "mu")
        _assert_tree_close(leaves(state.nu), jax.tree.leaves(js.nu), F32, "nu")


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-1.2b"])
def test_one_microbatch_equals_two(name):
    _, cfg, npp = _weights(name)
    opt = adamw.OptimizerConfig(**OPT)
    batch = _to_torch(batch_for_step(_data(cfg), 0))
    out = {}
    for n in (1, 2):
        step = steps.make_train_step(
            cfg, opt, CellTuning(num_microbatches=n, compute_dtype="float32"))
        params = params_from_numpy(npp, "cpu")
        out[n] = step(params, adamw.init(opt, params), batch)
    (p1, s1, m1), (p2, s2, m2) = out[1], out[2]
    for k in m1:
        assert float(m1[k]) == pytest.approx(float(m2[k]), rel=F32), k
    _assert_tree_close(leaves(s2.mu), leaves(s1.mu), F32, "mu")
    _assert_tree_close(leaves(p2), leaves(p1), F32, "params")


def test_train_step_keeps_its_inputs_and_rejects_a_ragged_batch():
    _, cfg, npp = _weights("qwen2-1.5b")
    opt = adamw.OptimizerConfig(**OPT)
    params = params_from_numpy(npp, "cpu")
    state = adamw.init(opt, params)
    before = [p.clone() for p in leaves(params)]
    step = steps.make_train_step(cfg, opt, CellTuning(num_microbatches=2,
                                                      compute_dtype="float32"))
    new, new_state, _ = step(params, state, _to_torch(batch_for_step(_data(cfg), 0)))
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(params)))
    assert int(state.step) == 0 and int(new_state.step) == 1
    assert not any(p.requires_grad for p in leaves(new))
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(new)))
    with pytest.raises(ValueError, match="micro-batches"):
        step(params, state, _to_torch(batch_for_step(_data(cfg, global_batch=3), 0)))


def test_loss_goes_down_end_to_end():
    """tests/test_substrate.py::test_loss_goes_down_end_to_end on the port."""
    cfg = reduced(ARCHS["qwen2-1.5b"])
    params = init_from_schema(1, build_schema(cfg), torch.float32, "cpu")
    opt_cfg = adamw.OptimizerConfig(lr=2e-2, warmup_steps=10, decay_steps=300)
    opt_state = adamw.init(opt_cfg, params)
    tuning = CellTuning(num_microbatches=1, remat=False, compute_dtype="float32")
    step = steps.make_train_step(cfg, opt_cfg, tuning)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=16, seed=3)
    losses = []
    for i in range(120):
        params, opt_state, metrics = step(params, opt_state,
                                          _to_torch(batch_for_step(dcfg, i)))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::24]


# --------------------------------------------------------------------------
# the kernels have no backward
# --------------------------------------------------------------------------


def _flash_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 4, 16, generator=g, requires_grad=requires_grad)
    k = torch.randn(1, 8, 2, 16, generator=g)
    v = torch.randn(1, 8, 2, 16, generator=g)
    return q, k, v


def _ssd_inputs(requires_grad):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, 2, 8, generator=g, requires_grad=requires_grad)
    dt = torch.rand(1, 16, 2, generator=g) * 0.1
    A = -torch.rand(2, generator=g)
    Bc = torch.randn(1, 16, 4, generator=g)
    Cc = torch.randn(1, 16, 4, generator=g)
    return x, dt, A, Bc, Cc


def test_kernels_raise_when_a_gradient_is_needed():
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(*_flash_inputs(True))
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_scan(*_ssd_inputs(True), chunk=8)
    # without a gradient to take they run: inputs that need none, or no_grad
    flash_attention(*_flash_inputs(False))
    ssd_scan(*_ssd_inputs(False), chunk=8)
    with torch.no_grad():
        flash_attention(*_flash_inputs(True))
        ssd_scan(*_ssd_inputs(True), chunk=8)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-1.2b"])
def test_train_step_with_the_kernel_context_raises(name):
    _, cfg, npp = _weights(name)
    opt = adamw.OptimizerConfig(**OPT)
    params = params_from_numpy(npp, "cpu")
    step = steps.make_train_step(cfg, opt, CellTuning(compute_dtype="float32"),
                                 ctx=ShardCtx())
    with pytest.raises(RuntimeError, match="TRAIN_CTX"):
        step(params, adamw.init(opt, params), _to_torch(batch_for_step(_data(cfg), 0)))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-1.2b"])
def test_kernel_context_loss_without_grad_equals_train_ctx(name):
    """What chip_smoke's train phase (c) checks on the card: under no_grad
    the kernel route computes the same loss as the plain paths."""
    _, cfg, npp = _weights(name)
    params = params_from_numpy(npp, "cpu")
    batch = _to_torch(batch_for_step(_data(cfg), 0))
    tuning = CellTuning(compute_dtype="float32")
    with torch.no_grad():
        kern, _ = steps.loss_fn(params, cfg, batch, ShardCtx(), tuning)
        plain, _ = steps.loss_fn(params, cfg, batch, steps.TRAIN_CTX, tuning)
    assert float(kern) == pytest.approx(float(plain), rel=1e-6)

