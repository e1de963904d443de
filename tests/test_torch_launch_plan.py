"""The port's launch plans and step counter against the JAX package, on the CPU.

  * ``launch.plan.build_plan``: for every supported (arch x shape) cell, with
    and without ``optimized``, the model FLOPs, the abstract parameter,
    optimizer, batch and cache shapes and the float dtypes equal the
    reference ``build_plan``'s (the port's abstract arguments are fake
    tensors; tokens and labels are int32 in both).
  * ``launch.cost``: the torch meaning of tests/test_hlo_cost.py's cases,
    and the counted FLOPs of each family's reduced twin against
    ``repro.launch.hlo_cost.analyze`` of the same jitted JAX step (B 4, S 64,
    float32; train with 2 micro-batches and remat) within 1%:
      - train: exact for qwen2, granite-moe and whisper; zamba2 -0.14% and
        falcon-mamba +0.79%, where autograd and XLA's transpose take
        different products through the SSM scans;
      - prefill: exact once 2*B*(S-1)*d*Vp is taken off the reference's
        count: the port's step sends only the last position through the
        vocab head, where the JAX step builds the (B, S, Vp) logits first;
      - decode: exact.
    And ``launch.cost``'s FLOPs equal ``FlopCounterMode``'s on real tensors;
    the kernel route counts what the torch route counts.
  * ``remat_chunk_attn``: loss and gradients with and without it equal at
    float32 1e-5, and equal to the JAX package's ``remat_body=True``.
  * ``tests/test_sharding.py``'s config cases against the port's config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch import hlo_cost
from repro.launch import plan as jplan
from repro.models import ops as jops
from repro.models.config import SHAPES as JAX_SHAPES
from repro.models.config import CellTuning as JaxTuning
from repro.models.config import cell_is_supported as jax_supported
from repro.models.model import cache_schema as jax_cache_schema
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import abstract_from_schema as jax_abstract
from repro.models.testing import reduced as jax_reduced
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import cost
from repro_torch.launch import plan as tplan
from repro_torch.models import ops as tops
from repro_torch.models.config import SHAPES, CellTuning, cell_is_supported
from repro_torch.models.model import cache_schema
from repro_torch.models.ops import ShardCtx
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import abstract_from_schema, init_from_schema
from repro_torch.models.testing import reduced
from repro_torch.optim import adamw
from repro_torch.train import steps
from repro_torch.tree import leaves

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES
         if cell_is_supported(ARCHS[a], SHAPES[s])[0]]
FAMILIES = ("qwen2-1.5b", "zamba2-1.2b", "granite-moe-3b-a800m",
            "falcon-mamba-7b", "whisper-large-v3")
B, S = 4, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_layout(tree):
    return [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in leaves(tree)]


def _jax_layout(tree):
    return [(tuple(t.shape), str(t.dtype)) for t in jax.tree.leaves(tree)]


# -- build_plan ----------------------------------------------------------------

@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_matches_reference(arch, shape, optimized):
    ref = jplan.build_plan(arch, shape, optimized=optimized)
    plan = tplan.build_plan(arch, shape, optimized=optimized, device="cpu")
    assert plan.model_flops == ref.model_flops
    assert plan.chips == 1
    impl = {"attention_impl", "ssm_impl"}
    assert {k: v for k, v in dataclasses.asdict(plan.tuning).items() if k not in impl} \
        == {k: v for k, v in dataclasses.asdict(ref.tuning).items() if k not in impl}
    assert plan.ctx.remat_chunk_attn == ref.ctx.remat_chunk_attn
    assert plan.ctx.moe_row_dispatch == ref.ctx.moe_row_dispatch
    if ref.opt_cfg is not None:
        assert dataclasses.asdict(plan.opt_cfg) == dataclasses.asdict(ref.opt_cfg)
    with FakeTensorMode():
        args = plan.abstract_args()
    assert len(args) == len(ref.abstract_args)
    for mine, theirs in zip(args, ref.abstract_args):
        assert _port_layout(mine) == _jax_layout(theirs)
    assert all(t.device.type == "cpu" for t in leaves(args))


def test_train_plan_runs_the_plain_paths_and_serving_the_kernels():
    assert tplan.build_plan("qwen2-1.5b", "train_4k", device="cpu").ctx == \
        steps.TRAIN_CTX
    ctx = tplan.build_plan("zamba2-1.2b", "prefill_32k", device="cpu").ctx
    assert (ctx.attention_impl, ctx.ssm_impl) == ("kernel", "kernel")


def test_plan_refuses_what_one_card_cannot_mean(monkeypatch):
    # a mesh's plan is built, but its arguments need the mesh
    plan = tplan.build_plan("qwen2-1.5b", "train_4k", multi_pod=True, device="cpu")
    assert plan.chips == 512
    with pytest.raises(ValueError, match="need its mesh"):
        plan.abstract_args()
    with pytest.raises(ValueError, match="unsupported cell"):
        tplan.build_plan("qwen2-1.5b", "long_500k", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.build_plan("qwen2-1.5b", "decode_32k")


def test_optimized_overrides_are_the_reference_ones():
    assert tplan.OPTIMIZED_OVERRIDES == jplan.OPTIMIZED_OVERRIDES
    for name in ARCHS:
        assert tplan._encoder_params(ARCHS[name]) == \
            jplan._encoder_params(JAX_ARCHS[name])


def test_abstract_from_schema_allocates_nothing():
    cfg = ARCHS["qwen2-1.5b"]
    with FakeTensorMode():
        fake = abstract_from_schema(build_schema(cfg), torch.bfloat16, "cpu")
    real = init_from_schema(0, build_schema(reduced(cfg)), torch.bfloat16, "cpu")
    assert sorted(fake) == sorted(real)
    assert all(t.untyped_storage().device.type == "meta" for t in leaves(fake))
    assert _port_layout(fake) == _jax_layout(
        jax_abstract(jax_build_schema(JAX_ARCHS["qwen2-1.5b"]), jnp.bfloat16))


# -- tests/test_sharding.py's config cases on the port's config ------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_vocab_always_padded_shardable(name):
    cfg = ARCHS[name]
    assert cfg.vocab_padded % 256 == 0
    assert cfg.vocab_padded >= cfg.vocab
    assert cfg.vocab_padded == JAX_ARCHS[name].vocab_padded


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_long_500k_support_matrix(name):
    """long_500k runs for SSM/hybrid, skipped for full-attention archs; the
    reason is the reference's."""
    ok, why = cell_is_supported(ARCHS[name], SHAPES["long_500k"])
    assert ok == (name in {"falcon-mamba-7b", "zamba2-1.2b"}), (name, why)
    if not ok:
        assert "sub-quadratic" in why
    assert (ok, why) == jax_supported(JAX_ARCHS[name], JAX_SHAPES["long_500k"])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_all_other_cells_supported(name):
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        ok, _ = cell_is_supported(ARCHS[name], SHAPES[shape])
        assert ok, (name, shape)


# -- launch.cost: tests/test_hlo_cost.py's cases with a torch meaning ----------

def test_matmul_flops_and_bytes():
    t = cost.analyze(lambda a, b: a @ b, torch.randn(128, 256), torch.randn(256, 512))
    assert t.flops == 2 * 128 * 256 * 512
    assert t.bytes == 4 * (128 * 256 + 256 * 512 + 128 * 512)


def test_loop_counts_every_iteration():
    def stack(x):
        for _ in range(28):
            x = x @ x
        return x

    assert cost.analyze(stack, torch.randn(64, 64)).flops == 28 * 2 * 64 ** 3


def test_in_place_cache_write_charges_update_only():
    def write(buf, upd):
        buf[3:4] = upd                                   # copy_ into a slice
        return buf

    def write_at(buf, upd, pos):
        buf.index_copy_(0, pos, upd)
        return buf

    buf, upd = torch.zeros(32, 1024), torch.randn(1, 1024)
    t = cost.analyze(write, buf, upd)
    assert t.bytes == 2 * 4 * 1024
    assert t.memory["alias_bytes"] == t.memory["output_bytes"] == 4 * 32 * 1024
    t = cost.analyze(write_at, buf, upd, torch.tensor([5]))
    assert t.bytes == 2 * 4 * 1024 + 8                   # and the index read


def test_elementwise_charges_operands_and_result():
    t = cost.analyze(lambda a, b: a + b, torch.randn(512, 512), torch.randn(512, 512))
    assert t.bytes == 3 * 4 * 512 * 512 and t.flops == 0


def test_views_are_free_and_collectives_zero():
    t = cost.analyze(lambda x: x.reshape(-1).t().unsqueeze(0), torch.randn(8, 8))
    assert t.bytes == 0 and t.flops == 0
    assert t.coll_bytes == 0 and t.coll_counts == {} and t.coll_bytes_by_kind == {}


def test_memory_peak_follows_live_storages():
    def chain(x):
        y = x * 2          # 4 MB live beside x
        z = y * 2          # 4 MB more, then y dies
        del y
        return z + 1       # z and the result
    x = torch.randn(1024, 1024)
    m = cost.analyze(chain, x).memory
    n = 4 * 1024 * 1024
    assert m == {"argument_bytes": n, "output_bytes": n, "temp_bytes": n,
                 "alias_bytes": 0, "peak_bytes_per_device": 3 * n}


def test_breakdown_lists_operators():
    b = cost.breakdown(lambda a, w: torch.relu(a @ w), torch.randn(64, 32),
                       torch.randn(32, 16), top=5)
    assert b["by_flops"][0][:2] == ("mm", 2.0 * 64 * 32 * 16)
    assert {row[0] for row in b["by_bytes"]} == {"mm", "relu"}


# -- the reduced twins' steps against the JAX package's HLO count ---------------

def _jax_step(name, kind):
    cfg = jax_reduced(JAX_ARCHS[name])
    tuning = JaxTuning(num_microbatches=2, remat=True, compute_dtype="float32")
    params = jax_abstract(jax_build_schema(cfg), jnp.float32)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    batch = {"tokens": tok}
    if cfg.enc_len:
        batch["enc_embeds"] = jax.ShapeDtypeStruct((B, cfg.enc_len, cfg.d_model),
                                                   jnp.float32)
    if kind == "train":
        opt_cfg = jadamw.OptimizerConfig()
        opt = jax.eval_shape(lambda p: jadamw.init(opt_cfg, p), params)
        fn = jsteps.make_train_step(cfg, opt_cfg, tuning)
        args = (params, opt, dict(batch, labels=tok))
    elif kind == "prefill":
        fn, args = jsteps.make_prefill_step(cfg, tuning), (params, batch)
    else:
        cache = jax_abstract(jax_cache_schema(cfg, B, S, enc_len=cfg.enc_len),
                             jnp.float32)
        fn = jsteps.make_serve_step(cfg, tuning)
        args = (params, cache, jax.ShapeDtypeStruct((B, 1), jnp.int32))
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())


def _port_step(name, kind, ctx=ShardCtx("torch", "torch"), device="cpu"):
    """The port's step and its fake arguments (under the returned mode)."""
    cfg = reduced(ARCHS[name])
    tuning = CellTuning(num_microbatches=2, remat=True, compute_dtype="float32")
    mode = FakeTensorMode()
    with mode:
        params = abstract_from_schema(build_schema(cfg), torch.float32, device)
        tok = torch.empty(B, S, dtype=torch.int32, device=device)
        batch = {"tokens": tok}
        if cfg.enc_len:
            batch["enc_embeds"] = torch.empty(B, cfg.enc_len, cfg.d_model, device=device)
        if kind == "train":
            opt_cfg = adamw.OptimizerConfig()
            fn = steps.make_train_step(cfg, opt_cfg, tuning)
            args = (params, tplan._abstract_opt(params, opt_cfg), dict(batch, labels=tok))
        elif kind == "prefill":
            fn, args = steps.make_prefill_step(cfg, ctx, tuning=tuning), (params, batch)
        else:
            cache = abstract_from_schema(
                cache_schema(cfg, B, S, enc_len=cfg.enc_len), torch.float32, device)
            fn = steps.make_serve_step(cfg, ctx, tuning=tuning)
            args = (params, cache, torch.empty(B, 1, dtype=torch.int32, device=device))
    return cfg, fn, args


# train counts that differ from the reference's: (port - reference) / reference
TRAIN_DRIFT = {"zamba2-1.2b": -0.00136, "falcon-mamba-7b": 0.00787}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", FAMILIES)
def test_step_flops_match_hlo_cost(name, kind):
    ref = _jax_step(name, kind).flops
    cfg, fn, args = _port_step(name, kind)
    mine = cost.analyze(fn, *args).flops
    if kind == "prefill":
        ref -= 2 * B * (S - 1) * cfg.d_model * cfg.vocab_padded
    if kind == "train" and name in TRAIN_DRIFT:
        assert abs(mine / ref - 1) < 1e-2
        assert mine / ref - 1 == pytest.approx(TRAIN_DRIFT[name], abs=1e-5)
    else:
        assert mine == ref


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", FAMILIES)
def test_counted_flops_equal_flop_counter_on_real_tensors(name, kind):
    """``launch.cost`` applies FlopCounterMode's formulas in its own pass on
    fakes; FlopCounterMode on real tensors of the same step gives the same
    count."""
    cfg, fn, fakes = _port_step(name, kind)
    counted = cost.analyze(fn, *fakes).flops
    gen = torch.Generator().manual_seed(0)

    def real(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, tuple(t.shape), generator=gen,
                                 dtype=torch.int32)
        return 0.02 * torch.randn(tuple(t.shape), generator=gen).to(t.dtype)

    args = jax.tree.map(lambda t: real(t) if isinstance(t, torch.Tensor) else t,
                        fakes, is_leaf=lambda t: isinstance(t, torch.Tensor))
    if kind == "decode":
        args[1]["pos"] = torch.tensor(S - 8, dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    assert fc.get_total_flops() == counted


@pytest.mark.parametrize("name", ["qwen2-1.5b", "zamba2-1.2b"])
def test_kernel_route_counts_what_the_torch_route_counts(name):
    """The two kernels' FLOP formulas against the plain paths.  Under
    FakeTensorMode an operator runs its fake implementation whatever the
    device, so the step runs on CPU fakes here (on this CPU-only build a
    whole step cannot run on CUDA fakes: Python indexing takes a CUDA
    device guard); the operators alone also run on CUDA fakes."""
    _, fn, args = _port_step(name, "prefill", ShardCtx("kernel", "kernel"))
    kernel = cost.analyze(fn, *args)
    _, fn, args = _port_step(name, "prefill")
    torch_route = cost.analyze(fn, *args)
    assert kernel.flops == torch_route.flops > 0
    assert kernel.bytes != torch_route.bytes       # the routes move other bytes


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_kernel_operators_count_on_fakes(device):
    from repro_torch.kernels import LAUNCHES, flash_attention, ssd_scan

    with FakeTensorMode():
        q = torch.empty(2, 96, 4, 16, device=device)
        k = torch.empty(2, 96, 2, 16, device=device)
        x = torch.empty(1, 200, 4, 16, device=device)
        dt = torch.empty(1, 200, 4, device=device)
        A = torch.empty(4, device=device)
        Bc = torch.empty(1, 200, 8, device=device)
    before = dict(LAUNCHES)
    t = cost.analyze(lambda q, k: flash_attention(q, k, k, causal=True), q, k)
    assert t.flops == 4 * 2 * 4 * 96 * 96 * 16
    assert t.bytes == 4 * (2 * 96 * 4 * 16 * 2 + 2 * 2 * 96 * 2 * 16)
    t = cost.analyze(lambda *a: ssd_scan(*a, chunk=64), x, dt, A, Bc, Bc)
    from repro_torch.kernels.ssd_scan import ssd_chunked

    with FlopCounterMode(display=False) as plain:      # the torch route, real
        ssd_chunked(*(torch.randn(tuple(a.shape)) for a in (x, dt, A, Bc, Bc)), 64)
    assert t.flops == plain.get_total_flops() == 2883584
    assert LAUNCHES == before                      # counting launches nothing


# -- remat_chunk_attn -------------------------------------------------------------

def _attn_inputs(seed=0, Sq=96, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((2, Sq, KV, hd), dtype=np.float32)
    v = rng.standard_normal((2, Sq, KV, hd), dtype=np.float32)
    w = rng.standard_normal((2, Sq, H, hd), dtype=np.float32)
    return q, k, v, w


def _port_attn_grads(inputs, remat):
    q, k, v, w = (torch.tensor(x, requires_grad=i < 3) for i, x in enumerate(inputs))
    out = tops.attention_chunked(q, k, v, causal=True, q_chunk=32, remat_body=remat)
    loss = (out * w).sum()
    return [float(loss.detach())] + [g.numpy() for g in torch.autograd.grad(loss, [q, k, v])]


def test_remat_body_equals_no_remat_and_jax():
    inputs = _attn_inputs()
    plain, remat = _port_attn_grads(inputs, False), _port_attn_grads(inputs, True)

    def jax_loss(q, k, v):
        out = jops.attention_chunked(q, k, v, causal=True, q_chunk=32, remat_body=True)
        return jnp.sum(out * inputs[3])

    jl, jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(*inputs[:3])
    for a, b in zip(remat[1:], plain[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    for a, b in zip(remat[1:], jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(b)).max())
    assert remat[0] == pytest.approx(plain[0], rel=1e-5)
    assert remat[0] == pytest.approx(float(jl), rel=1e-5)


def test_remat_chunk_attn_through_the_model():
    """yi-6b's reduced twin at S 1024 (two 512-query chunks), on the JAX
    init with attention rescaled to its contracted width (as
    tests/test_torch_train.py does: the raw init saturates the softmax and
    float32 order alone then parts the packages by 1e-3): the port's loss
    and gradients with ``remat_chunk_attn`` equal those without it and the
    JAX ``loss_fn``'s with it (``attention_chunked(remat_body=True)``), each
    leaf within 1e-5 of its magnitude, floored at 1e-2 of the tree's."""
    from repro.models.ops import ShardCtx as JaxCtx
    from repro_torch.models.convert import params_from_numpy
    from test_torch_train import _weights

    jcfg, cfg, npp = _weights("yi-6b")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(1, 1025)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tuning = CellTuning(remat=False, compute_dtype="float32")

    def port(remat):
        params = params_from_numpy(npp, "cpu")
        req = [p.requires_grad_() for p in leaves(params)]
        ctx = ShardCtx("torch", "torch", remat_chunk_attn=remat)
        loss, _ = steps.loss_fn(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                                ctx, tuning)
        return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, req)]

    jctx = JaxCtx(enabled=False, remat_chunk_attn=True)
    jtuning = JaxTuning(remat=False, compute_dtype="float32")
    (jl, _), jg = jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jcfg, batch, jctx, jtuning), has_aux=True)(npp)
    (l0, g0), (l1, g1) = port(False), port(True)
    assert l1 == pytest.approx(l0, rel=1e-5) and l1 == pytest.approx(float(jl), rel=1e-5)
    floor = 1e-2 * max(np.abs(b).max() for b in g0)
    for a, b, c in zip(g1, g0, jax.tree.leaves(jg)):
        scale = max(np.abs(b).max(), floor)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(a, np.asarray(c), rtol=0, atol=1e-5 * scale)


# -- serving steps take the tuning -----------------------------------------------

def test_serving_steps_cast_to_the_compute_dtype():
    cfg = reduced(ARCHS["qwen2-1.5b"])
    params = init_from_schema(0, build_schema(cfg), torch.float32, "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(0))
    ctx = ShardCtx("torch", "torch")
    tuning = CellTuning(compute_dtype="bfloat16")
    from repro_torch.models.model import cast_params

    ref_logits, ref_cache = steps.make_prefill_step(cfg, ctx)(
        cast_params(params, torch.bfloat16), {"tokens": tok})
    logits, cache = steps.make_prefill_step(cfg, ctx, tuning=tuning)(params, {"tokens": tok})
    assert logits.dtype == torch.bfloat16 and torch.equal(logits, ref_logits)
    assert torch.equal(cache["k"], ref_cache["k"])


@pytest.mark.parametrize("rows", [False, True])
def test_moe_traces_under_fake_tensors(rows):
    """granite-moe-3b's MoE MLP at full width on fakes: the expert counts are
    a fixed-shape scatter-add (``bincount``'s output shape depends on the
    data, which FakeTensorMode cannot trace), and they equal bincount's."""
    from repro_torch.models import moe

    cfg = ARCHS["granite-moe-3b-a800m"]
    with FakeTensorMode():
        p = abstract_from_schema(build_schema(cfg)["layers"]["moe"], torch.bfloat16, "cpu")
        p = {k: v[0] for k, v in p.items()}
        x = torch.empty(2, 64, cfg.d_model, dtype=torch.bfloat16)
        y, aux = moe.moe_mlp(p, x, cfg, ShardCtx(moe_row_dispatch=rows))
    assert y.shape == x.shape and set(aux) == {"load_balance", "router_z", "drop_fraction"}
    ids = torch.randint(0, 48, (4096,), generator=torch.Generator().manual_seed(0))
    xf = torch.randn(2048, 8)
    buf, order, e_sorted, pos_c, keep = moe._dispatch(xf, ids, 48, 64, 2)
    counts = torch.bincount(ids, minlength=48)
    assert int(keep.sum()) == int(torch.clamp(counts, max=64).sum())
