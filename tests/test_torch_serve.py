"""The port's continuous-batching engine and ``serve_batch`` against the JAX
package's, on the dense cases of tests/test_serve_engine.py and on reduced
zamba2 (hybrid: mamba2 state lanes beside the shared block's KV cache): the
same weights (carried across with ``params_from_numpy``) and prompts,
float32 on the CPU.  Greedy tokens must be equal and the engine counters
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models.schema import build_schema as jax_build_schema
from repro.models.sharding import init_from_schema as jax_init
from repro.models.testing import reduced as jax_reduced
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro_torch.configs.registry import ARCHS
from repro_torch.launch.serve import serve_batch
from repro_torch.models.config import CellTuning
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.testing import reduced
from repro_torch.serve import Request, ServeEngine

COUNTERS = ("admitted", "finished", "ticks", "decoded_tokens")


@pytest.fixture(scope="module")
def dense_setup():
    jcfg = jax_reduced(JAX_ARCHS["qwen2-1.5b"])
    jparams = jax_init(jax.random.PRNGKey(0), jax_build_schema(jcfg), jnp.float32)
    cfg = reduced(ARCHS["qwen2-1.5b"])
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, params, jcfg, jparams


def _run(engine_cls, request_cls, cfg, params, prompts, max_new, *, slots,
         max_len, eos=None, ticks_before=None, **kw):
    """Serve ``prompts`` on one engine; requests after the first wait for
    ``ticks_before`` ticks when given (staggered admission)."""
    engine = engine_cls(cfg, params, slots=slots, max_len=max_len, **kw)
    reqs = [request_cls(i, p, max_new_tokens=n, eos_token=eos)
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


def _both(setup, prompts, max_new, **kw):
    cfg, params, jcfg, jparams = setup
    ours = _run(ServeEngine, Request, cfg, params, prompts, max_new,
                device="cpu", **kw)
    ref = _run(JaxEngine, JaxRequest, jcfg, jparams, prompts, max_new, **kw)
    return ours, ref


def _prompts(seed, sizes, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=s).astype(np.int32) for s in sizes]


def test_engine_matches_jax_lockstep(dense_setup):
    cfg = dense_setup[0]
    prompts = _prompts(0, [12, 12, 12], cfg.vocab)
    (toks, stats), (jtoks, jstats) = _both(dense_setup, prompts, [6] * 3,
                                           slots=2, max_len=48)
    assert toks == jtoks and stats == jstats
    assert stats[1] == 3


def test_engine_matches_jax_staggered_admission(dense_setup):
    cfg = dense_setup[0]
    prompts = _prompts(1, [16, 8], cfg.vocab)
    (toks, stats), (jtoks, jstats) = _both(dense_setup, prompts, [8, 4],
                                           slots=2, max_len=48, ticks_before=3)
    assert toks == jtoks and stats == jstats


def test_engine_matches_jax_slot_reuse(dense_setup):
    cfg = dense_setup[0]
    prompts = _prompts(2, [10] * 5, cfg.vocab)
    (toks, stats), (jtoks, jstats) = _both(dense_setup, prompts, [3] * 5,
                                           slots=2, max_len=32)
    assert toks == jtoks and stats == jstats
    assert stats == (5, 5, stats[2], 15) and stats[2] <= 12


def test_engine_matches_jax_eos_frees_slot(dense_setup):
    cfg, params, jcfg, jparams = dense_setup
    (p,) = _prompts(3, [10], cfg.vocab)
    ref = list(np.asarray(jax_serve_batch(jcfg, jparams, jnp.asarray(p[None]), 8)[0, 10:]))
    eos = int(ref[2])   # EOS at the 3rd generated token
    (toks, stats), (jtoks, jstats) = _both(dense_setup, [p], [8], slots=1,
                                           max_len=32, eos=eos)
    assert toks == jtoks == [ref[:3]] and stats == jstats


def test_engine_kernel_and_torch_impls_agree(dense_setup):
    """attention_impl "kernel" (the plain version on the CPU) and "torch"
    give the same greedy tokens."""
    cfg, params = dense_setup[:2]
    prompts = _prompts(4, [9, 14], cfg.vocab)
    outs = [_run(ServeEngine, Request, cfg, params, prompts, [5, 5], slots=2,
                 max_len=32, device="cpu",
                 tuning=CellTuning(compute_dtype="float32", attention_impl=impl))
            for impl in ("kernel", "torch")]
    assert outs[0] == outs[1]


def test_serve_batch_matches_jax(dense_setup):
    cfg, params, jcfg, jparams = dense_setup
    prompts = np.stack(_prompts(5, [11, 11, 11], cfg.vocab))
    ours = serve_batch(cfg, params, prompts, 7, device="cpu")
    ref = jax_serve_batch(jcfg, jparams, jnp.asarray(prompts), 7)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_engine_prefill_counts_tokens(dense_setup):
    cfg, params = dense_setup[:2]
    engine = ServeEngine(cfg, params, slots=2, max_len=32, device="cpu")
    for i, p in enumerate(_prompts(6, [7, 5, 9], cfg.vocab)):
        engine.submit(Request(i, p, max_new_tokens=2))
    stats = engine.run_until_drained()
    assert stats.prefill_tokens == 21 and stats.prefill_s > 0 and stats.decode_s > 0
    assert engine.cache["k"].dtype == torch.float32


# --------------------------------------------------------------------------
# hybrid (zamba2): state lanes written whole, shared KV padded
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hybrid_setup():
    jcfg = jax_reduced(JAX_ARCHS["zamba2-1.2b"])
    jparams = jax_init(jax.random.PRNGKey(2), jax_build_schema(jcfg), jnp.float32)
    cfg = reduced(ARCHS["zamba2-1.2b"])
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, params, jcfg, jparams


def test_hybrid_engine_matches_jax_lockstep(hybrid_setup):
    cfg = hybrid_setup[0]
    prompts = _prompts(10, [12, 12, 12], cfg.vocab)
    (toks, stats), (jtoks, jstats) = _both(hybrid_setup, prompts, [5] * 3,
                                           slots=2, max_len=40)
    assert toks == jtoks and stats == jstats
    assert stats[1] == 3


def test_hybrid_engine_matches_jax_staggered_admission(hybrid_setup):
    """Prompts of 13 and 9 tokens: neither is a multiple of the chunk (8)."""
    cfg = hybrid_setup[0]
    prompts = _prompts(11, [13, 9], cfg.vocab)
    (toks, stats), (jtoks, jstats) = _both(hybrid_setup, prompts, [6, 4],
                                           slots=2, max_len=40, ticks_before=3)
    assert toks == jtoks and stats == jstats


def test_hybrid_engine_matches_jax_slot_reuse(hybrid_setup):
    """Five requests through two slots: every admission overwrites the
    state lanes a finished (or idle, decoding garbage) slot left behind."""
    cfg = hybrid_setup[0]
    prompts = _prompts(12, [10, 7, 11, 10, 6], cfg.vocab)
    (toks, stats), (jtoks, jstats) = _both(hybrid_setup, prompts, [3] * 5,
                                           slots=2, max_len=32)
    assert toks == jtoks and stats == jstats
    assert stats[0] == stats[1] == 5 and stats[3] == 15


def test_hybrid_engine_kernel_and_torch_impls_agree(hybrid_setup):
    cfg, params = hybrid_setup[:2]
    prompts = _prompts(13, [9, 14], cfg.vocab)
    outs = [_run(ServeEngine, Request, cfg, params, prompts, [5, 5], slots=2,
                 max_len=32, device="cpu",
                 tuning=CellTuning(compute_dtype="float32", attention_impl=impl,
                                   ssm_impl=impl))
            for impl in ("kernel", "torch")]
    assert outs[0] == outs[1]


def test_hybrid_serve_batch_matches_jax(hybrid_setup):
    cfg, params, jcfg, jparams = hybrid_setup
    prompts = np.stack(_prompts(14, [11, 11, 11], cfg.vocab))
    ours = serve_batch(cfg, params, prompts, 6, device="cpu")
    ref = jax_serve_batch(jcfg, jparams, jnp.asarray(prompts), 6)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_hybrid_engine_cache_lanes(hybrid_setup):
    """The pool holds every leaf of the hybrid schema; the SSM state stays
    float32 under a bfloat16 compute dtype."""
    cfg, params = hybrid_setup[:2]
    engine = ServeEngine(cfg, params, slots=2, max_len=24, device="cpu",
                         tuning=CellTuning(compute_dtype="bfloat16"))
    assert set(engine.cache) == {"conv_x", "conv_B", "conv_C", "ssm",
                                 "shared_k", "shared_v", "pos"}
    assert engine.cache["ssm"].dtype == torch.float32
    assert engine.cache["shared_k"].dtype == torch.bfloat16
    engine.submit(Request(0, _prompts(15, [10], cfg.vocab)[0], max_new_tokens=3))
    stats = engine.run_until_drained()
    assert stats.finished == 1 and stats.decoded_tokens == 3


def test_decode_runner_on_the_cpu_is_the_eager_step(dense_setup):
    """On the CPU the engine's decode runner is the eager step: the same
    tokens and counters as an engine that calls the step itself, no graph,
    no replay, and every traced decode step marked ``graph`` 0."""
    from repro_torch.obs.trace import TRACER

    cfg, params = dense_setup[:2]
    prompts = _prompts(16, [9, 14, 6], cfg.vocab)
    engines = [ServeEngine(cfg, params, slots=2, max_len=32, device="cpu")
               for _ in range(2)]
    engines[1]._decode = engines[1]._graph.step
    outs = []
    TRACER.enabled = True
    TRACER.clear()
    try:
        for engine in engines:
            reqs = [Request(i, p, max_new_tokens=5) for i, p in enumerate(prompts)]
            for r in reqs:
                engine.submit(r)
            stats = engine.run_until_drained()
            outs.append(([r.generated for r in reqs],
                         tuple(getattr(stats, c) for c in COUNTERS)))
        steps = TRACER.by_name("serve.decode.enqueue")
    finally:
        TRACER.enabled = False
        TRACER.clear()
    assert outs[0] == outs[1]
    assert engines[0]._graph._cuda_graph is None and engines[0]._graph.replays == 0
    assert engines[0].stats.decode_graph_replays == 0
    assert steps and all(s.attrs["graph"] == 0 for s in steps)


def test_decode_runner_on_dtensor_parameters_is_the_eager_step():
    """DTensor parameters (a mesh's) run the eager step on every call, and
    are never captured; of plain tensors only those on a CUDA device are."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import fake_world, make_mesh_from_shape
    from repro_torch.serve.engine import DecodeGraph

    calls = []

    def step(params, cache, tokens):
        calls.append(tokens)
        return tokens.float(), cache

    with FakeTensorMode():
        on_card = torch.empty(2, device="cuda")
    assert DecodeGraph.graphable(on_card)
    assert not DecodeGraph.graphable(torch.empty(2))
    with fake_world(1):
        mesh = make_mesh_from_shape((1,), ("data",), "cpu")
        params = {"w": DTensor.from_local(torch.ones(4, 2), mesh, (Replicate(),))}
        assert not DecodeGraph.graphable(params["w"])
        assert not DecodeGraph.graphable(
            DTensor.from_local(on_card, mesh, (Replicate(),), run_check=False))
        runner = DecodeGraph(step)
        cache = {"pos": torch.zeros(2, dtype=torch.int32)}
        for i in range(3):
            toks = torch.full((2, 1), i)
            logits, out = runner(params, cache, toks)
            assert torch.equal(logits, toks.float()) and out is cache
    assert len(calls) == 3 and runner._cuda_graph is None and runner.replays == 0
