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


# --------------------------------------------------------------------------
# the B=1 prefill padded to a length bucket (replayed as a graph on a card)
# --------------------------------------------------------------------------

def _reduced_arch(name):
    """The reduced twin of a registry architecture, or of granite-4.0-h-small
    (four layers, MAMM)."""
    import dataclasses

    from repro_torch.configs.granite_4_0_h_small import ARCH as GRANITE_4_H

    if name == "granite-4.0-h-small":
        return reduced(dataclasses.replace(GRANITE_4_H, n_layers=4, layer_pattern="MAMM"))
    return reduced(ARCHS[name])


def _prefill_twin(name):
    """A reduced twin of ``name`` on the CPU: seeded float32 weights with
    attention rescaled to its contracted width."""
    from repro_torch.launch.train import rescale_attention
    from repro_torch.models.schema import build_schema
    from repro_torch.models.sharding import init_from_schema

    cfg = _reduced_arch(name)
    params = init_from_schema(0, build_schema(cfg), torch.float32, "cpu")
    rescale_attention(params)
    return cfg, params


@pytest.mark.parametrize("S", [1, 127, 128, 129, 300])
@pytest.mark.parametrize("name", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_padded_prefill_with_last_equals_the_prompt_alone(name, S):
    """A prompt padded at its end to its bucket, read at ``last`` = S - 1,
    gives the unpadded prefill's first-token logits (float32, within 1e-5
    of their magnitude) and its K/V rows ``[:S]`` (within 1e-5 of theirs),
    for the dense and the dropless MoE twin."""
    from repro_torch.models.ops import ShardCtx
    from repro_torch.serve.engine import prefill_bucket
    from repro_torch.train.steps import make_prefill_step

    cfg, params = _prefill_twin(name)
    step = make_prefill_step(cfg, ShardCtx())
    prompt = torch.as_tensor(_prompts(S, [S], cfg.vocab)[0], dtype=torch.int64)[None]
    Sb = prefill_bucket(S)
    padded = torch.zeros(1, Sb, dtype=torch.int64)
    padded[:, :S] = prompt
    logits, cache = step(params, {"tokens": prompt})
    plogits, pcache = step(params, {"tokens": padded}, torch.tensor([S - 1]))
    assert pcache["k"].shape[2] == Sb and int(pcache["pos"]) == Sb
    scale = float(logits.abs().max())
    torch.testing.assert_close(plogits, logits, atol=1e-5 * scale, rtol=0)
    for key in ("k", "v"):
        assert cache[key].shape[2] == S
        torch.testing.assert_close(pcache[key][:, :, :S], cache[key],
                                   atol=1e-5 * float(cache[key].abs().max()), rtol=0)


@pytest.mark.parametrize("S,Sb", [(1, 128), (127, 128), (128, 128), (129, 256),
                                  (300, 384), (1920, 1920), (2047, 2048),
                                  (2048, 2048), (2049, 2176), (3968, 3968)])
def test_prefill_bucket_rule(S, Sb):
    """A prompt pads to the next multiple of 128 tokens, and is replayed
    only where that length is at most 2,048."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.serve.engine import (PREFILL_BUCKET, PREFILL_GRAPH_MAX,
                                          PrefillGraphs, prefill_bucket)

    assert (PREFILL_BUCKET, PREFILL_GRAPH_MAX) == (128, 2048)
    assert prefill_bucket(S) == Sb
    with FakeTensorMode():
        on_card = {"w": torch.empty(2, device="cuda")}
    assert PrefillGraphs(None, pads=True).graphed(on_card, S) == (Sb <= 2048)
    assert not PrefillGraphs(None, pads=False).graphed(on_card, S)


@pytest.mark.parametrize("name,where,graphed", [
    ("qwen2-1.5b", "cuda", True),
    ("granite-moe-3b-a800m", "cuda", True),
    ("granite-moe-3b-a800m/capacity", "cuda", False),
    ("falcon-mamba-7b", "cuda", False),
    ("zamba2-1.2b", "cuda", False),
    ("granite-4.0-h-small", "cuda", False),
    ("whisper-large-v3", "cuda", False),
    ("qwen2-1.5b", "cpu", False),
    ("granite-moe-3b-a800m", "cpu", False),
    ("qwen2-1.5b", "dtensor", False),
])
def test_prefill_graph_family_rule(name, where, graphed):
    """Which engines replay their prefill: those whose cache holds only K/V
    (the dense and the MoE decoders) with plain parameters on a CUDA
    device.  The SSM, hybrid, hybrid-MoE and encoder-decoder stacks, whose
    caches hold state lanes or cross K/V, and any model on the CPU or on a
    mesh's DTensors, prefill eagerly; so does a MoE whose capacity can drop
    tokens (the registry's granite, capacity factor 1.25 over 48 padded
    experts), since the padded pool's capacity would keep tokens the
    prompt alone drops."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import fake_world, make_mesh_from_shape
    from repro_torch.models.model import cache_schema
    from repro_torch.serve.engine import PrefillGraphs, pads_safely

    arch = name.split("/")[0]
    cfg = _reduced_arch(arch)
    if name.endswith("/capacity"):
        cfg = dataclasses.replace(cfg, moe=ARCHS[arch].moe)
        assert cfg.moe.capacity_factor * cfg.moe.top_k < cfg.moe.n_experts_padded
    runner = PrefillGraphs(None, pads_safely(cfg, cache_schema(cfg, 2, 64, cfg.enc_len)))
    if where == "cuda":
        with FakeTensorMode():
            param = torch.empty(2, device="cuda")
        assert runner.graphed({"w": param}, 100) == graphed
    elif where == "cpu":
        engine = ServeEngine(cfg, _prefill_twin(arch)[1], slots=2, max_len=64, device="cpu")
        assert engine._prefill_graphs.pads
        assert engine._prefill_graphs.graphed(engine.params, 100) == graphed
    else:
        with fake_world(1):
            mesh = make_mesh_from_shape((1,), ("data",), "cpu")
            param = DTensor.from_local(torch.ones(4, 2), mesh, (Replicate(),))
            assert runner.pads and runner.graphed({"w": param}, 100) == graphed


@pytest.mark.parametrize("name", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_cpu_engine_prefills_eagerly(name):
    """On the CPU the engine's prefill runner is the eager step: the same
    tokens and counters as an engine that calls the step itself, no
    bucket captured, no replay, and every traced admission marked
    ``graph`` 0."""
    from repro_torch.obs.trace import TRACER

    cfg, params = _prefill_twin(name)
    prompts = _prompts(17, [9, 130, 6, 40], cfg.vocab)
    engines = [ServeEngine(cfg, params, slots=2, max_len=160, device="cpu")
               for _ in range(2)]
    engines[1]._prefill = engines[1]._prefill_graphs.step
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
        admits = TRACER.by_name("serve.prefill.enqueue")
    finally:
        TRACER.enabled = False
        TRACER.clear()
    assert outs[0] == outs[1] and outs[0][1][0] == len(prompts)
    runner = engines[0]._prefill_graphs
    assert runner._buckets == {} and runner.replays == 0
    assert engines[0].stats.prefill_graph_replays == 0
    assert len(admits) == 2 * len(prompts) and all(s.attrs["graph"] == 0 for s in admits)
