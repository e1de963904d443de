"""granite-4.0-h's layer stack on the port (``Family.HYBRID_MOE``): mamba2
and NoPE attention mixers by ``layer_pattern``, each followed by a MoE MLP
with a shared expert, and granite's four scalar multipliers.  Held on the
CPU, in float32, against the benchmark's plain reference
(``portbench/reference/granite_hybrid.py``), on the weights the benchmark
draws (``param_spec``), at a cut width: the pattern MAMM, d_model 64, 8
experts of which 2 are chosen, every multiplier away from 1.

Tolerance ``TOL``: the program's logits, from a prefill through
``ServeEngine`` and then decode steps through its pooled cache, lie within
1e-4 of the reference's largest logit of the same positions, from its full
forward pass.  Both sides compute in float32 and differ only in the order
of their sums (the chunked SSD scan and the one-step recurrence against
the dual form, the serial MoE combine against ``index_add_``, the cached
attention against the full causal product): they agree to ~8e-7 of it.
Every ablation below (a part of the block left out) moves the logits by
more than 0.5 of it, five thousand times the tolerance.
"""
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.drivers.serve import arch_config
from portbench.run import load_module
from portbench.yardstick.weights import draw
from repro_torch.configs.granite_4_0_h_small import ARCH as PUBLISHED
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels.flash_attention import attention_reference
from repro_torch.kernels.ops import decode_attention, flash_attention
from repro_torch.models.config import CellTuning, Family
from repro_torch.models.model import cache_schema
from repro_torch.models.moe import moe_mlp
from repro_torch.models.ops import NOSHARD
from repro_torch.models.schema import build_schema
from repro_torch.models.sharding import map_schema
from repro_torch.obs.trace import TRACER
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
REF = load_module(ROOT / "portbench" / "reference" / "granite_hybrid.py",
                  "portbench_ref_granite_hybrid")
TOL = 1e-4

TWIN = dict(json.loads((ROOT / "portbench" / "configs" / "granite-4.0-h-small.json").read_text()),
            n_layers=4, layer_pattern="MAMM", d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=32, vocab=500, moe_n_experts=8, moe_top_k=2, moe_n_experts_padded=8,
            moe_capacity_factor=4.0, moe_shared_d_ff=48, ssm_d_state=16, ssm_head_dim=16,
            ssm_chunk=16, attention_multiplier=1 / 16, dtype="float32")
PROMPTS = (37, 21)          # ragged against the chunk of 16
NEW_TOKENS = 10             # a prefill and 9 decode steps each


@pytest.fixture(scope="module")
def twin():
    cfg = arch_config(TWIN)
    weights = draw(REF.param_spec(TWIN), 2 ** 31 + 99, "cpu", torch.float32)
    return cfg, weights


@pytest.fixture
def fresh_tracer():
    TRACER.enabled = False
    TRACER.clear()
    yield TRACER
    TRACER.enabled = False
    TRACER.clear()


def _serve(cfg, weights, tuning=None):
    """Serve the prompts, the second admitted three ticks after the first,
    on two slots.  Returns, per request, its prompt, its tokens and the
    program's logits that chose them: the prefill's, then each decode
    step's row of its slot."""
    engine = ServeEngine(cfg, weights, slots=2, max_len=64, device="cpu",
                         tuning=tuning or CellTuning(compute_dtype="float32"))
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n), max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(PROMPTS)]
    rows = {r.request_id: [] for r in reqs}
    prefill, decode = engine._prefill, engine._decode

    def traced_prefill(params, batch):
        logits, cache = prefill(params, batch)
        owner = next(r for r in reqs if np.array_equal(r.prompt, batch["tokens"][0].numpy()))
        rows[owner.request_id].append(logits[0, :cfg.vocab].clone())
        return logits, cache

    def traced_decode(params, cache, toks):
        logits, new = decode(params, cache, toks)
        for slot, req in enumerate(engine.slot_req):
            if req is not None:
                rows[req.request_id].append(logits[slot, :cfg.vocab].clone())
        return logits, new

    engine._prefill, engine._decode = traced_prefill, traced_decode
    engine.submit(reqs[0])
    for _ in range(3):
        engine.tick()
    engine.submit(reqs[1])
    engine.run_until_drained()
    return [(r.prompt, r.generated, torch.stack(rows[r.request_id][:len(r.generated)]))
            for r in reqs]


def _worst_gap(cfg, weights, ref_weights, tuning=None) -> float:
    """The largest distance between the program's logits and the
    reference's, over every token served, as a share of the reference's
    largest logit magnitude there."""
    worst = 0.0
    for prompt, gen, logits in _serve(cfg, weights, tuning):
        assert len(gen) == NEW_TOKENS
        toks = torch.as_tensor(np.concatenate([prompt, gen[:-1]]))
        ref = REF.logits(ref_weights, TWIN, toks, len(prompt) - 1)
        worst = max(worst, float((logits - ref).abs().max() / ref.abs().max()))
    return worst


@pytest.mark.parametrize("impl,rows", [("kernel", False), ("torch", False), ("kernel", True)])
def test_prefill_and_decode_match_the_reference(twin, impl, rows):
    cfg, weights = twin
    tuning = CellTuning(compute_dtype="float32", attention_impl=impl, ssm_impl=impl,
                        moe_row_dispatch=rows)
    assert _worst_gap(cfg, weights, weights, tuning) < TOL


def _without_d(weights):
    return dict(weights, mamba=dict(weights["mamba"], D=torch.zeros_like(weights["mamba"]["D"])))


ABLATIONS = {
    "shared_expert": lambda c: dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, shared_d_ff=0)),
    "rotary_left_on": lambda c: dataclasses.replace(c, rope=True),
    "embedding_multiplier": lambda c: dataclasses.replace(c, embedding_multiplier=1.0),
    "attention_multiplier": lambda c: dataclasses.replace(c, attention_multiplier=None),
    "residual_multiplier": lambda c: dataclasses.replace(c, residual_multiplier=1.0),
    "logits_scaling": lambda c: dataclasses.replace(c, logits_scaling=1.0),
}


@pytest.mark.parametrize("part", sorted(ABLATIONS) + ["d_skip"])
def test_each_part_left_out_fails_the_tolerance(twin, part):
    cfg, weights = twin
    if part == "d_skip":
        gap = _worst_gap(cfg, _without_d(weights), weights)
    else:
        gap = _worst_gap(ABLATIONS[part](cfg), weights, weights)
    assert gap > 100 * TOL, gap


def test_dual_form_equals_the_step_recurrence():
    g = torch.Generator().manual_seed(3)
    S, nh, hp, n = 45, 3, 4, 5
    x = torch.randn(S, nh, hp, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(S, nh, generator=g)) * 0.5
    A = -torch.exp(torch.randn(nh, generator=g))
    B, C = torch.randn(S, n, generator=g), torch.randn(S, n, generator=g)
    H = torch.zeros(nh, hp, n)
    want = torch.empty(S, nh, hp)
    for t in range(S):
        H = torch.exp(dt[t] * A)[:, None, None] * H \
            + dt[t][:, None, None] * x[t][:, :, None] * B[t][None, None, :]
        want[t] = H @ C[t]
    got = REF.ssd_dual(x, dt, A, B, C, rows=8)            # blocks, a ragged last one
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_published_capacity_drops_no_token():
    """C = ceil(T k / E) * 7.2 holds every token for every pool size the
    benchmark's prefills and decode steps can have, and the twin's factor
    drops none of its tokens."""
    moe = PUBLISHED.moe
    assert moe.capacity_factor == moe.n_experts / moe.top_k
    for T in range(1, 20_001):
        assert max(8, int(-(-T * moe.top_k // moe.n_experts) * moe.capacity_factor)) >= T


def test_twin_moe_drops_no_token(twin):
    cfg, weights = twin
    moe = {k: v[0] for k, v in weights["moe"].items()}
    x = torch.randn(1, 57, cfg.d_model, generator=torch.Generator().manual_seed(1))
    _, aux = moe_mlp(moe, x, cfg, NOSHARD, with_aux=True)
    assert float(aux["drop_fraction"]) == 0.0


def test_shared_expert_is_added_to_the_routed_sum(twin):
    cfg, weights = twin
    moe = {k: v[0] for k, v in weights["moe"].items()}
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(2))
    routed = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, shared_d_ff=0))
    y, _ = moe_mlp(moe, x, cfg, NOSHARD, with_aux=False)
    y0, _ = moe_mlp(moe, x, routed, NOSHARD, with_aux=False)
    xn = REF._rmsnorm(x, moe["ln"], cfg.norm_eps)
    shared = (torch.nn.functional.silu(xn @ moe["shared_gate"]) * (xn @ moe["shared_up"])) \
        @ moe["shared_down"]
    torch.testing.assert_close(y, y0 + shared, atol=1e-5, rtol=1e-5)


def test_cache_holds_kv_for_attention_layers_and_state_for_mamba_layers(twin):
    cfg = twin[0]
    schema = cache_schema(cfg, batch=3, max_len=40)
    assert schema["k"].shape == (1, 3, 40, cfg.n_kv_heads, cfg.hd)      # one A layer
    assert schema["v"].shape == schema["k"].shape
    nh = cfg.d_inner // cfg.ssm.head_dim
    assert schema["ssm"].shape == (3, 3, nh, cfg.ssm.head_dim, cfg.ssm.d_state)
    assert schema["ssm"].dtype == torch.float32
    for key in ("conv_x", "conv_B", "conv_C"):
        assert schema[key].shape[:3] == (3, 3, cfg.ssm.d_conv - 1)
    assert set(schema) == {"k", "v", "conv_x", "conv_B", "conv_C", "ssm", "pos"}
    full = cache_schema(PUBLISHED, batch=32, max_len=12_800)
    nbytes = map_schema(lambda ps: math.prod(ps.shape) * (4 if ps.dtype else 2), full)
    assert nbytes["k"] == 4 * 32 * 12_800 * 8 * 128 * 2                   # 4 A layers, bf16
    assert nbytes["ssm"] == 36 * 32 * 128 * 64 * 128 * 4                  # 36 M layers, f32


def test_params_follow_the_pattern(twin):
    cfg, weights = twin
    shapes = map_schema(lambda ps: ps.shape, build_schema(cfg))
    assert shapes["mamba"]["wz"][0] == 3 and shapes["attn"]["wq"][0] == 1
    assert shapes["moe"]["shared_down"] == (4, 48, cfg.d_model)
    got = {k: {n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict) else tuple(v.shape)
           for k, v in weights.items()}
    assert got == shapes


def test_published_config_and_its_sizes():
    assert PUBLISHED.family == Family.HYBRID_MOE and PUBLISHED.name not in ARCHS
    assert PUBLISHED.attn_layers == (5, 15, 25, 35) and len(PUBLISHED.mamba_layers) == 36
    assert PUBLISHED.d_inner // PUBLISHED.ssm.head_dim == 128
    assert 32.0e9 < PUBLISHED.param_count() < 32.4e9           # "32B"
    assert 8.5e9 < PUBLISHED.active_param_count() < 9.5e9     # "A9B"
    stage = dataclasses.replace(PUBLISHED, n_layers=20, layer_pattern=PUBLISHED.layer_pattern[:20])
    assert 16.2e9 < stage.param_count() < 16.4e9
    hash(PUBLISHED)
    with pytest.raises(ValueError, match="layer_pattern"):
        dataclasses.replace(PUBLISHED, layer_pattern="MAX" * 13 + "M")
    with pytest.raises(ValueError, match="layer_pattern"):
        dataclasses.replace(PUBLISHED, n_layers=39)


def test_spans_of_one_prefill_and_one_decode_step(twin, fresh_tracer):
    cfg, weights = twin
    engine = ServeEngine(cfg, weights, slots=2, max_len=64, device="cpu",
                         tuning=CellTuning(compute_dtype="float32"))
    engine.submit(Request(0, np.arange(30) % cfg.vocab, max_new_tokens=4))
    fresh_tracer.enabled = True
    engine.tick()                                   # one admission, one decode step
    fresh_tracer.enabled = False
    spans = list(fresh_tracer.spans)
    by_id = {s.span_id: s for s in spans}

    def under(s, name):
        while s.parent is not None:
            s = by_id[s.parent]
            if s.name == name:
                return True
        return False

    mamba = [s for s in spans if s.name == "layer.mamba"]
    assert [s.attrs["tokens"] for s in mamba if under(s, "serve.prefill.enqueue")] == [30] * 3
    assert [s.attrs["tokens"] for s in mamba if under(s, "serve.decode.enqueue")] == [2] * 3
    scans = [s for s in spans if s.name == "ssm.scan"]
    assert len(scans) == 3 and all(under(s, "layer.mamba") for s in scans)
    assert all(under(s, "serve.prefill.enqueue") for s in scans)
    shared = [s for s in spans if s.name == "moe.shared"]
    assert len(shared) == 8                         # 4 layers, prefill and decode
    assert sum(s.name == "layer.attn" for s in spans) == 2
    fresh_tracer.clear()
    engine.tick()                                   # the tracer off: nothing
    assert fresh_tracer.spans == []


@pytest.mark.parametrize("scale", [None, 0.0625])
def test_attention_operators_take_a_scale(scale):
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 7, 4, 16, generator=g)
    k, v = torch.randn(2, 7, 2, 16, generator=g), torch.randn(2, 7, 2, 16, generator=g)
    want = attention_reference(q, k, v, causal=True, scale=scale)
    torch.testing.assert_close(flash_attention(q, k, v, causal=True, scale=scale), want)
    lens = torch.tensor([3, 7])
    want = attention_reference(q[:, :1], k, v, causal=False, kv_len=lens, scale=scale)
    torch.testing.assert_close(decode_attention(q[:, :1], k, v, lens, scale), want)
    if scale is not None:
        assert not torch.allclose(want, attention_reference(q[:, :1], k, v, causal=False,
                                                            kv_len=lens))

