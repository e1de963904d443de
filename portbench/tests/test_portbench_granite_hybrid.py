"""The granite-4.0-h-small configuration and its cell on the CPU: a twin
built from the configuration file (every width cut, the pattern MAMM, 8
experts of which 2 are chosen with the shared expert, NoPE, all four
multipliers away from 1) run through the harness; the configuration file
against the published model; the counts, the two new metrics and the
cell's entries in ``BENCHMARK.json``."""
import json
import math
import types

import pytest

import portbench_twin
from portbench_twin import one_thread  # noqa: F401  (fixture)
from portbench.counts import granite_hybrid as counts
from portbench.drivers.serve import arch_config
from portbench.run import Bench, run_cell
from portbench.yardstick.bounds import attention_work
from portbench.yardstick.peaks import Peaks

ROOT = portbench_twin.ROOT
CELL = "granite-4h-small.long-doc"
CONFIG = json.loads((ROOT / "portbench" / "configs" / "granite-4.0-h-small.json").read_text())
TWIN = dict(n_layers=4, layer_pattern="MAMM", d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=32, vocab=500, moe_n_experts=8, moe_top_k=2, moe_n_experts_padded=8,
            moe_capacity_factor=4.0, moe_shared_d_ff=48, ssm_d_state=16, ssm_head_dim=16,
            ssm_chunk=16, attention_multiplier=1 / 16, dtype="float32")
TWIN_TRAFFIC = dict(clients=3, pool=10,
                    prompt={"dist": "lognormal", "median": 48, "sigma": 0.5, "min": 20, "max": 96},
                    output={"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 6, "max": 24})


def twin_bench(seed: int = 2 ** 31 + 23, seconds: float = 4.0) -> Bench:
    bench = Bench(ROOT, CELL, seed, seconds, False, "cpu")
    bench.config.update(TWIN)
    bench.cell["engine"] = {"slots": 3, "max_len": 128}
    bench.cell["traffic"].update(TWIN_TRAFFIC)
    bench.cell["correct"].update(min_tokens_checked=8)
    return bench


@pytest.mark.usefixtures("one_thread")
def test_twin_cell_runs_correct():
    bench = twin_bench()
    assert bench.config["reference"] == "granite_hybrid"
    out = run_cell(bench)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["compared"]["tokens_checked"]["value"] >= 8
    assert out["compared"]["logit_gap_mean"]["value"] < 1e-5        # float32 on both sides
    assert set(out["metrics"]) == {"output_tokens_per_s", "setup_s"}


@pytest.mark.usefixtures("one_thread")
def test_twin_cell_with_its_mamba_state_left_unchanged_is_not_correct(monkeypatch):
    """Decode steps that leave the SSM and conv states as they were: the
    check must see it."""
    from repro_torch.serve import engine as eng

    init = eng.ServeEngine.__init__

    def broken_init(self, *a, **kw):
        init(self, *a, **kw)
        step = self._decode

        def decode(params, cache, toks):
            saved = {k: cache[k].clone() for k in ("conv_x", "conv_B", "conv_C", "ssm")}
            out = step(params, cache, toks)
            for k, v in saved.items():
                cache[k].copy_(v)
            return out

        self._decode = decode

    monkeypatch.setattr(eng.ServeEngine, "__init__", broken_init)
    out = run_cell(twin_bench())
    gap = out["compared"]["logit_gap_mean"]
    assert not out["correct"] and gap["value"] > gap["limit"], out["compared"]


def test_config_file_is_the_published_model_cut_to_stage_one():
    from repro_torch.configs.granite_4_0_h_small import ARCH

    c = CONFIG
    assert c["n_layers"] == c["num_hidden_layers"] == len(c["layer_types"]) == 20
    assert c["layer_pattern"] == "".join("A" if t == "attention" else "M"
                                         for t in c["layer_types"])
    assert c["layer_pattern"] == ARCH.layer_pattern[:20] == "MMMMMAMMMMMMMMMAMMMM"
    cfg = arch_config(c)
    hash(cfg)                     # every field hashable
    for key in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "tie_embeddings", "rope",
                "embedding_multiplier", "attention_multiplier", "residual_multiplier",
                "logits_scaling", "moe", "ssm", "hd"):
        assert getattr(cfg, key) == getattr(ARCH, key), key
    # the published values under their own keys
    assert (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]) == (4096, 32, 8)
    assert (c["mamba_n_heads"] * c["mamba_d_head"], c["mamba_d_state"]) == (8192, 128)
    assert (c["num_local_experts"], c["num_experts_per_tok"], c["intermediate_size"],
            c["shared_intermediate_size"]) == (72, 10, 768, 1536)
    assert c["position_embedding_type"] == "nope" and c["vocab_size"] == 100352
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {x["name"]: x for x in bm["configs"]}["granite-4.0-h-small"]
    assert entry["file"] == "portbench/configs/granite-4.0-h-small.json"
    assert "n_layers" in entry["reduced"] and "num_hidden_layers" in entry["reduced"]


def test_cell_is_listed_where_its_readers_read_it():
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for k in ("end_to_end", "per_layer") for m in bm[k]
              if CELL in m.get("workloads", [CELL])}
    assert listed == {"output_tokens_per_s", "setup_s", "prefill_ms.mean", "prefill.mfu_pct",
                      "flash_attention_roofline", "decode_tick_ms.mean",
                      "decode.enqueue_ms.mean", "decode.wait_ms.mean", "decode.moe_enqueue_pct",
                      "decode.launches_per_tick", "ssd_scan_roofline",
                      "decode.mamba_enqueue_pct", "device_idle_pct.long_doc",
                      "queue_wait_ms.mean", "prefill.enqueue_ms.mean", "prefill.wait_ms.mean",
                      "decode.slot_use_pct"}
    cell = {w["name"]: w for w in bm["workloads"]}[CELL]
    assert cell["chips"] == 1 and cell["config"] == "granite-4.0-h-small"


def test_counts_hand_count():
    cfg = dict(n_layers=3, layer_pattern="MAM", d_model=4, n_heads=2, n_kv_heads=1, head_dim=3,
               d_ff=5, vocab=10, moe_n_experts=6, moe_top_k=2, moe_shared_d_ff=7,
               ssm_d_state=2, ssm_head_dim=4, ssm_expand=2)
    S, d = 6, 4
    # mamba: z, x (8 each), B, C (2 each), dt (2 heads) in; out 8 -> 4; recurrence 4 S nh hp n
    mamba = 2 * S * d * (8 + 8 + 2 + 2 + 2) + 2 * S * 8 * d + 4 * S * 2 * 4 * 2
    # attention: q (2 heads of 3), k, v (1 head), o; causal pairs 21 at 4 hd a head
    attn = 2 * S * d * 2 * 3 + 2 * 2 * S * d * 1 * 3 + 2 * S * 2 * 3 * d + 4 * 2 * 3 * 21
    # router; 2 experts of 5 and the shared of 7, three products each
    moe = 2 * S * d * 6 + 3 * 2 * S * d * (2 * 5 + 7)
    assert counts.prefill_flops(cfg, S) == 2 * mamba + attn + 3 * moe + 2 * d * 10
    assert counts.attention_calls(cfg, S) == [(1, S, S, 2, 1, 3, True)]
    assert counts.ssd_calls(cfg, S) == [(1, S, 2, 4, 2)] * 2
    assert attention_work(1, S, S, 2, 1, 3, True, 2)[0] == 4 * 2 * 3 * 21


def _reader(name):
    bench = Bench(ROOT, CELL, 1, 1.0, True, "cpu")
    return bench.reader(name)


def test_ssd_scan_roofline_from_a_hand_built_record():
    reader = _reader("ssd_scan_roofline")
    peaks = Peaks(bf16_flops=989e12, f32_flops=67e12, mem_bytes=3.35e12)
    S, nh, hp, n = 2048, 128, 64, 128
    # the bound of one 2,048-token prompt's scan, written out
    flops = 4 * S * nh * hp * n
    nbytes = 2 * (S * nh * hp + S * nh + S * n + S * n + S * nh * hp) + 4 * nh * hp * n
    one = max(flops / peaks.bf16_flops, nbytes / peaks.mem_bytes)
    assert one == nbytes / peaks.mem_bytes                       # memory-bound at bf16
    assert reader.ssd_work(1, S, nh, hp, n, 2) == (flops, float(nbytes))
    rec = {"config": CONFIG, "counts": counts, "device_name": "NVIDIA H100 80GB HBM3",
           "slice": {"admitted_prompts": [S], "by_name": {
               "void (anonymous namespace)::ssd_output<float>(float const*)": {
                   "count": 18, "seconds": 0.010},
               "void (anonymous namespace)::ssd_cb<float>(float const*)": {
                   "count": 18, "seconds": 0.002},
               "flash_fwd_bf16": {"count": 2, "seconds": 5.0}}}}
    got = reader.read(rec)
    assert got == pytest.approx(100 * 18 * one / 0.012)
    assert 0 < got < 100
    assert reader.read(dict(rec, counts=types.SimpleNamespace())) is None  # no ssd_calls
    assert reader.read(dict(rec, slice=dict(rec["slice"], by_name={}))) is None


@pytest.fixture
def tracer():
    from repro_torch.obs.trace import TRACER

    TRACER.clear()
    TRACER.enabled = True
    yield TRACER
    TRACER.enabled = False
    TRACER.clear()


def test_mamba_enqueue_share_from_hand_built_spans(tracer):
    reader = _reader("decode.mamba_enqueue_pct")
    for t in (0.0, 10.0):                         # two decode steps of 4 s
        step = tracer.add("serve.decode.enqueue", t, t + 4.0)
        m = tracer.add("layer.mamba", t + 0.5, t + 1.5, parent=step, tokens=32)
        tracer.add("ssm.scan", t + 0.6, t + 0.9, parent=m)     # inside: counted once
        tracer.add("layer.attn", t + 2.0, t + 2.5, parent=step)
        tracer.add("layer.mamba", t + 3.0, t + 3.5, parent=step, tokens=32)
    tracer.add("layer.mamba", 20.0, 21.0, tokens=500)          # a prefill's: outside
    assert reader.read({}) == pytest.approx(100 * 3.0 / 8.0)
    tracer.clear()
    assert reader.read({}) is None


def test_device_idle_of_the_cell_is_read_by_its_prefix():
    assert _reader("device_idle_pct.long_doc").read(
        {"slice": {"busy_s": 1.5, "window_s": 6.0}}) == pytest.approx(75.0)


def test_cell_sizes():
    """The engine holds the longest prompt and the longest output, and the
    pool holds 32 slots x 12,800 positions: 3.4 GB of K/V and 2.4 GB of state."""
    cell = json.loads((ROOT / "portbench" / "workloads" / f"{CELL}.json").read_text())
    t, eng = cell["traffic"], cell["engine"]
    assert eng["max_len"] == t["prompt"]["max"] + t["output"]["max"]
    assert eng["slots"] == t["clients"] == 32 and t["loop"] == "closed" and t["in_flight"]
    kv = 2 * 2 * eng["slots"] * eng["max_len"] * 8 * 128 * 2         # k, v; 2 A layers; bf16
    state = 18 * eng["slots"] * 128 * 64 * 128 * 4                   # 18 M layers; float32
    assert math.isclose(kv / 1e9, 3.36, rel_tol=1e-2)
    assert math.isclose(state / 1e9, 2.42, rel_tol=1e-2)
