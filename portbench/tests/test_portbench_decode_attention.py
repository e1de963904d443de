"""The decode attention kernel's share of its roofline
(``metrics/decode_attention_roofline.py``) on a synthetic record: the
program's ``serve.tick`` counters and the slice's device time by kernel."""
import pytest

from portbench_twin import twin_bench

NAME = "decode_attention_roofline"
CONFIG = {"n_layers": 32, "d_model": 1536, "n_heads": 24, "n_kv_heads": 8,
          "dtype": "bfloat16"}
BY_NAME = {
    "void (anonymous namespace)::decode_attn_partial<__nv_bfloat16, 64, 3>(...)":
        {"count": 64, "seconds": 0.004},
    "void (anonymous namespace)::decode_attn_combine<__nv_bfloat16>(...)":
        {"count": 64, "seconds": 0.0005},
    "void (anonymous namespace)::flash_fwd_bf16_tc<64>(...)": {"count": 32, "seconds": 0.01},
}


@pytest.fixture
def tracer():
    from repro_torch.obs.trace import TRACER

    TRACER.enabled = True
    TRACER.clear()
    yield TRACER
    TRACER.enabled = False
    TRACER.clear()


def _record(by_name=BY_NAME, device="NVIDIA H100 80GB HBM3"):
    return {"slice": {"by_name": by_name}, "config": CONFIG, "device_name": device}


def test_listed_for_both_cells_in_the_kernels_layer():
    bench = twin_bench("granite-moe-3b.chat")
    m = {m["name"]: m for m in bench.benchmark["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == \
        ("device_trace", "kernels", "output_tokens_per_s", "%")
    assert m["workloads"] == ["granite-moe-3b.long-prompt", "granite-moe-3b.chat"]
    assert bench.reader(NAME).__name__ == "portbench_metric_" + NAME


def test_reads_the_decoding_ticks_over_the_kernels_time(tracer):
    tracer.add("serve.tick", 0.0, 0.1, slots=256, live=200, kv_tokens=150_000)
    tracer.add("serve.tick", 0.1, 0.2, slots=256, live=0, kv_tokens=0)
    tracer.add("serve.tick", 0.2, 0.3, slots=256, live=256, kv_tokens=160_000)
    got = twin_bench("granite-moe-3b.chat").reader(NAME).read(_record())
    # per tick, 32 layers of the larger of 4 H hd kv_tokens at 989 TFLOP/s
    # and 2 bytes x hd x (2 KV kv_tokens + 2 H slots) at 3.35 TB/s: bytes
    bound = sum(32 * max(4 * 24 * 64 * t / 989e12,
                         2 * 64 * (2 * 8 * t + 2 * 24 * 256) / 3.35e12)
                for t in (150_000, 160_000))
    assert bound == pytest.approx(32 * 2 * 64 * (2 * 8 * 310_000 + 4 * 24 * 256) / 3.35e12)
    assert got == pytest.approx(100.0 * bound / 0.0045, rel=1e-12)


def test_reads_nothing_without_the_counter_or_the_kernels(tracer):
    reader = twin_bench("granite-moe-3b.chat").reader(NAME)
    tracer.add("serve.tick", 0.0, 0.1, slots=256, live=200)     # a program without the counter
    assert reader.read(_record()) is None
    tracer.add("serve.tick", 0.1, 0.2, slots=256, live=200, kv_tokens=150_000)
    flash_only = {n: v for n, v in BY_NAME.items() if "flash" in n}
    assert reader.read(_record(flash_only)) is None             # nor without the kernels
    assert reader.read({"slice": None, "config": CONFIG, "device_name": None}) is None
    assert reader.read(_record()) > 0
