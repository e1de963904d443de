"""The readers of the program's spans (``yardstick/spans.py`` and the metrics
that use it) on the CPU twin: a run under a CPU profiler, as the traced
slice runs under the device trace, gives every reader a finite value; a
run with no profiler leaves the program's tracer empty."""
import math

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench_twin import one_thread, twin_bench  # noqa: F401  (fixture)
from portbench.run import run_cell

pytestmark = pytest.mark.usefixtures("one_thread")

CELL = "granite-moe-3b.long-prompt"
SPAN_METRICS = ["queue_wait_ms.mean", "prefill.enqueue_ms.mean", "prefill.wait_ms.mean",
                "decode.enqueue_ms.mean", "decode.wait_ms.mean", "decode.moe_enqueue_pct",
                "decode.slot_use_pct"]


@pytest.fixture
def tracer():
    from repro_torch.obs.trace import TRACER

    TRACER.enabled = False
    TRACER.clear()
    yield TRACER
    TRACER.clear()


def test_span_metrics_are_listed_as_program_spans():
    bench = twin_bench(CELL)
    listed = {m["name"]: m for m in bench.benchmark["per_layer"]}
    for name in SPAN_METRICS:
        assert listed[name]["source"] == "program_span"
        assert bench.reader(name).__name__ == "portbench_metric_" + name.replace(".", "_")


def test_every_span_reader_is_finite_under_a_profiler(tracer):
    bench = twin_bench(CELL, seconds=2.0)
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_cell(bench)
    assert out["correct"], out["compared"]
    values = {name: bench.reader(name).read({}) for name in SPAN_METRICS}
    assert all(v is not None and math.isfinite(v) for v in values.values()), values
    assert 0 < values["decode.moe_enqueue_pct"] < 100
    assert 0 < values["decode.slot_use_pct"] <= 100
    assert values["queue_wait_ms.mean"] >= 0


def test_an_untraced_run_leaves_the_tracer_empty(tracer):
    bench = twin_bench(CELL, seconds=2.0)
    run_cell(bench)
    assert tracer.spans == []
    assert all(bench.reader(name).read({}) is None for name in SPAN_METRICS)
