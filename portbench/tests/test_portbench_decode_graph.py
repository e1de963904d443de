"""``decode.graph_pct``, the share of the traced slice's decode steps that
replayed the program's captured CUDA graph: on hand-built span lists, and
on the CPU twin, where the engine runs its eager step."""
import pytest
from torch.profiler import ProfilerActivity, profile

from portbench_twin import one_thread, twin_bench  # noqa: F401  (fixture)
from portbench.run import run_cell

pytestmark = pytest.mark.usefixtures("one_thread")

CELL = "granite-moe-3b.long-prompt"


@pytest.fixture
def tracer():
    from repro_torch.obs.trace import TRACER

    TRACER.enabled = False
    TRACER.clear()
    yield TRACER
    TRACER.clear()


def test_graph_share_is_listed_as_a_program_span():
    bench = twin_bench(CELL)
    entry = {m["name"]: m for m in bench.benchmark["per_layer"]}["decode.graph_pct"]
    assert (entry["source"], entry["unit"], entry["better"]) == ("program_span", "%", "higher")
    assert entry["moves"] == "output_tokens_per_s" and CELL in entry["workloads"]
    assert bench.reader("decode.graph_pct").__name__ == "portbench_metric_decode_graph_pct"


@pytest.mark.parametrize("graph,want", [([1, 1, 1], 100.0), ([0, 0], 0.0),
                                        ([1, 0, 1, 1], 75.0), (None, None), ([], None)])
def test_graph_share_on_hand_built_spans(tracer, graph, want):
    """The share of ``serve.decode.enqueue`` spans marked ``graph`` 1;
    spans without the attribute (a program that has none) or no spans
    read as nothing."""
    from repro_torch.obs.trace import Span

    tracer.spans.extend(Span(i, "serve.tick", 0.0, 1.0) for i in range(2))
    for i, g in enumerate(graph if graph is not None else [None, None]):
        tracer.spans.append(Span(10 + i, "serve.decode.enqueue", float(i), i + 0.5,
                                 parent=0, attrs={} if g is None else {"graph": g}))
    if graph == []:
        tracer.spans.clear()
    assert twin_bench(CELL).reader("decode.graph_pct").read({}) == want


def test_graph_share_reads_zero_on_the_cpu_twin(tracer):
    """The CPU runs the eager step, so every traced decode step reads 0."""
    bench = twin_bench(CELL, seconds=2.0)
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_cell(bench)
    assert out["correct"], out["compared"]
    assert bench.reader("decode.graph_pct").read({}) == 0.0
