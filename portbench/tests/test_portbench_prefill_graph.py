"""``prefill.graph_pct``, the share of the traced slice's admissions whose
prefill replayed one of the program's captured CUDA graphs: its entry and
reader, hand-built span lists, and the CPU twin, where every prefill runs
eagerly."""
import pytest
from torch.profiler import ProfilerActivity, profile

from portbench_twin import one_thread, twin_bench  # noqa: F401  (fixture)
from portbench.run import run_cell

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "prefill.graph_pct"
CELLS = ["granite-moe-3b.long-prompt", "granite-moe-3b.chat"]


@pytest.fixture
def tracer():
    from repro_torch.obs.trace import TRACER

    TRACER.enabled = False
    TRACER.clear()
    yield TRACER
    TRACER.clear()


@pytest.mark.parametrize("cell", CELLS)
def test_prefill_graph_share_is_listed_as_a_program_span(cell):
    bench = twin_bench(cell)
    entry = {m["name"]: m for m in bench.benchmark["per_layer"]}[NAME]
    assert (entry["source"], entry["unit"], entry["better"]) == ("program_span", "%", "higher")
    assert entry["layer"] == "prefill model step" and entry["moves"] == "output_tokens_per_s"
    assert entry["workloads"] == CELLS
    bench.trace = True                      # the traced run's per-layer metrics
    assert NAME in bench.metric_names()
    assert bench.reader(NAME).__name__ == "portbench_metric_prefill_graph_pct"


def test_prefill_graph_share_is_not_listed_in_long_doc():
    bench = twin_bench("granite-4h-small.long-doc")
    bench.trace = True
    assert NAME not in bench.metric_names()


@pytest.mark.parametrize("graph,want", [([1, 1, 1], 100.0), ([0, 0], 0.0),
                                        ([1, 0, 1, 0], 50.0), ([0, 1, 1, 1], 75.0),
                                        (None, None), ([], None)])
def test_prefill_graph_share_on_hand_built_spans(tracer, graph, want):
    """The share of ``serve.prefill.enqueue`` spans marked ``graph`` 1;
    spans without the attribute (a program that has none, as the parent's)
    or no spans read as nothing, and decode spans are not counted."""
    from repro_torch.obs.trace import Span

    tracer.spans.extend(Span(i, "serve.admit", 0.0, 1.0) for i in range(2))
    tracer.spans.append(Span(5, "serve.decode.enqueue", 0.0, 0.5, attrs={"graph": 1}))
    for i, g in enumerate(graph if graph is not None else [None, None]):
        tracer.spans.append(Span(10 + i, "serve.prefill.enqueue", float(i), i + 0.5,
                                 parent=i % 2, attrs={} if g is None else {"graph": g}))
    if graph == []:
        tracer.spans.clear()
    assert twin_bench(CELLS[0]).reader(NAME).read({}) == want


@pytest.mark.parametrize("cell", CELLS)
def test_prefill_graph_share_reads_zero_on_the_cpu_twin(tracer, cell):
    """The CPU prefills eagerly, so every traced admission reads 0."""
    bench = twin_bench(cell, seconds=2.0)
    with profile(activities=[ProfilerActivity.CPU]):
        out = run_cell(bench)
    assert out["correct"], out["compared"]
    assert bench.reader(NAME).read({}) == 0.0
