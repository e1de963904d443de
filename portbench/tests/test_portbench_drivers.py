"""Each driver end to end on the CPU, on a reduced twin, with its
reference; and the same runs with the timed path broken underneath, which
must come out not correct."""
import numpy as np
import pytest
import torch

from portbench_twin import one_thread, twin_bench  # noqa: F401  (fixture)
from portbench.run import run_cell

pytestmark = pytest.mark.usefixtures("one_thread")

CELLS = ["granite-moe-3b.long-prompt", "granite-moe-3b.chat"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu_twin(workload):
    bench = twin_bench(workload)
    out = run_cell(bench)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["compared"]["tokens_checked"]["value"] >= 8
    assert out["compared"]["logit_gap_mean"]["value"] < 1e-4      # float32 on both sides
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["metrics"]["output_tokens_per_s"]["value"] > 0
    if workload == "granite-moe-3b.chat":
        assert out["metrics"]["itl_ms.p95"]["value"] > 0
    # the names the benchmark lists for the cell, and no others
    assert set(out["metrics"]) == set(bench.metric_names()) | {"setup_s"}


def _break_decode(monkeypatch, how):
    """Wrap every engine's decode step so that it computes wrong."""
    from repro_torch.serve import engine as eng

    init = eng.ServeEngine.__init__

    def broken_init(self, *a, **kw):
        init(self, *a, **kw)
        step = self._decode

        def decode(params, cache, toks):
            if how == "state_unchanged":
                saved = {k: v.clone() for k, v in cache.items()}
                logits, new = step(params, cache, toks)
                for k, v in saved.items():
                    cache[k].copy_(v)
                return logits, new
            logits, new = step(params, cache, toks)
            logits = logits.clone()
            if how == "half_the_batch":
                logits[::2] = 0.0                       # every other slot left out
            elif how == "token_altered":                # the next id up wins
                rows = torch.arange(logits.shape[0])
                top = logits.argmax(-1)
                logits[rows, (top + 1) % logits.shape[1]] = logits.max(-1).values + 1.0
            return logits, new

        self._decode = decode

    monkeypatch.setattr(eng.ServeEngine, "__init__", broken_init)


@pytest.mark.parametrize("how", ["state_unchanged", "half_the_batch", "token_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, how):
    _break_decode(monkeypatch, how)
    out = run_cell(twin_bench(workload))
    assert not out["correct"], out["compared"]
    gap = out["compared"]["logit_gap_mean"]
    assert gap["value"] > gap["limit"]


def test_sample_holds_the_longest_and_is_seeded():
    from portbench_twin import twin_bench as _tb

    driver = _tb("granite-moe-3b.chat").driver

    class R:
        def __init__(self, i, s, m):
            self.request_id, self.prompt, self.generated = i, np.zeros(s), [0] * m

    reqs = [R(i, 10 + i, 5) for i in range(20)] + [R(99, 5, 200)]
    a = driver._sample(reqs, 1, 50, 4)
    assert a[0].request_id == 99 and len(a) == 1            # 200 tokens already
    b = driver._sample(reqs[:-1], 1, 50, 4)
    assert b[0].request_id == 19 and len(b) == 4
    assert [r.request_id for r in b] == [r.request_id for r in driver._sample(reqs[:-1], 1, 50, 4)]
