"""The control of the serving cells' comparison, at a size a test run can
hold, through the cells' own check (``drivers/serve.py::_check``): the
reference in the precision below the configuration's (float8 matrix
products) in the program's place must come out not correct under each
serving cell's rule, where the program's own tokens (here the float32
reference's greedy continuations) come out correct."""
import json

import numpy as np
import pytest
import torch

from portbench_twin import ROOT, TWIN, one_thread, twin_bench  # noqa: F401  (fixture)
from portbench.reference import granite_moe as ref
from portbench.yardstick.weights import draw

pytestmark = pytest.mark.usefixtures("one_thread")

# deeper and wider than the driver tests' twin, so that float8's error
# accumulates over layers as it does at full size
CONTROL_TWIN = dict(TWIN, n_layers=8, d_model=128, d_ff=64, vocab=2048)
CELLS = ["granite-moe-3b.long-prompt", "granite-moe-3b.chat"]


class _Served:
    def __init__(self, i, prompt, generated):
        self.request_id, self.prompt, self.generated, self.done = i, prompt, generated, True


def _greedy(weights, cfg, prompt, n):
    toks = torch.as_tensor(prompt)
    for _ in range(n):
        nxt = ref.logits(weights, cfg, toks, len(toks) - 1).argmax(-1)
        toks = torch.cat([toks, nxt])
    return toks[len(prompt):].tolist()


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_float8_in_the_programs_place_is_not_correct(seed):
    cfg = dict(json.loads((ROOT / "portbench/configs/granite-moe-3b-a800m.json").read_text()),
               **CONTROL_TWIN)
    weights = draw(ref.param_spec(cfg), seed, "cpu", torch.float32)
    rng = np.random.default_rng(seed)
    served = [_Served(i, p, _greedy(weights, cfg, p, 40))
              for i, p in enumerate(rng.integers(0, cfg["vocab"], (3, 48)))]
    for cell in CELLS:
        driver = twin_bench(cell).driver
        rule = dict(json.loads((ROOT / f"portbench/workloads/{cell}.json").read_text())["correct"],
                    min_tokens_checked=100)
        out = driver._check(served, weights, cfg, rule, ref, seed, torch.device("cpu"), "fp8")
        assert out["correct"], (cell, out["compared"])
        assert out["compared"]["tokens_checked"]["value"] == 120
        assert not out["control"]["correct"], (cell, out["control"]["compared"])
        gap = out["control"]["compared"]["logit_gap_mean"]
        assert gap["value"] > gap["limit"]
