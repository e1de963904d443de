"""Shared by the benchmark's CPU tests: a reduced twin of the benchmark's
granite-moe serving cells (every width cut, the same blocks, 8 experts of
which 2 are chosen, dropless), run through the harness on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402
import torch  # noqa: E402

from portbench.run import Bench  # noqa: E402

TWIN = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab=500,
            moe_n_experts=8, moe_top_k=2, moe_n_experts_padded=8, moe_capacity_factor=4.0,
            dtype="float32")
TWIN_ENGINE = {"slots": 4, "max_len": 256}
TWIN_TRAFFIC = {
    "granite-moe-3b.long-prompt": dict(rate_per_s=8.0,
                                       prompt={"dist": "lognormal", "median": 64, "sigma": 0.5,
                                               "min": 16, "max": 128},
                                       output={"dist": "uniform", "min": 2, "max": 8}),
    "granite-moe-3b.chat": dict(clients=4, pool=12,
                                prompt={"dist": "lognormal", "median": 32, "sigma": 0.6,
                                        "min": 8, "max": 64},
                                output={"dist": "lognormal", "median": 24, "sigma": 0.5,
                                        "min": 8, "max": 48}),
}


@pytest.fixture
def one_thread():
    """Run the twin on one CPU thread: the suite runs beside other workers,
    and an engine tick's many small operators crawl when every process
    spins a full thread pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def twin_bench(workload: str, seed: int = 2 ** 31 + 17, seconds: float = 4.0,
               root: Path = ROOT) -> Bench:
    """The cell ``workload`` on the CPU at the twin's size: the same driver,
    traffic shape, reference and correctness rule, fewer and smaller
    layers, a shorter window."""
    bench = Bench(root, workload, seed, seconds, False, "cpu")
    bench.config.update(TWIN)
    bench.cell["engine"] = dict(TWIN_ENGINE)
    bench.cell["traffic"].update(TWIN_TRAFFIC.get(workload, {}))
    bench.cell["correct"].update(min_tokens_checked=8)
    return bench
