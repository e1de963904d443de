"""A configuration, a cell and a per-layer metric are added as new files
and ``BENCHMARK.json`` entries, and the harness finds them by name without
any existing file of the benchmark being edited."""
import hashlib
import json
import shutil

import pytest

import portbench_twin
from portbench_twin import one_thread, twin_bench  # noqa: F401  (fixture)
from portbench.run import run_cell

pytestmark = pytest.mark.usefixtures("one_thread")

METRIC = '''"""Median time to first token (a later metric)."""
from portbench.yardstick.stats import percentile


def read(rec):
    v = percentile(rec.get("ttft_s", []), 50)
    return None if v is None else 1e3 * v
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()}


def test_new_config_cell_and_metric_are_found_by_name(tmp_path):
    src = portbench_twin.ROOT
    shutil.copytree(src / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(src / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)

    here = tmp_path / "portbench"
    cfg = json.loads((here / "configs" / "granite-moe-3b-a800m.json").read_text())
    cfg["name"] = "granite-twin"
    (here / "configs" / "granite-twin.json").write_text(json.dumps(cfg))
    cell = json.loads((here / "workloads" / "granite-moe-3b.long-prompt.json").read_text())
    cell["traffic"].update(portbench_twin.TWIN_TRAFFIC["granite-moe-3b.long-prompt"],
                           output={"dist": "uniform", "min": 3, "max": 5})
    (here / "workloads" / "twin.short.json").write_text(json.dumps(cell))
    (here / "metrics" / "ttft_ms.p50.py").write_text(METRIC)
    bm = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bm["configs"].append({"name": "granite-twin", "source": "test", "reduced": [],
                          "file": "portbench/configs/granite-twin.json", "why": "test"})
    bm["workloads"].append({"name": "twin.short", "config": "granite-twin",
                            "traffic": "short", "chips": 1, "why": "test"})
    bm["per_layer"].append({"name": "ttft_ms.p50", "unit": "ms", "better": "lower",
                            "source": "host_clock", "layer": "prefill model step",
                            "moves": "itl_ms.p95", "workloads": ["twin.short"]})
    for m in bm["end_to_end"]:
        if m["name"] == "itl_ms.p95":
            m["workloads"].append("twin.short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))

    bench = twin_bench("twin.short", root=tmp_path)
    assert bench.config["name"] == "granite-twin"
    assert bench.cell["traffic"]["output"]["max"] == 5
    out = run_cell(bench)
    assert out["correct"], out["compared"]
    assert {"itl_ms.p95", "setup_s"} <= set(out["metrics"])
    bench.trace = True                     # the per-layer metrics of the same record
    record = {"ttft_s": [0.1, 0.2, 0.3], "config": bench.config, "device_name": None}
    assert bench.read_metrics(record) == {"ttft_ms.p50": {"value": 200.0, "unit": "ms"}}
    # a name with no file of its own is read by its dotted prefix's file
    assert bench.reader("device_idle_pct.a_later_cell").read(
        {"slice": {"busy_s": 1.0, "window_s": 4.0}}) == 75.0
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
