"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; everything that belongs to it is found by name:

    portbench/workloads/<cell>.json   its driver, engine, traffic and
                                      correctness rule
    <configs[i].file>                 its configuration (sizes, dtype)
    portbench/reference/<ref>.py      the configuration's plain reference
    portbench/counts/<ref>.py         the work of its steps, from its widths
    portbench/drivers/<driver>.py     the code that drives the program
    portbench/metrics/<metric>.py     one reader per metric; a name with
                                      no file of its own is read by the
                                      file of its longest dotted prefix
                                      (``device_idle_pct.<x>`` by
                                      ``device_idle_pct.py``)

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, read from a device trace of a slice of the window.  The
last line of standard output is one JSON object; the numbers compared for
``correct`` close it, and are also the last lines of standard error.

Exit codes: 0 a result was printed (correct or not); 2 no card, or fewer
than the cell needs; 3 the program or a file the cell names is missing;
4 the process holds JAX or the JAX package after the window.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def use_checkout(root: Path = ROOT) -> None:
    """Put the program and the benchmark on ``sys.path``, and every build
    and kernel cache in the checkout at a fixed path.  Call before torch is
    imported."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(root / ".portbench_cache" / sub)
    for p in (str(root), str(root / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def process_age_s() -> float:
    """Seconds since this process started (from /proc, to 10 ms), else
    since this module was first imported."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """What a driver gets: the cell, its configuration and reference, the
    run's arguments and device, and ``setup_done`` to mark the first timed
    operation."""

    def __init__(self, root: Path, workload: str, seed: int, seconds: float, trace: bool,
                 device):
        import torch

        self.root = Path(root)
        self.benchmark = json.loads((self.root / "BENCHMARK.json").read_text())
        entries = {w["name"]: w for w in self.benchmark["workloads"]}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        here = self.root / "portbench"
        self.cell = json.loads((here / "workloads" / f"{workload}.json").read_text())
        conf = {c["name"]: c for c in self.benchmark["configs"]}[entries[workload]["config"]]
        self.config = json.loads((self.root / conf["file"]).read_text())
        ref = self.config["reference"]
        self.reference = load_module(here / "reference" / f"{ref}.py", f"portbench_ref_{ref}")
        counts = here / "counts" / f"{ref}.py"
        self.counts = load_module(counts, f"portbench_counts_{ref}") if counts.exists() else None
        self.driver = load_module(here / "drivers" / f"{self.cell['driver']}.py",
                                  f"portbench_driver_{self.cell['driver']}")
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.device_name = torch.cuda.get_device_name(0) if self.device.type == "cuda" else None
        self.setup_s = None
        self.control = None        # a reference precision: control.py's readings

    def setup_done(self) -> None:
        """Set-up ends here: process start to the first timed operation."""
        self.setup_s = process_age_s()

    def metric_names(self):
        kind = "per_layer" if self.trace else "end_to_end"
        names = [m["name"] for m in self.benchmark[kind]
                 if self.name in m.get("workloads", [self.name])]
        return [n for n in names if n != "setup_s"]

    def reader(self, name: str):
        """The reader of metric ``name``: ``metrics/<name>.py``, else the
        file of its longest dotted prefix."""
        parts = name.split(".")
        for n in range(len(parts), 0, -1):
            path = self.root / "portbench" / "metrics" / (".".join(parts[:n]) + ".py")
            if path.exists():
                return load_module(path, "portbench_metric_" + "_".join(parts[:n]))
        raise FileNotFoundError(f"no reader for metric {name!r}")

    def read_metrics(self, record: dict) -> dict:
        units = {m["name"]: m["unit"] for k in ("end_to_end", "per_layer")
                 for m in self.benchmark[k]}
        out = {}
        for name in self.metric_names():
            value = self.reader(name).read(record)
            if value is not None:
                out[name] = {"value": float(value), "unit": units[name]}
        if not self.trace:
            out["setup_s"] = {"value": float(self.setup_s), "unit": units["setup_s"]}
        return out


def run_cell(bench: Bench) -> dict:
    """Drive the cell once.  Returns the result line without ``device``,
    and under ``"run"`` what ``device`` is made of: the traced slice's
    reduction (or None) and the peak of device memory."""
    res = bench.driver.run(bench)
    record = res["record"]
    record["config"] = bench.config
    record["counts"] = bench.counts
    record["device_name"] = bench.device_name
    out = {"correct": bool(res["correct"]), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": bench.read_metrics(record)}
    sl = record.get("slice")
    if bench.trace and sl is not None:
        out["breakdown"] = {"device_ops": sl["device_ops"], "idle_gaps": sl["idle_gaps"]}
    out["compared"] = res["compared"]
    out["run"] = {"slice": sl, "memory_peak_bytes": int(res.get("memory_peak_bytes", 0))}
    return out


def _power_limit_w():
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(got.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules(names=None) -> list:
    """Top-level names of ``names`` (the process's modules by default) that
    are JAX's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    use_checkout()
    try:
        import torch
        import repro_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"portbench: cannot import the program: {e}", file=sys.stderr)
        return 3
    try:
        chips = {w["name"]: w for w in json.loads((ROOT / "BENCHMARK.json").read_text())
                 ["workloads"]}[args.workload]["chips"]
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: no such workload: {e}", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        bench = Bench(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    except (OSError, KeyError, FileNotFoundError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    out = run_cell(bench)
    held = forbidden_modules()
    if held:
        print(f"portbench: the process holds {held} after the window", file=sys.stderr)
        return 4
    run = out.pop("run")
    sl = run["slice"]
    device = {"platform": "gpu", "kind": bench.device_name, "count": chips,
              "memory_peak_bytes": run["memory_peak_bytes"], "power_limit_w": _power_limit_w()}
    if bench.trace and sl is not None:
        device.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
    compared = out.pop("compared")
    line = {**out, "device": device, "compared": compared}
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
