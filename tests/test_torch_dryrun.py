"""The port's dry run (``launch.dryrun``, ``launch.roofline``) on the CPU.

  * a full-size cell (zamba2-1.2b x decode_32k, the reference CLI test's
    cell) counted on CPU fakes gives ``status: ok`` with every key of the
    JAX package's record (``xla_cost_analysis`` aside, ``device`` added);
  * every skip record equals the one the JAX package's ``run_cell`` builds
    from ``cell_is_supported`` (taken from there: importing
    ``repro.launch.dryrun`` would set XLA_FLAGS for the whole process);
  * the CLI prints ``[OK]`` and ``bottleneck=`` in a subprocess;
  * GreenPlacement fed with the port's records decides as the JAX package's
    GreenPlacement does with the same records, with no tolerance (the
    ``x64`` fixture of tests/test_torch_planner.py);
  * the roofline's layout is the reference's, with the H100's constants.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.launch import green_placement as jgp
from repro.launch import hlo_analysis
from repro.models.config import SHAPES as JAX_SHAPES
from repro.models.config import cell_is_supported as jax_supported
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import green_placement as tgp
from repro_torch.models.config import SHAPES
from repro_torch.obs import Tracer

from test_torch_planner import to_port, x64  # noqa: F401  (autouse fixture)

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
RECORD_KEYS = {"arch", "shape", "multi_pod", "optimized", "status", "device",
               "compile_s", "memory", "collectives", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_bytes_per_device"}
_RECORDS = {}


def record(arch, shape):
    """The port's record of a cell on CPU fakes, counted once a process."""
    if (arch, shape) not in _RECORDS:
        _RECORDS[arch, shape] = dryrun.run_cell(arch, shape, device="cpu")
    return _RECORDS[arch, shape]


def test_full_size_cell_gives_every_key():
    tracer = Tracer()
    rec = dryrun.run_cell("zamba2-1.2b", "decode_32k", device="cpu", tracer=tracer)
    assert rec["status"] == "ok" and set(rec) == RECORD_KEYS
    assert rec["multi_pod"] is False and rec["device"] == "cpu"
    mem = rec["memory"]
    assert set(mem) == MEMORY_KEYS
    assert mem["peak_bytes_per_device"] == mem["argument_bytes"] + \
        mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
    # the cache is updated in place: every lane but ``pos`` is an alias
    assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]
    assert rec["collectives"] == {"counts": {}, "bytes_by_kind": {}}
    r = rec["roofline"]
    assert set(r) == set(hlo_analysis.Roofline(1, 1, 0, 1, 1).to_dict())
    assert r["chips"] == 1 and r["collective_s"] == 0.0
    assert r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0
    assert r["bottleneck"] == "memory"
    assert r["memory_s"] == r["hbm_bytes_per_device"] / roofline.HBM_BW
    assert [s.name for s in tracer.spans] == \
        ["dryrun.plan", "dryrun.count", "dryrun.analyze", "dryrun.cell"]
    _RECORDS["zamba2-1.2b", "decode_32k"] = rec


@pytest.mark.parametrize("arch,shape", [(a, s) for a in sorted(ARCHS) for s in SHAPES
                                        if not jax_supported(JAX_ARCHS[a], JAX_SHAPES[s])[0]])
def test_skip_records_equal_the_reference(arch, shape):
    _, why = jax_supported(JAX_ARCHS[arch], JAX_SHAPES[shape])
    ref = {"arch": arch, "shape": shape, "multi_pod": False,
           "status": "skipped", "reason": why}
    assert dryrun.run_cell(arch, shape, device="cpu") == ref


def test_dryrun_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_cell("zamba2-1.2b", "decode_32k")


def test_dryrun_cli_single_cell(tmp_path):
    out, trace = tmp_path / "rec.jsonl", tmp_path / "trace.jsonl"
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "zamba2-1.2b",
         "--shape", "decode_32k", "--device", "cpu", "--out", str(out),
         "--trace-out", str(trace)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[OK]" in proc.stdout and "bottleneck=" in proc.stdout
    assert "in 80 GB" in proc.stdout
    rec = json.loads(out.read_text())
    assert rec["status"] == "ok" and set(rec) == RECORD_KEYS
    names = {json.loads(line)["name"] for line in trace.read_text().splitlines()}
    assert names == {"dryrun.cell", "dryrun.plan", "dryrun.count", "dryrun.analyze"}


def test_roofline_constants_and_layout():
    r = roofline.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=0,
                          model_flops=989e12, chips=1)
    assert r.compute_s == 1.0 and r.memory_s == 1.0 and r.collective_s == 0.0
    assert r.roofline_fraction == 1.0 and r.useful_flops_ratio == 1.0
    f32 = roofline.Roofline(67e12, 0.0, 0.0, 0.0, 1, compute_dtype="float32")
    assert f32.compute_s == 1.0 and f32.bottleneck == "compute"
    ref = hlo_analysis.Roofline(flops=5.0, hbm_bytes=7.0, coll_bytes=0.0,
                                model_flops=3.0, chips=1)
    assert list(r.to_dict()) == list(ref.to_dict())


# -- GreenPlacement fed with the port's records ----------------------------------

# (arch, shape, steps per hour): the jobs, 6 on 3 pods of 4
JOBS = (("qwen2-1.5b", "decode_32k", 3.6e6), ("zamba2-1.2b", "decode_32k", 3.6e6),
        ("zamba2-1.2b", "long_500k", 3.6e5), ("falcon-mamba-7b", "decode_32k", 3.6e6),
        ("falcon-mamba-7b", "long_500k", 3.6e5), ("qwen2-1.5b", "prefill_32k", 900.0))


def _roofline_table(records):
    """examples/green_deployment.py's roofline_lookup, over records."""
    table = {}
    for r in records:
        if r.get("status") == "ok" and not r["multi_pod"]:
            f = r["roofline"]
            table[(r["arch"], r["shape"])] = {
                "compute_s": f["compute_s"], "memory_s": f["memory_s"],
                "collective_s": f["collective_s"]}
    return table


def _placement_inputs(m, table):
    jobs = [m.JobSpec(f"{a}-{s}", a, s,
                      {"perf": table[(a, s)],
                       "eco": {k: v * 0.55 for k, v in table[(a, s)].items()}},
                      flavours_order=("perf", "eco"), steps_per_h=n)
            for a, s, n in JOBS]
    pods = [m.PodSpec("clean", "france", carbon=16.0, cost_per_chip_hour=1.3),
            m.PodSpec("mid", "finland", carbon=120.0, cost_per_chip_hour=1.1),
            m.PodSpec("dirty", "texas", carbon=410.0, cost_per_chip_hour=0.8)]
    traffic = [m.TrafficSpec("qwen2-1.5b-prefill_32k", "qwen2-1.5b-decode_32k",
                             gb_per_h=7200.0)]
    return jobs, pods, traffic


def test_green_placement_from_port_records_matches_jax():
    table = _roofline_table(record(a, s) for a, s, _ in JOBS)
    assert len(table) == len(JOBS)
    jplan, jout, jstats = jgp.GreenPlacement().place(*_placement_inputs(jgp, table))
    tplan, tout, tstats = tgp.GreenPlacement(device="cpu").place(
        *_placement_inputs(tgp, table))
    assert tplan == to_port(jplan)
    assert list(tout.constraints) == to_port(list(jout.constraints))
    assert tstats == jstats
    assert tplan.feasible and len(tplan.placements) == len(JOBS)
