"""Import guard for the port: ``repro_torch`` imports neither jax nor the JAX
package, and its entry points do not run on the CPU unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_port_file_imports_no_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.core.pipeline, repro_torch.core.scheduler, "
            "repro_torch.learn, repro_torch.obs, repro_torch.configs.synth, "
            "repro_torch.continuum, repro_torch.faults, repro_torch.fleet, "
            "repro_torch.launch.green_placement, repro_torch.models.moe; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_engine_without_a_card_raises(monkeypatch):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.testing import reduced
    from repro_torch.serve import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(reduced(ARCHS["qwen2-1.5b"]), {}, slots=1, max_len=8)


def test_serve_cli_without_a_card_raises(monkeypatch):
    from repro_torch.launch.serve import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "qwen2-1.5b"])


def test_default_continuum_runtime_without_a_card_raises(monkeypatch):
    from repro_torch.continuum import (
        REGION_PRESETS, CarbonTrace, ContinuumRuntime, WorkloadTrace)
    from repro_torch.core.types import (
        Application, Flavour, FlavourRequirements, Infrastructure, Node,
        NodeCapabilities, Service)

    app = Application("t", (Service("svc", flavours=(
        Flavour("f", FlavourRequirements(cpu=1.0)),)),))
    infra = Infrastructure("t", (Node(
        "n", region="wind-north", capabilities=NodeCapabilities(cpu=4.0)),))
    runtime = ContinuumRuntime(app, infra,
                               CarbonTrace(REGION_PRESETS, hours=60),
                               WorkloadTrace(app))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.run(24, 1)
