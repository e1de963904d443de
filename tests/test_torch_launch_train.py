"""The port's training CLI (``python -m repro_torch.launch.train``): the
counterpart of tests/test_launch_cli.py::test_train_cli_with_checkpointing
on ``--device cpu`` (about 15 s for both runs), and the raise without a card
when the CPU is not asked for.  The CLI runs with ``OMP_NUM_THREADS=1``:
a reduced model's ops are tiny, and beside the test runner's other
workers a pool of one thread per core oversubscribes the cores."""
import os
import subprocess
import sys

import pytest
import torch

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ENV = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}


def run_cli(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu"] + args,
        capture_output=True, text=True, timeout=timeout, env=ENV,
    )


def test_train_cli_with_checkpointing(tmp_path):
    proc = run_cli(["--arch", "qwen2-1.5b", "--steps", "12", "--seq-len", "32",
                    "--batch", "4", "--log-every", "6", "--ckpt-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "done:" in proc.stdout and "device=cpu" in proc.stdout
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("step_")) == ["step_12"]
    # resume: second invocation starts from the saved step
    proc2 = run_cli(["--arch", "qwen2-1.5b", "--steps", "14", "--seq-len", "32",
                     "--batch", "4", "--log-every", "2", "--ckpt-dir", str(tmp_path)])
    assert proc2.returncode == 0, proc2.stderr[-2000:]
    assert "step    14" in proc2.stdout
    assert "step     2" not in proc2.stdout  # did not restart from scratch


def test_train_cli_without_a_card_raises(monkeypatch):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", "qwen2-1.5b", "--steps", "1"])
