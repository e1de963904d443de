"""Nothing the benchmark runs imports JAX or the JAX package, and its
references import nothing of the program: module names are compared by
their whole top-level name, so ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

import pytest

import portbench_twin  # noqa: F401  (puts the checkout on sys.path)
from portbench import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch", "portbench"})


@pytest.mark.parametrize("names, held", [
    (["repro_torch", "repro_torch.serve.engine", "portbench.run", "reprox", "jaxtyping"], []),
    (["repro_torch", "repro.core.types"], ["repro"]),
    (["jax.numpy", "flax.linen", "jaxlib"], ["flax", "jax", "jaxlib"]),
])
def test_top_level_names_compared_whole(names, held):
    assert run.forbidden_modules(names) == held


def test_scan_sees_through_aliases_and_from_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os, jax.numpy as jnp\nfrom repro.core import x\n"
                   "from repro_torch import y\nfrom . import z\n")
    assert top_level_imports(src) == {"os", "jax", "repro", "repro_torch"}
