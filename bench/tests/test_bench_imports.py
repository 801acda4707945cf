"""Nothing under ``bench/`` imports JAX or the JAX package ``repro`` (top
level names compared whole: ``repro_torch`` is the port), and nothing
under ``bench/reference/`` imports the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    found = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize(
    "path", [p for p in FILES if "reference" in p.relative_to(BENCH).parts],
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(_imports(path))


def test_the_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nfrom jax import numpy\n"
                   "import repro_torch\n")
    assert set(_imports(bad)) == {"repro", "jax", "repro_torch"}
