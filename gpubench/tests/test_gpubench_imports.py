"""No module of the benchmark imports JAX, Flax or the JAX package (whose
name the port's begins with: top-level names are compared whole), and the
reference imports nothing of the port."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "romp_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_or_jax_package(path):
    assert not FORBIDDEN & set(top_level_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "romp_tpu_torch" not in set(top_level_imports(path))


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import romp_tpu_torch.serve\nfrom romp_tpu.ops import x\n")
    assert list(top_level_imports(f)) == ["romp_tpu_torch", "romp_tpu"]
