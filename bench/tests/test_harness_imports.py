"""No module under bench/ imports JAX, the JAX package or the old
benchmarks, by top-level name compared whole (``repro_torch`` is not
``repro``); the plain reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
NOT_IN_REFERENCE = NEVER | {"repro_torch"}


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_top_level_import(path):
    found = top_level_imports(path)
    never = NOT_IN_REFERENCE if "reference" in path.relative_to(BENCH).parts else NEVER
    assert not found & never, f"{path} imports {found & never}"


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.core\nfrom repro_torch import x\nimport reprox\n")
    assert top_level_imports(f) == {"repro_torch", "reprox"}
    f.write_text("from repro.core import y\nimport jax.numpy as jnp\n")
    assert top_level_imports(f) & NEVER == {"repro", "jax"}


def test_loading_the_harness_loads_none_of_them():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "import bench.lib.harness, bench.control, bench.reference.rew\n"
            "import repro_torch, repro_torch.core.engine\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(NEVER)!r})\n"
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
