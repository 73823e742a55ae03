"""What the benchmark loads: no module under benchmark/ imports JAX or the
JAX package (top-level names compared whole: the port's visfs_tpu_torch
shares visfs_tpu's prefix), and the plain reference loads nothing of the
port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _imported(path) & set(run.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_modules_import_nothing_of_the_port():
    for name in ("reference.py", "scene.py", "check.py", "roofline.py"):
        assert "visfs_tpu_torch" not in _imported(BENCH / name), name


def test_loading_the_reference_loads_no_port_and_no_jax():
    code = ("import sys; import benchmark.check, benchmark.reference, "
            "benchmark.scene; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    loaded = set(eval(out.stdout))  # a list of module names printed above
    assert not loaded & {"visfs_tpu_torch", *run.FORBIDDEN}


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["visfs_tpu_torch.slam.fleet", "numpy",
                                  "jax_free", "flaxen"]) == []
    assert run.forbidden_modules(["visfs_tpu.ops.lk", "jaxlib.xla_client",
                                  "jax", "torch"]) == ["jax", "jaxlib",
                                                       "visfs_tpu"]
