"""No run loads JAX, Flax or the JAX package, and the reference imports
nothing of the program. Top-level names are compared whole: the port's own
name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import bench_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "marius_tpu"}

RUN = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {here!r})
import bench_tiny
ctx = bench_tiny.run_tiny({workload!r}, trace=True)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_no_jax():
    for workload in bench_tiny.SIZES:
        code = RUN.format(root=str(bench_tiny.ROOT),
                          here=str(bench_tiny.ROOT / "benchmark" / "tests"), workload=workload)
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=600, cwd=bench_tiny.ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
        assert "marius_tpu_torch" in loaded
        assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = bench_tiny.ROOT / "benchmark" / "reference"
    for path in sorted(ref.glob("*.py")):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"marius_tpu_torch"}), (path.name, names)


def test_the_harness_names_the_forbidden_modules():
    sys.path.insert(0, str(bench_tiny.ROOT / "benchmark"))
    try:
        import run
    finally:
        sys.path.pop(0)
    assert set(run.FORBIDDEN) == FORBIDDEN
    sys.modules.setdefault("jaxlib_lookalike", sys)
    assert "jaxlib_lookalike" not in run.forbidden_modules()
