"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program: by the source of every file,
and by ``sys.modules`` after a run of each cell's loop at toy size."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import FORBIDDEN, HERE, ROOT

PROGRAM = "r2d2dpg_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted([*(HERE / "reference").rglob("*.py"), *(HERE / "models").rglob("*.py")]):
        assert PROGRAM not in set(_imports(path)), path


def test_a_name_that_only_begins_with_jax_is_not_jax():
    from perfbench import harness

    sys.modules.setdefault("jaxlike_for_this_test", sys)
    try:
        assert "jaxlike_for_this_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["jaxlike_for_this_test"]


DRY_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench.tests import tiny
from perfbench import harness
kw = {{"serve": {{"rate_per_s": 400, "warmup_s": 0.1}},
      "learn_dp": {{"world": 2}}}}.get({kind!r}, {{}})
_, _, out = tiny.run(tiny.cell({kind!r}, tiny.config_file("pendulum_tiny"), **kw), seconds=0.1)
print(json.dumps({{"correct": out["correct"], "loaded": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("kind", ["learn", "train", "serve", "learn_dp"])
def test_a_dry_run_of_each_loop_loads_no_jax(kind):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", DRY_RUN.format(root=str(ROOT), kind=kind)],
                          capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert not set(out["loaded"]) & set(FORBIDDEN)
    assert PROGRAM in out["loaded"]
