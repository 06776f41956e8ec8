"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

HERE = Path(harness.HERE)
PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/portbench/tests")
import portbench.run, portbench.harness, portbench.calibrate
from portbench.reference import compare, sparse, steps
from portbench.reference.models import widedeep
from tiny import run_tiny
line, code = run_tiny("widedeep-criteo")
assert code == 0, code
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                               "paddlebox_tpu"))))
"""


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE, str(HERE.parent)],
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_neither_jax_nor_the_jax_package():
    for f in HERE.rglob("*.py"):
        tops = set(_top_imports(f))
        assert not tops & {"jax", "jaxlib", "flax", "paddlebox_tpu"}, f


def test_reference_imports_nothing_of_the_program():
    for f in (HERE / "reference").rglob("*.py"):
        assert "paddlebox_tpu_torch" not in set(_top_imports(f)), f


def test_harness_refuses_forbidden_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]
