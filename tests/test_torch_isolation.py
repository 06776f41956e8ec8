"""The PyTorch port imports neither JAX nor the JAX package.

Every module of ``paddlebox_tpu_torch`` (and the card scripts
``chip_smoke.py`` and ``kernel_ab.py``) is
imported in a fresh interpreter in which ``jax``, ``jaxlib`` and
``paddlebox_tpu`` are blocked: any import of them raises there.
"""

import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "paddlebox_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("ok", len(sys.argv) - 1)
"""


def _port_modules():
    import paddlebox_tpu_torch
    names = ["paddlebox_tpu_torch"]
    for m in pkgutil.walk_packages(paddlebox_tpu_torch.__path__,
                                   "paddlebox_tpu_torch."):
        names.append(m.name)
    return names


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "paddlebox_tpu_torch.trainer.trainer" in mods
    assert "paddlebox_tpu_torch.ops.sorted_spmm" in mods
    scripts = ["chip_smoke", "kernel_ab"]
    proc = subprocess.run([sys.executable, "-c", _PROBE, *mods, *scripts],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == f"ok {len(mods) + len(scripts)}"


@pytest.mark.parametrize("path", ["paddlebox_tpu_torch", "chip_smoke.py",
                                  "kernel_ab.py"])
def test_port_sources_name_no_jax_import(path):
    """A static check beside the probe: no source line imports jax or
    the JAX package (an import inside a function would escape the
    probe until it runs)."""
    full = os.path.join(REPO, path)
    files = ([full] if full.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(full)
              for f in fs if f.endswith(".py")])
    bad = []
    for fn in files:
        with open(fn) as fh:
            for i, line in enumerate(fh, 1):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1].split(".")[0]
                    if mod in ("jax", "jaxlib", "paddlebox_tpu", "optax",
                               "flax"):
                        bad.append(f"{fn}:{i}: {s}")
    assert not bad, bad
