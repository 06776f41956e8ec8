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


# the PS service tier: host modules, JAX-free in the reference too
PS_TIER = tuple(f"paddlebox_tpu_torch.{m}" for m in (
    "ps.wire", "ps.cluster", "ps.service", "ps.geo_table", "ps.ssd_table",
    "ps.reshard", "ps.server_main", "launch"))

# the trainer fleet's host modules: elastic membership, the fleet's
# collective over the PS verbs and the TCP shuffle — torch-free, as the
# PS tier is (a trainer process imports torch for its trainer only)
FLEET_HOST = tuple(f"paddlebox_tpu_torch.{m}" for m in (
    "elastic", "parallel.collective", "data.shuffle_transport"))

# the trainer fleet's torch modules and the launcher
FLEET = tuple(f"paddlebox_tpu_torch.{m}" for m in (
    "trainer.fleet_runner", "trainer.fleet_main", "launch", "fleet"))

# the serving tier and the observability modules it runs under: host
# modules too (a replica serves a frozen host table), and the xbox half
# of io.checkpoint with the native dump writer, which the PS server's
# dump_xbox verb and a replica's loader call
SERVING_TIER = tuple(f"paddlebox_tpu_torch.{m}" for m in (
    "ps.serving", "io.checkpoint", "native.dump_writer", "utils.timeline",
    "utils.doctor", "utils.obs_server", "serve"))


# the multi-shard mxu lowering: topology, ZeRO sharding and the sharded
# exchange (torch modules; the named-axis collectives live in the
# torch-free parallel.collective above)
SHARDED = tuple(f"paddlebox_tpu_torch.{m}" for m in (
    "parallel.topology", "parallel.sharding", "ps.sharded_embedding"))


# the last modules: graph-learning mode, the parallel layer library and
# the profiler (torch modules) ...
LAST_MODULES = tuple(f"paddlebox_tpu_torch.{m}" for m in (
    "graph", "graph.graph_table", "trainer.graph_trainer",
    "parallel.tp_layers", "parallel.moe", "parallel.pipeline",
    "parallel.ring_attention", "parallel.ulysses", "utils.profiler"))

# ... and the fleet executor, host threads over utils/channel (no torch)
RUNTIME = tuple(f"paddlebox_tpu_torch.{m}" for m in (
    "runtime", "runtime.fleet_executor"))


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
    assert set(PS_TIER) <= set(mods)
    assert set(SERVING_TIER) <= set(mods)
    assert set(FLEET_HOST) <= set(mods) and set(FLEET) <= set(mods)
    assert set(SHARDED) <= set(mods)
    assert set(LAST_MODULES) <= set(mods) and set(RUNTIME) <= set(mods)
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


def test_ps_tier_imports_without_torch_and_server_main_runs():
    """The PS tier alone, in a JAX-blocked interpreter: its modules load
    without importing torch (a shard process stays in the numpy/socket
    layer), and ``python -m paddlebox_tpu_torch.ps.server_main --help``
    runs."""
    probe = _PROBE + r"""
assert "torch" not in sys.modules, "the PS tier imported torch"
import runpy
sys.argv = ["server_main", "--help"]
try:
    runpy.run_module("paddlebox_tpu_torch.ps.server_main",
                     run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
"""
    mods = list(PS_TIER)
    proc = subprocess.run([sys.executable, "-c", probe, *mods], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"ok {len(mods)}")
    assert "--ckpt_root" in proc.stdout and "--membership" in proc.stdout


def test_serving_tier_imports_without_torch_and_serve_runs():
    """The serving tier alone, in a JAX-blocked interpreter: its modules
    load without importing torch, and ``python -m
    paddlebox_tpu_torch.serve --help`` runs."""
    probe = _PROBE + r"""
assert "torch" not in sys.modules, "the serving tier imported torch"
import runpy
sys.argv = ["serve", "--help"]
try:
    runpy.run_module("paddlebox_tpu_torch.serve", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
assert "torch" not in sys.modules, "serve imported torch"
"""
    mods = list(SERVING_TIER)
    proc = subprocess.run([sys.executable, "-c", probe, *mods], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"ok {len(mods)}")
    assert "--manifest" in proc.stdout and "--n_shards" in proc.stdout


def test_fleet_host_modules_import_without_torch_and_launch_runs():
    """The trainer fleet's host modules in a JAX-blocked interpreter:
    they load without importing torch, the fleet's torch modules load
    without JAX, and ``python -m paddlebox_tpu_torch.launch --help``
    (the launcher's whole argument surface, ``--serve*`` included) runs
    without torch."""
    probe = _PROBE + r"""
assert "torch" not in sys.modules, "a fleet host module imported torch"
import runpy
sys.argv = ["launch", "--help"]
try:
    runpy.run_module("paddlebox_tpu_torch.launch", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
assert "torch" not in sys.modules, "launch --help imported torch"
for mod in FLEET:
    importlib.import_module(mod)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
"""
    mods = list(FLEET_HOST)
    proc = subprocess.run(
        [sys.executable, "-c", f"FLEET = {list(FLEET)!r}\n" + probe, *mods],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"ok {len(mods)}")
    for arg in ("--nproc_per_node", "--elastic_dir", "--ps_servers",
                "--serve", "--serve_shards", "--serve_ckpt"):
        assert arg in proc.stdout, arg


def test_sharded_modules_import_without_jax():
    """The multi-shard lowering's modules, alone in a JAX-blocked
    interpreter: they load, import nothing of jax or paddlebox_tpu, and
    ``parallel`` hands out ``HybridTopology`` (loaded on first use, so
    the host collective stays torch-free)."""
    probe = _PROBE + r"""
from paddlebox_tpu_torch.parallel import HybridTopology
from paddlebox_tpu_torch.parallel.topology import HybridTopology as H
assert HybridTopology is H
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
"""
    proc = subprocess.run([sys.executable, "-c", probe, *SHARDED],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"ok {len(SHARDED)}")


@pytest.mark.parametrize("group", ["last_modules", "runtime"])
def test_last_modules_import_without_jax(group):
    """The graph mode, the parallel layer library and the profiler load
    in a JAX-blocked interpreter and ``parallel`` hands out their names;
    the fleet executor loads there without importing torch."""
    mods = list(LAST_MODULES if group == "last_modules" else RUNTIME)
    extra = (r"""
from paddlebox_tpu_torch import parallel
for name in parallel._LAZY:
    getattr(parallel, name)
""" if group == "last_modules" else r"""
assert "torch" not in sys.modules, "the fleet executor imported torch"
""")
    probe = _PROBE + extra + r"""
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
"""
    proc = subprocess.run([sys.executable, "-c", probe, *mods], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith(f"ok {len(mods)}")


CARD_TESTS = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "tests"))
                    if f.startswith("test_torch_") and f.endswith("_cuda.py"))


@pytest.mark.parametrize("module", CARD_TESTS)
def test_card_test_files_import_without_jax(module):
    """The card test files run under ``--noconftest`` where the card is,
    with no JAX: each loads in a JAX-blocked interpreter."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, "-c", _PROBE, module], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok 1")
