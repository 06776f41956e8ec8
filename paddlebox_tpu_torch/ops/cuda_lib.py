"""Build and load the port's hand-written CUDA kernels.

Each source under ``paddlebox_tpu_torch/csrc/`` is compiled by ``nvcc``
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into a shared
library with a plain C interface, and loaded with ``ctypes``.  No PyTorch
header is compiled, so a build takes seconds.  Libraries land in
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of their source and the shared headers beside it
(``csrc/*.h``), so an edited source is rebuilt and a stale library is
never loaded.

Nothing is built or loaded at import: the first CUDA launch builds, or
``build_all()`` builds every source at once, one ``nvcc`` process per
source, all started together.  A failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"sorted_spmm": "sorted_spmm.cu",
           "gather_pool": "gather_pool.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LAUNCH_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _lib_path(name: str) -> Path:
    # the source and every shared header it may include
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.h")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: List[str] = None) -> Dict[str, float]:
    """Compile every named source (default: all) that has no up-to-date
    library yet, in parallel.  Returns {name: seconds} for the sources
    compiled by this call; raises RuntimeError if any compile fails."""
    names = list(SOURCES) if names is None else names
    # the libraries' paths hash the sources: read them before the lock
    outs = {name: _lib_path(name) for name in names}
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in names:
            out = outs[name]
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        secs, errors = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {SOURCES[name]} "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        path = str(_lib_path(name))
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(path)
                _LIBS[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``: the wrappers count every kernel
    they launch, and the ranks of a thread-mode trainer fleet launch from
    several threads at once."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")
