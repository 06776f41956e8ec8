"""Build the port's native host library (g++ → .so, loaded via ctypes).

Port of ``paddlebox_tpu/native/build.py``: the slot parser and the key
hash (``slot_parser.cc``, ``hash_shard.cc``) compiled into one shared
library on first use.  Failures degrade to the pure-Python fallbacks
(``data_feed.SlotParser``, ``PassKeyMapper``'s binary search).  Three things differ from the JAX
package's build:

* the library lands in ``build/native/`` at the repository root (listed
  in ``.gitignore``), never in the package directory;
* its file name carries a hash of the sources, the compiler flags, the
  compiler's version and the host CPU (the ``model name`` and ``flags``
  lines of ``/proc/cpuinfo``).  The build uses ``-march=native``, so a
  library built on one machine and copied to another with a different
  CPU is never loaded there: that machine builds its own;
* g++ writes a temporary file that ``os.replace`` moves into place, so
  processes that build at once (test workers, say) never load a
  half-written library.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_SOURCES = ("slot_parser.cc", "hash_shard.cc")
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread"]
_LOCK = threading.Lock()
_ID: Optional[bytes] = None
_FAILED = False     # a failed build is not retried in this process


def _toolchain_and_host() -> bytes:
    """The compiler's version line and the CPU's model name and flags —
    what decides whether a ``-march=native`` library runs here."""
    global _ID
    if _ID is None:
        try:
            cxx = subprocess.run([CXX, "--version"], capture_output=True,
                                 text=True, timeout=30).stdout
            cxx = cxx.splitlines()[0] if cxx else ""
        except (OSError, subprocess.TimeoutExpired):
            cxx = ""
        cpu = []
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    key = line.split(":", 1)[0].strip()
                    if key in ("model name", "flags") and \
                            not any(c.startswith(key) for c in cpu):
                        cpu.append(line.strip())
        except OSError:
            cpu.append(platform.processor() or platform.machine())
        _ID = "\n".join([cxx] + cpu).encode()
    return _ID


def lib_path() -> str:
    """Where the library of these sources, flags, compiler and CPU
    lives (it may not be built yet)."""
    h = hashlib.sha1()
    for name in _SOURCES:
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_toolchain_and_host())
    return str(BUILD_DIR / f"libpbox_native-{h.hexdigest()[:12]}.so")


def ensure_built(quiet: bool = True) -> bool:
    """Compile if the library is missing.  Returns True when the .so is
    usable, False (after printing g++'s errors unless ``quiet``) when it
    cannot be built."""
    global _FAILED
    with _LOCK:
        out = Path(lib_path())
        if out.exists():
            return True
        if _FAILED:
            return False
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [CXX, *CXX_FLAGS, "-o", str(tmp),
               *(str(_DIR / s) for s in _SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=240)
        except (OSError, subprocess.TimeoutExpired) as e:
            if not quiet:
                print(f"native build failed: {e}")
            _FAILED = True
            return False
        if proc.returncode != 0:
            if not quiet:
                print("native build failed:\n" + proc.stderr)
            tmp.unlink(missing_ok=True)
            _FAILED = True
            return False
        os.replace(tmp, out)
        return True
