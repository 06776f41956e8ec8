"""Global flag registry of the PyTorch port.

Same surface as the JAX package's ``flags`` module (plain Python values
with defaults, overridable by ``FLAGS_<name>`` environment variables at
first read and by :func:`set_flags`), but a registry of its own: the two
packages never share flag state in one process.  Only the flags this
port reads are defined here; utility modules define theirs at import.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

_LOCK = threading.Lock()
_DEFS: Dict[str, Any] = {}
_VALUES: Dict[str, Any] = {}


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    with _LOCK:
        if name in _DEFS:
            return
        _DEFS[name] = (default, help_str)
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            _VALUES[name] = _coerce(env, default)
        else:
            _VALUES[name] = default


def _coerce(text: str, default: Any) -> Any:
    if isinstance(default, bool):
        return text.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(text)
    if isinstance(default, float):
        return float(text)
    return text


def get_flags(name: str) -> Any:
    with _LOCK:
        if name not in _VALUES:
            raise KeyError(f"undefined flag: {name}")
        return _VALUES[name]


def set_flags(flags: Dict[str, Any]) -> None:
    with _LOCK:
        for k, v in flags.items():
            if k not in _DEFS:
                raise KeyError(f"undefined flag: {k}")
            _VALUES[k] = v


def all_flags() -> Dict[str, Any]:
    with _LOCK:
        return dict(_VALUES)


define_flag("check_nan_inf", False,
            "per-batch NaN/Inf check of the loss (boxps_worker.cc:1326)")
define_flag("auc_runner_mode", False,
            "enable AucRunner slot-replacement eval (flags.cc:972; "
            "metrics/auc_runner.py)")
define_flag("sparse_step_path", "auto",
            "sparse step lowering: auto | mxu | fast | ragged | reference.  "
            "It overrides an 'auto' construction only; with one device "
            "'auto' resolves to mxu (reference with fast_path=False)")
define_flag("mxu_crossing", "auto",
            "sorted<->canonical crossing lowering of the mxu path: take | "
            "sort | auto.  'auto' times both once per geometry on a card "
            "and takes 'take' on the CPU (ops/crossing.py)")
define_flag("mxu_crossing_bf16", False,
            "move the mxu pull crossing in bfloat16 (the push crossing of "
            "the legacy payload stays f32: it carries the exact slot id)")
define_flag("ps_device_cache", False,
            "keep the hottest embedding rows resident in device memory "
            "across passes (the HBM tier of the HBM/DRAM/SSD store, "
            "≙ HeterPS fleet/heter_ps).  build_pull then fetches only "
            "cache MISSES over the wire; hits are gathered device-side "
            "into the pass working set.  Bit-identical to cache-off — "
            "the cache is write-back at pass granularity and never a "
            "second source of truth across a checkpoint commit")
define_flag("ps_device_cache_rows", 262_144,
            "row capacity of the device-resident hot-row cache "
            "(ps/device_cache.py); admission/eviction ranks by the "
            "day-scale delta_score stats plus pass recency")
