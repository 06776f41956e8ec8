"""Wedge doctor — one-call postmortem bundles for stuck processes.

Copy of ``paddlebox_tpu/utils/doctor.py`` with the import paths rewritten;
host code (stdlib and numpy), so none of its threads makes a device
call.

A wedged run that leaves nothing but "watchdog: phase exceeded its
budget" leaves no stacks either.  ``dump_state()`` collects everything a human needs to diagnose a hang
into one JSON-able dict:

* all-thread Python stacks (``sys._current_frames`` + thread names /
  daemon flags from ``threading.enumerate``),
* the flight-recorder ring (utils/flight.py — what the process was
  *doing* right before it stopped),
* the full stat snapshot (utils/monitor.py),
* workpool queue state (utils/workpool.py — queued vs active),
* pid / argv / platform breadcrumbs.

Three delivery paths:

1. **SIGUSR1** (``install()``) — live interrogation of a running
   worker: ``kill -USR1 <pid>`` writes a postmortem bundle under
   ``FLAGS_obs_postmortem_dir`` and prints its path to stderr.
   ``install()`` also enables ``faulthandler`` so hard crashes
   (segfault, deadlocked interpreter via SIGABRT) still dump native
   stacks to stderr even when this module can't run.
2. **/debugz** (utils/obs_server.py) — scrape the bundle over HTTP.
3. **a harness's phase watchdog** (the JAX package's bench.py) — on
   phase-budget expiry the child writes a postmortem file BEFORE
   emitting its error line and the supervisor records the path, so the
   next wedge ships with stacks attached.

Collection cost is irrelevant (it runs when the process is already
stuck); what matters is that it CANNOT hang: no locks are taken beyond
the registries' own short-critical-section locks, and file writes go
through a plain open/json.dump.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Optional

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import stat_snapshot

flags.define_flag(
    "obs_postmortem_dir", "",
    "directory for wedge-doctor postmortem bundles (SIGUSR1 handler, "
    "phase watchdog); empty = <system tmpdir>/pbox-postmortems")

_FLIGHT_N = 256                     # last-N flight events per bundle


def thread_stacks() -> List[Dict]:
    """Python stacks of every live thread, newest frame last."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        t = names.get(tid)
        entry = {
            "tid": tid,
            "name": t.name if t is not None else f"unknown-{tid}",
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": [f"{fs.filename}:{fs.lineno} in {fs.name}: "
                      f"{(fs.line or '').strip()}"
                      for fs in traceback.extract_stack(frame)],
        }
        out.append(entry)
    out.sort(key=lambda e: (e["name"] != "MainThread", e["name"]))
    return out


def dump_state(reason: str = "", flight_n: int = _FLIGHT_N) -> Dict:
    """The full postmortem bundle as one JSON-able dict."""
    bundle: Dict = {
        "reason": reason,
        "time": time.time(),
        "mono": time.monotonic(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "platform": sys.platform,
        "threads": thread_stacks(),
        "flight": flight.events(n=flight_n),
        "stats": stat_snapshot(),
    }
    try:                            # lazy: workpool pulls in flags only
        from paddlebox_tpu_torch.utils import workpool
        bundle["workpool"] = workpool.pool_state()
    except Exception as e:          # never let the doctor itself wedge
        bundle["workpool"] = {"error": repr(e)}
    try:
        from paddlebox_tpu_torch.utils import lockdep
        if lockdep.enabled():
            bundle["lockdep"] = lockdep.state()
    except Exception as e:
        bundle["lockdep"] = {"error": repr(e)}
    try:                            # lazy: avoid an import cycle with
        from paddlebox_tpu_torch.utils import timeline  # obs_server→doctor
        s = timeline.sampler()
        if s is not None:
            # the minutes LEADING UP TO the wedge, not just its instant
            bundle["timeline"] = {"interval_s": s.interval_s,
                                  "slo": s.watchdog.states(),
                                  "tail": timeline.tail()}
    except Exception as e:
        bundle["timeline"] = {"error": repr(e)}
    try:                            # lazy: utils never imports ps eagerly
        from paddlebox_tpu_torch.ps import heat
        if heat.ACTIVE is not None:
            # the key-space heat tail: was the wedge a hot-key storm?
            bundle["heat"] = heat.ACTIVE.render(topn=20)
    except Exception as e:
        bundle["heat"] = {"error": repr(e)}
    return bundle


def render_debugz(reason: str = "debugz") -> str:
    """The bundle as JSON text (the /debugz obs endpoint body)."""
    return json.dumps(dump_state(reason=reason), indent=1, default=str)


def postmortem_dir() -> str:
    d = str(flags.get_flags("obs_postmortem_dir") or "")
    if not d:
        d = os.path.join(tempfile.gettempdir(), "pbox-postmortems")
    os.makedirs(d, exist_ok=True)
    return d


def write_postmortem(reason: str = "", directory: Optional[str] = None) -> str:
    """Write a postmortem bundle file; returns its path."""
    d = directory or postmortem_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(
        d, f"postmortem-{os.getpid()}-{int(time.time() * 1000)}.json")
    bundle = dump_state(reason=reason)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(bundle, f, indent=1, default=str)
    os.replace(tmp, path)
    flight.record("postmortem_written", path=path, reason=reason)
    return path


def _sigusr1(signum, frame) -> None:
    try:
        path = write_postmortem(reason="sigusr1")
        print(f"[doctor] postmortem: {path}", file=sys.stderr, flush=True)
    except Exception as e:
        print(f"[doctor] postmortem failed: {e!r}", file=sys.stderr,
              flush=True)


def install() -> bool:
    """Enable faulthandler + the SIGUSR1 live-interrogation handler.
    Returns True when the signal handler was installed (needs the main
    thread and a platform with SIGUSR1; safe no-op otherwise)."""
    try:
        faulthandler.enable()
    except Exception:
        pass
    try:
        signal.signal(signal.SIGUSR1, _sigusr1)
        return True
    except (ValueError, OSError, AttributeError):
        return False                # non-main thread / no SIGUSR1
