"""Host-side span tracer — explicit start/stop spans with wire-propagated
trace context (≙ the reference's old RecordEvent span layer,
platform/profiler.cc, rebuilt Dapper-style: every span carries a
``trace_id`` shared by the whole causal chain and a ``span_id``/parent
link, and the PS wire protocol forwards ``trace_id:span_id`` so a server
dispatch span parents to the originating client span across processes —
PAPERS.md, Dapper + Prometheus exposition).

Design constraints:

* **Zero hot-path cost when disabled.**  Instrumentation sites guard on
  the module-level ``ACTIVE`` handle (the ps/faults.py pattern): one
  ``is None`` check per site, no allocation, no lock; :func:`span`
  then returns one shared no-op context.
* **On the profiler's clock.**  A span opened while ``torch.profiler``
  records also opens a ``record_function`` range of its name, so it
  lands in the profiler's own trace (a ``user_annotation`` on the
  calling thread) beside the kernels it launched.
* **Device time.**  A span given ``device=`` a CUDA device records a
  timing event on that device's current stream at open and at close;
  ``device_s`` is their interval, read only once both have completed
  (never blocking), else None.
* **Bounded memory.**  Finished spans land in a ring buffer
  (``FLAGS_obs_trace_ring``); retention is newest-N, exactly what
  ``/tracez`` (utils/obs_server.py) serves.
* **Thread-correct.**  The open-span stack is ``threading.local``; each
  span records its thread id and monotonic-clock start/duration, so the
  Chrome-trace export lays spans out per thread like the reference's
  chrome tracing (a profiler output directory given to
  ``export_chrome_trace`` receives ``host_spans.trace.json`` beside the
  device trace).
* **Exactly-once friendly.**  The wire context rides request RETRIES
  unchanged (the resent frame carries the same ``tctx``), and the
  server only opens a dispatch span when a verb actually EXECUTES — a
  dedup-window replay returns the cached response without a second
  span, so chaos retries never duplicate server spans.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from paddlebox_tpu_torch import flags

flags.define_flag(
    "obs_trace", False,
    "enable the host-side span tracer at import of the worker entry "
    "points (init_distributed / obs exporter start); off = every "
    "instrumentation site is a single is-None check")
flags.define_flag(
    "obs_trace_ring", 4096,
    "finished-span ring-buffer retention of the host tracer (newest N "
    "spans; /tracez serves from this ring)")

# optional wire field carrying "trace_id:span_id" (defined here, ridden
# by ps/wire.py frames next to the PR 2 rid)
CTX_SEP = "/"


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "dur",
                 "tid", "attrs", "device", "_range", "_events", "_device_s")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.monotonic()
        self.dur: Optional[float] = None
        self.tid = threading.get_ident()
        self.attrs = attrs
        self.device = None
        self._range = None
        self._events = None
        self._device_s: Optional[float] = None

    def context(self) -> str:
        """The wire form: ``<trace_id>/<span_id>``."""
        return f"{self.trace_id}{CTX_SEP}{self.span_id}"

    @property
    def device_s(self) -> Optional[float]:
        """Seconds between the span's two device events, once both have
        completed; None before that and for a span with no device."""
        ev = self._events
        if self._device_s is None and ev is not None and len(ev) == 2 \
                and ev[0].query() and ev[1].query():
            self._device_s = ev[0].elapsed_time(ev[1]) * 1e-3
        return self._device_s

    def as_dict(self) -> Dict:
        d = {"name": self.name, "trace_id": self.trace_id,
             "span_id": self.span_id, "parent_id": self.parent_id,
             "t0": self.t0, "dur_s": self.dur, "tid": self.tid}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.device is not None:
            d["device_s"] = self.device_s
        return d


def _profiler_range(name: str):
    """An open ``record_function`` range of ``name`` when torch.profiler
    is recording on this thread, else None (torch is never imported
    here: a process that has not imported it runs no profiler)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


def _device_event(device):
    """A timing event recorded now on ``device``'s current stream, for a
    CUDA device; None otherwise."""
    if getattr(device, "type", None) != "cuda":
        return None
    torch = sys.modules["torch"]
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


# the shared context of every span with the tracer off
NO_SPAN = contextlib.nullcontext()


def parse_context(ctx: Optional[str]):
    """``"trace/span"`` → (trace_id, span_id); None / malformed → None."""
    if not ctx or not isinstance(ctx, str) or CTX_SEP not in ctx:
        return None
    trace_id, _, span_id = ctx.partition(CTX_SEP)
    if not trace_id or not span_id:
        return None
    return trace_id, span_id


class SpanTracer:
    """Explicit start/stop span recorder with per-thread open-span
    stacks and a bounded finished-span ring."""

    def __init__(self, ring: Optional[int] = None):
        cap = int(flags.get_flags("obs_trace_ring")
                  if ring is None else ring)
        self._ring: "deque[Span]" = deque(maxlen=max(1, cap))
        self._lock = threading.Lock()
        self._tls = threading.local()
        # id space unique per process instance (spans from different
        # workers merge in the supervisor scrape without collisions)
        self._token = f"{os.getpid():x}-{os.urandom(3).hex()}"
        self._seq = 0

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            return f"{self._token}-{self._seq:x}"

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- span lifecycle ------------------------------------------------------
    def start_span(self, name: str, parent: Optional[str] = None, *,
                   device=None, **attrs) -> Span:
        """Open a span.  ``parent`` is a wire context string
        (``trace/span``); when omitted the span nests under this
        thread's innermost open span, or roots a fresh trace.
        ``device``: the torch device whose work the span encloses; on a
        CUDA device the span times that work with two events
        (``device_s``)."""
        parsed = parse_context(parent)
        if parsed is not None:
            trace_id, parent_id = parsed
        else:
            stack = self._stack()
            if stack:
                top = stack[-1]
                trace_id, parent_id = top.trace_id, top.span_id
            else:
                trace_id, parent_id = self._next_id(), None
        span = Span(name, trace_id, self._next_id(), parent_id, attrs)
        self._stack().append(span)
        span._range = _profiler_range(name)
        if device is not None:
            span.device = device
            ev = _device_event(device)
            if ev is not None:
                span._events = (ev,)
        return span

    def finish(self, span: Span) -> None:
        if span._events is not None:
            span._events += (_device_event(span.device),)
        if span._range is not None:
            span._range.__exit__(None, None, None)
            span._range = None
        span.dur = time.monotonic() - span.t0
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:         # out-of-order finish: drop in place
            stack.remove(span)
        with self._lock:
            self._ring.append(span)

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[str] = None, *,
             device=None, **attrs):
        s = self.start_span(name, parent=parent, device=device, **attrs)
        try:
            yield s
        finally:
            self.finish(s)

    def current_context(self) -> Optional[str]:
        """Wire context of this thread's innermost open span."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1].context() if stack else None

    # -- retention / export --------------------------------------------------
    def spans(self, n: Optional[int] = None) -> List[Dict]:
        """Newest-first finished spans (bounded by the ring)."""
        with self._lock:
            out = [s.as_dict() for s in reversed(self._ring)]
        return out if n is None else out[:n]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def chrome_trace_events(self) -> List[Dict]:
        """Chrome-trace "X" (complete) events, monotonic microseconds —
        loads in chrome://tracing / Perfetto beside the XLA host trace."""
        pid = os.getpid()
        events = []
        with self._lock:
            spans = list(self._ring)
        for s in spans:
            args = {"trace_id": s.trace_id, "span_id": s.span_id}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            for k, v in s.attrs.items():
                args[str(k)] = v if isinstance(v, (int, float, bool)) \
                    else str(v)
            if s.device is not None:
                args["device_s"] = s.device_s
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                "ts": s.t0 * 1e6, "dur": (s.dur or 0.0) * 1e6,
                "args": args,
            })
        return events

    def export_chrome_trace(self, path: str) -> str:
        """Write the ring as a Chrome-trace JSON file.  ``path`` may be a
        directory (e.g. a torch.profiler output dir — the host spans merge
        into the same trace collection): the file lands inside it as
        ``host_spans.trace.json``."""
        if os.path.isdir(path):
            path = os.path.join(path, "host_spans.trace.json")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_trace_events(),
                       "displayTimeUnit": "ms"}, f)
        return path


# module-level handle — the one hot-path check (≙ faults.ACTIVE)
ACTIVE: Optional[SpanTracer] = None


def enable(ring: Optional[int] = None) -> SpanTracer:
    global ACTIVE
    if ACTIVE is None:
        ACTIVE = SpanTracer(ring=ring)
    return ACTIVE


def disable() -> None:
    global ACTIVE
    ACTIVE = None


def maybe_enable_from_flags() -> Optional[SpanTracer]:
    if flags.get_flags("obs_trace"):
        return enable()
    return ACTIVE


def wire_context() -> Optional[str]:
    """Current thread's span context for stamping outgoing requests
    (None when the tracer is off or no span is open)."""
    return ACTIVE.current_context() if ACTIVE is not None else None


def span(name: str, parent: Optional[str] = None, *, device=None,
         **attrs):
    """Span context manager for call sites that don't want to hold a
    tracer reference; with the tracer off, the shared no-op
    ``NO_SPAN``."""
    if ACTIVE is None:
        return NO_SPAN
    return ACTIVE.span(name, parent=parent, device=device, **attrs)
