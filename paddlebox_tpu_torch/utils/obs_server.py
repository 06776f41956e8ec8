"""In-process observability exporter — one stdlib ``http.server`` thread
serving the process's StatRegistry and span ring (Prometheus-style pull
exposition, PAPERS.md):

Copy of ``paddlebox_tpu/utils/obs_server.py`` with the import paths rewritten;
host code (stdlib and numpy), so none of its threads makes a device
call.

  ``/metrics``  Prometheus text exposition: counters/gauges as gauges,
                histograms as summaries (quantile/sum/count lines).
  ``/statz``    the full flat JSON snapshot (counters + histogram
                percentile keys) — the machine-merge surface the
                launch.py supervisor scrapes into one job-wide view.
                ``?raw=1`` adds ``_hist_raw`` (sparse bucket counts per
                histogram) so the supervisor can merge bucket-wise.
  ``/tracez``   newest-N finished spans from the host tracer
                (utils/trace.py), JSON.
  ``/flightz``  newest-N flight-recorder events (utils/flight.py);
                ``?n=`` and ``?kind=`` filter.
  ``/timelinez`` the telemetry timeline (utils/timeline.py): index +
                SLO watchdog states, or one metric's value/rate series
                via ``?name=&n=``.
  ``/clusterz`` the job-level merged timeline — answered by the
                launch.py supervisor's cluster scraper (registered via
                ``set_clusterz_provider``); workers answer
                ``enabled=False``.
  ``/debugz``   a full wedge-doctor bundle (utils/doctor.py): all-thread
                stacks + flight ring + stat snapshot + workpool state.

``/statz`` and ``/metrics`` accept ``?prefix=`` (dotted-segment match,
monitor._prefix_match) so scrapers can pull narrow slices.

Off by default: ``FLAGS_obs_port`` = 0 starts nothing and no
instrumentation site pays more than an is-None/flag check.  launch.py
assigns ``base_port + rank`` to each worker; ``init_distributed``
starts the server from the flag, and starting the exporter also enables
the span tracer (``/tracez`` without a tracer would always be empty).
"""

from __future__ import annotations

import json
import math
import re
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils import doctor, flight, timeline, trace
from paddlebox_tpu_torch.utils.monitor import Histogram, StatRegistry

flags.define_flag(
    "obs_port", 0,
    "serve /metrics (Prometheus text), /statz (JSON snapshot) and "
    "/tracez (recent spans) on 127.0.0.1:<port>; 0 = off.  launch.py "
    "--obs_port assigns base+rank per worker; starting the exporter "
    "also enables the span tracer")

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    return "pbox_" + _PROM_BAD.sub("_", name)


def _prom_val(v: float) -> str:
    """Prometheus sample value: non-finite gauges render as the
    exposition-format spellings ``+Inf``/``-Inf``/``NaN`` (Python's
    ``repr`` gives ``inf``/``nan``, which scrapers reject)."""
    f = float(v)
    if math.isfinite(f):
        return repr(f)
    if math.isnan(f):
        return "NaN"
    return "+Inf" if f > 0 else "-Inf"


def render_prometheus(prefix: str = "") -> str:
    """Prometheus text exposition (version 0.0.4) of the registry:
    plain stats as gauges, histograms as summaries.  ``prefix`` narrows
    to one dotted subtree (the ``?prefix=`` scrape filter)."""
    reg = StatRegistry.instance()
    lines: List[str] = []
    for name, val in sorted(reg.counter_snapshot(prefix).items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_prom_val(val)}")
    for name, summ in sorted(reg.hist_snapshot(prefix).items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'{pn}{{quantile="{q}"}} {_prom_val(summ[key])}')
        lines.append(f"{pn}_sum {_prom_val(summ['sum'])}")
        lines.append(f"{pn}_count {int(summ['count'])}")
    return "\n".join(lines) + "\n"


# reserved key carrying raw histogram buckets in a /statz?raw=1 snapshot
HIST_RAW_KEY = "_hist_raw"
# reserved key carrying the mergeable heat-sketch export (ps/heat.py's
# raw() in the utils/sketch.py merge_heat_raw schema)
HEAT_RAW_KEY = "_heat_raw"


def _heat_active():
    """The process HeatMap, or None.  Lazy: utils must not import ps at
    module level (doctor.py's embed discipline)."""
    try:
        from paddlebox_tpu_torch.ps import heat
    except Exception:  # noqa: BLE001 — obs must not require the ps layer
        return None
    return heat.ACTIVE


def render_statz(raw: bool = False, prefix: str = "") -> str:
    """The flat JSON snapshot.  Non-finite gauges are OMITTED — bare
    ``Infinity``/``NaN`` tokens are invalid JSON and would break every
    strict consumer of the scrape.  ``raw=True`` adds ``_hist_raw``
    (sparse bucket counts per histogram) and, when heat telemetry is on,
    ``_heat_raw`` (the mergeable key-space sketch export) for bucket-wise
    supervisor merging; ``prefix`` narrows the stat keys to one dotted
    subtree so the cluster scraper (and external Prometheus) can pull
    slices instead of the full snapshot every interval."""
    reg = StatRegistry.instance()
    out: Dict = {k: v for k, v in reg.snapshot(prefix).items()
                 if math.isfinite(v)}
    if raw:
        out[HIST_RAW_KEY] = reg.hist_raw(prefix)
        hm = _heat_active()
        if hm is not None:
            out[HEAT_RAW_KEY] = hm.raw()
    return json.dumps(out, sort_keys=True)


def render_tracez(limit: int = 256) -> str:
    spans = trace.ACTIVE.spans(limit) if trace.ACTIVE is not None else []
    return json.dumps({"enabled": trace.ACTIVE is not None,
                       "spans": spans})


def render_flightz(n: int = 256, kind: Optional[str] = None) -> str:
    ring = flight.ring()
    return json.dumps({
        "enabled": ring is not None,
        "capacity": ring.capacity if ring is not None else 0,
        "counts": ring.counts() if ring is not None else {},
        "events": flight.events(n=n, kind=kind),
    }, default=str)


def render_heatz(topn: int = 100) -> str:
    """The key-space heat plane (ps/heat.py): per-site top-K keys with
    estimated rates, per-shard load shares, the fitted zipf exponent and
    the working-set curve.  ``enabled=False`` when FLAGS_obs_heat is off
    (or the ps layer isn't importable)."""
    hm = _heat_active()
    if hm is None:
        return json.dumps({"enabled": False})
    out = hm.render(topn=topn)
    out["enabled"] = True
    return json.dumps(out)


def render_timelinez(name: Optional[str] = None,
                     n: Optional[int] = None) -> str:
    """The telemetry timeline (utils/timeline.py): without ``name`` an
    index (names + watchdog states), with it one metric's value/rate
    series."""
    s = timeline.sampler()
    if name:
        return json.dumps(timeline.series(name, n=n))
    return json.dumps({
        "enabled": s is not None,
        "interval_s": s.interval_s if s is not None else 0.0,
        "len": len(s.ring) if s is not None else 0,
        "names": s.ring.names() if s is not None else [],
        "slo": {
            "states": s.watchdog.states() if s is not None else {},
            "rules": [r.describe() for r in s.watchdog.rules]
            if s is not None else [],
        },
    })


# -- /clusterz provider (supervisor-side) -----------------------------------
# launch.py's cluster scraper registers a callable here; worker processes
# have none and answer /clusterz with enabled=False.
_CLUSTERZ: Optional[object] = None


def set_clusterz_provider(fn) -> None:
    """Register ``fn(name=None, n=None) -> dict`` as the /clusterz
    source (the supervisor's ClusterScraper); None unregisters."""
    global _CLUSTERZ
    _CLUSTERZ = fn


def render_clusterz(name: Optional[str] = None,
                    n: Optional[int] = None) -> str:
    fn = _CLUSTERZ
    if fn is None:
        return json.dumps({"enabled": False})
    return json.dumps(fn(name=name, n=n), default=str)


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):        # no stderr spam per scrape
        pass

    def do_GET(self):
        path, _, qs = self.path.partition("?")
        q = urllib.parse.parse_qs(qs)
        try:
            prefix = q.get("prefix", [""])[0]
            if path == "/metrics":
                body = render_prometheus(prefix=prefix)
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/statz":
                raw = q.get("raw", ["0"])[0] not in ("", "0")
                body, ctype = render_statz(raw=raw, prefix=prefix), \
                    "application/json"
            elif path == "/tracez":
                body, ctype = render_tracez(), "application/json"
            elif path == "/flightz":
                n = int(q.get("n", ["256"])[0])
                kind = q.get("kind", [None])[0]
                body, ctype = render_flightz(n=n, kind=kind), \
                    "application/json"
            elif path == "/heatz":
                topn = int(q.get("topn", ["100"])[0])
                body, ctype = render_heatz(topn=topn), "application/json"
            elif path == "/timelinez":
                name = q.get("name", [None])[0]
                n_s = q.get("n", [None])[0]
                body, ctype = render_timelinez(
                    name=name, n=int(n_s) if n_s else None), \
                    "application/json"
            elif path == "/clusterz":
                name = q.get("name", [None])[0]
                n_s = q.get("n", [None])[0]
                body, ctype = render_clusterz(
                    name=name, n=int(n_s) if n_s else None), \
                    "application/json"
            elif path == "/debugz":
                body, ctype = doctor.render_debugz(), "application/json"
            else:
                self.send_error(404, "unknown path (want /metrics, "
                                     "/statz, /tracez, /flightz, "
                                     "/heatz, /timelinez, /clusterz, "
                                     "/debugz)")
                return
        except Exception as e:  # noqa: BLE001 — a scrape must never kill
            self.send_error(500, repr(e))
            return
        raw = body.encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)


class ObsServer:
    """One daemon HTTP thread per process; ``port=0`` binds an ephemeral
    port (tests), ``addr`` reports the bound (host, port)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self.addr: Tuple[str, int] = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


_SERVER: Optional[ObsServer] = None
_SERVER_LOCK = threading.Lock()


def start(port: int = 0, host: str = "127.0.0.1") -> ObsServer:
    """Start (or return) the process-wide exporter.  Also enables the
    span tracer so /tracez has a source."""
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is None:
            trace.enable()
            _SERVER = ObsServer(port=port, host=host)
        return _SERVER


def stop() -> None:
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.shutdown()
            _SERVER = None


def maybe_start_from_flags() -> Optional[ObsServer]:
    """Worker entry hook: start the exporter iff ``FLAGS_obs_port`` is
    set (launch.py exports base+rank per worker); always honors
    ``FLAGS_obs_trace`` for the tracer alone."""
    trace.maybe_enable_from_flags()
    timeline.maybe_start_from_flags()
    try:
        from paddlebox_tpu_torch.ps import heat
        heat.maybe_enable_from_flags()
    except Exception:  # noqa: BLE001 — obs must not require the ps layer
        pass
    port = int(flags.get_flags("obs_port"))
    if port <= 0:
        return None
    return start(port=port)


# -- supervisor-side scrape/merge -------------------------------------------
def scrape(port: int, path: str = "/statz", host: str = "127.0.0.1",
           timeout: float = 2.0) -> Optional[Dict[str, float]]:
    """GET one worker's snapshot; None on any failure (a dead or
    not-yet-listening worker must not fail the supervisor)."""
    url = f"http://{host}:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except Exception:  # noqa: BLE001 — scrape is best-effort by contract
        return None


_MERGE_MAX_SUFFIXES = (".max", ".p50", ".p95", ".p99", "hwm")
_PCT_SUFFIXES = (".p50", ".p95", ".p99")
_PCT_QS = ((50, ".p50"), (95, ".p95"), (99, ".p99"))


def merge_snapshots(snaps: List[Dict[str, float]]) -> Dict[str, float]:
    """Fold per-worker /statz snapshots into one job-wide view: counters
    and sums ADD across workers; high-water marks take the worst (max)
    worker — a job is as slow as its slowest shard.

    Percentiles: taking the max of per-worker ``.p50/.p95/.p99`` is
    statistically wrong (the max of medians is not the median of the
    union, and tail percentiles can be badly skewed by one low-count
    worker).  When a snapshot carries ``_hist_raw`` (a ``/statz?raw=1``
    scrape), its histograms are merged BUCKET-WISE across workers and
    job-wide percentiles are recomputed exactly (up to bucket
    resolution).  Workers that predate raw export still fold in via the
    old max-of-percentiles fallback, so merged tails never understate."""
    out: Dict[str, float] = {}
    raws: Dict[str, List[Dict]] = {}
    heat_raws: List[Dict] = []
    for snap in snaps:
        if not snap:
            continue
        hr = snap.get(HIST_RAW_KEY)
        hr = hr if isinstance(hr, dict) else {}
        for name, r in hr.items():
            if isinstance(r, dict):
                raws.setdefault(name, []).append(r)
        heat_r = snap.get(HEAT_RAW_KEY)
        if isinstance(heat_r, dict):
            heat_raws.append(heat_r)
        for k, v in snap.items():
            if k == HIST_RAW_KEY or not isinstance(v, (int, float)):
                continue
            if k.startswith("heat."):
                # heat gauges are sketch-derived, not additive: summing
                # topk_share across workers is meaningless.  Raw-scraped
                # workers are recomputed from the merged sketches below;
                # max is the non-raw fallback (never understates skew)
                if v > out.get(k, float("-inf")):
                    out[k] = v
                continue
            if k.endswith(_MERGE_MAX_SUFFIXES):
                # this worker's percentile keys are recomputed from its
                # raw buckets below — don't let its per-worker
                # percentile leak into the max fallback
                if k.endswith(_PCT_SUFFIXES) and \
                        k.rsplit(".", 1)[0] in hr:
                    continue
                if v > out.get(k, float("-inf")):
                    out[k] = v
            else:
                out[k] = out.get(k, 0.0) + v
    for name, rlist in raws.items():
        h = Histogram.from_raw(rlist)
        for q, suf in _PCT_QS:
            k = name + suf
            v = h.percentile(q)
            out[k] = max(out[k], v) if k in out else v
    if heat_raws:
        # fleet heat = bucket-wise sketch merge, then the SAME derived-
        # gauge formula every worker applies locally — never a naive
        # fold of the workers' gauges
        from paddlebox_tpu_torch.utils import sketch
        out.update(sketch.heat_gauges_from_raw(
            sketch.merge_heat_raw(heat_raws)))
    return out
