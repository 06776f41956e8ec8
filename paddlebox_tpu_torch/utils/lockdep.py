"""Runtime lock-order witness (the dynamic half of pboxlint PB6xx).

``FLAGS_lockdep`` off (the default): the factories return **raw**
``threading`` primitives — zero wrapper, zero hot-path cost, nothing to
reason about in production.  On: every factory-created lock is wrapped in
a ``_DepLock`` that

* keeps a per-thread list of held lock *names* (class-level fingerprints
  like ``ps.service.PSClient._lock`` — the same namespace the static
  analyzer in ``tools/pboxlint/lockgraph.py`` uses, so the two sides
  cross-validate: tier-1 asserts every runtime-observed edge exists in
  the static over-approximation),
* records an acquisition-order edge ``held → wanted`` at acquire
  *attempt* time — **before** blocking on the inner lock — so a real
  ABBA deadlock still produces its ``lock_cycle`` evidence even while
  both threads are stuck,
* runs an online DFS cycle check on every *new* edge and, on a cycle,
  emits a ``lock_cycle`` flight event (one per unique cycle — the flight
  ring's bounded-kind rule) and stores the cycle for
  ``state()``/doctor postmortems.  It never raises and never blocks a
  correct program: detection is advisory, by design.

Bookkeeping runs on plain ``threading`` primitives (never on wrapped
locks) and the flight event is emitted outside the graph lock, so the
witness cannot itself deadlock or recurse.

``threading.Condition(dep_lock)`` works unchanged: ``Condition``
duck-types through ``acquire``/``release`` (and our ``_is_owned``
delegate), so ``wait()`` correctly pops the held-set on release and
re-records the edge on reacquire.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple, Union

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.utils import flight

flags.define_flag(
    "lockdep", False,
    "instrument factory-created locks with the runtime lock-order "
    "witness (per-thread held-sets, global acquisition-order graph, "
    "online cycle detection; lock_cycle flight events + doctor state). "
    "Debug/soak mode: off = raw threading primitives, zero cost")

flags.define_flag(
    "lockdep_guards", False,
    "with FLAGS_lockdep: activate the guarded-by witness — "
    "lockdep.guards(obj, field) assertion points at hot mutation sites "
    "(plus install_guard_probe sampling proxies) record (site, "
    "held-locks) observations and, against an installed static "
    "guarded-by map (pboxlint raceguard.guard_map()), emit ONE "
    "race_suspect flight event per violating site for doctor "
    "postmortems. Off (the default): guards() is a single cached-flag "
    "test, zero allocation")

# -- global witness state (plain primitives: never instrumented) ----------
_graph_lock = threading.Lock()
_edges: Dict[Tuple[str, str], Dict] = {}        # (a, b) → first witness
_cycles: List[Dict] = []
_seen_cycles: Set[Tuple[str, ...]] = set()
_held_tls = threading.local()                   # .names: List[str]
_held_by_thread: Dict[int, List[str]] = {}      # ident → alias of the list

# -- guarded-by witness state (PB9xx runtime half) ------------------------
_guards_cache: Optional[bool] = None            # lazy flag resolve
_guard_map: Dict[str, Tuple[str, ...]] = {}     # site → static guard fps
_guard_obs: Dict[str, Set[Tuple[str, ...]]] = {}  # site → held-set tuples
_guard_suspects: List[Dict] = []
_suspect_sites: Set[str] = set()


def enabled() -> bool:
    return bool(flags.get_flags("lockdep"))


def guards_enabled() -> bool:
    """Both flags on — the guards witness needs FLAGS_lockdep for its
    held-sets (raw primitives record nothing).  Resolved once and
    cached so the off-path in ``guards()`` is one global load;
    ``reset()`` clears the cache (the test fixture pattern: set flags,
    then ``lockdep.reset()``)."""
    global _guards_cache
    on = _guards_cache
    if on is None:
        on = _guards_cache = bool(
            flags.get_flags("lockdep_guards")) and enabled()
    return on


def _held() -> List[str]:
    lst = getattr(_held_tls, "names", None)
    if lst is None:
        lst = _held_tls.names = []
        with _graph_lock:
            _held_by_thread[threading.get_ident()] = lst
    return lst


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS over _edges (caller holds _graph_lock): src ⇝ dst or None."""
    stack: List[Tuple[str, List[str]]] = [(src, [src])]
    seen: Set[str] = set()
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for (a, b) in _edges:
            if a == node and b not in seen:
                stack.append((b, path + [b]))
    return None


def _note_edges(held: List[str], wanted: str) -> None:
    """Record held→wanted edges; on a NEW edge, check for a cycle."""
    new_cycles: List[Dict] = []
    with _graph_lock:
        for h in dict.fromkeys(held):           # dedupe, keep order
            if h == wanted:
                continue
            key = (h, wanted)
            if key in _edges:
                _edges[key]["count"] += 1
                continue
            # does wanted already reach h?  then held→wanted closes a loop
            back = _find_path(wanted, h)
            _edges[key] = {"count": 1,
                           "thread": threading.current_thread().name}
            if back is not None:
                cycle = back + [wanted]         # h ⇝ wanted → h
                sig = tuple(sorted(set(cycle)))
                if sig not in _seen_cycles:
                    _seen_cycles.add(sig)
                    info = {"cycle": cycle,
                            "edge": [h, wanted],
                            "thread": threading.current_thread().name,
                            "held": list(held)}
                    _cycles.append(info)
                    new_cycles.append(info)
    for info in new_cycles:                     # flight: outside the lock
        flight.record("lock_cycle",
                      path="→".join(info["cycle"]),
                      edge=f"{info['edge'][0]}→{info['edge'][1]}",
                      thread=info["thread"])


class _DepLock:
    """Wrapper around a threading.Lock/RLock carrying a class fingerprint.

    Edge recording happens at blocking-acquire *attempt*; the held-set
    is updated only on success.  Non-blocking probes (``acquire(False)``,
    e.g. Condition's ``_is_owned`` fallback) record nothing — a failed
    trylock cannot deadlock, and probe edges would be phantoms."""

    __slots__ = ("_inner", "name")

    def __init__(self, inner, name: str):
        self._inner = inner
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        if blocking and self.name not in held:
            _note_edges(held, self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            held.append(self.name)
        return ok

    def release(self) -> None:
        held = _held()
        self._inner.release()
        # pop the most recent entry (RLock depth unwinds LIFO)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self.name:
                del held[i]
                break

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked() if hasattr(self._inner, "locked") \
            else False

    def _is_owned(self) -> bool:
        # Condition(dep_rlock) consults this instead of probe-acquiring
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        return self.name in _held()

    def __repr__(self) -> str:
        return f"<DepLock {self.name} {self._inner!r}>"


LockLike = Union[threading.Lock, threading.RLock, "_DepLock"]


def lock(name: str) -> LockLike:
    """A ``threading.Lock`` — instrumented iff ``FLAGS_lockdep``."""
    raw = threading.Lock()
    return _DepLock(raw, name) if enabled() else raw


def rlock(name: str) -> LockLike:
    raw = threading.RLock()
    return _DepLock(raw, name) if enabled() else raw


def condition(name: str, lock: Optional[LockLike] = None) \
        -> threading.Condition:
    """A ``threading.Condition``.  Standalone conditions own an RLock
    named ``name``; pass an existing (possibly instrumented) lock to
    share it — the shared lock keeps *its* name, exactly like the static
    analyzer's ``Condition(self._lock)`` aliasing."""
    return threading.Condition(lock if lock is not None else rlock(name))


# -- guarded-by witness (the dynamic half of pboxlint PB9xx) --------------
def _site_of(obj, field: str) -> str:
    """Runtime site name in the STATIC analyzer's namespace:
    ``ps.service.PSServer._staged`` — ``type(obj).__module__`` with the
    package prefix stripped + qualname + field, exactly the
    ``FieldInfo.site`` key raceguard.guard_map() exports."""
    cls = type(obj)
    mod = cls.__module__
    if mod.startswith("paddlebox_tpu_torch."):
        mod = mod[len("paddlebox_tpu_torch."):]
    return f"{mod}.{cls.__qualname__}.{field}"


def guards(obj, field: str) -> None:
    """Assertion point at a hot mutation site: records the (site,
    held-locks) observation and — when a static guarded-by map is
    installed and names this site — emits a ``race_suspect`` flight
    event (once per site) if none of the site's guards is held.
    Advisory like the cycle witness: never raises."""
    if not guards_enabled():
        return
    site = _site_of(obj, field)
    held = tuple(_held())
    suspect = None
    with _graph_lock:
        _guard_obs.setdefault(site, set()).add(held)
        want = _guard_map.get(site)
        if want is not None and site not in _suspect_sites \
                and not set(held).intersection(want):
            _suspect_sites.add(site)
            suspect = {"site": site, "held": list(held),
                       "guard": list(want),
                       "thread": threading.current_thread().name}
            _guard_suspects.append(suspect)
    if suspect is not None:                     # flight: outside the lock
        flight.record("race_suspect", site=site,
                      held=",".join(suspect["held"]) or "(none)",
                      guard=",".join(suspect["guard"]),
                      thread=suspect["thread"])


def set_guard_map(mapping: Dict[str, List[str]]) -> None:
    """Install the static guarded-by map (raceguard.guard_map() shape:
    {site: [guard fingerprints]}) that ``guards()`` checks against."""
    with _graph_lock:
        _guard_map.clear()
        for site, fps in mapping.items():
            _guard_map[site] = tuple(fps)


def guard_observations() -> Dict[str, List[List[str]]]:
    """{site: sorted list of observed held-set lists} — the runtime half
    tier-1 asserts ⊆ the static guarded-by map."""
    with _graph_lock:
        return {site: sorted(list(h) for h in obs)
                for site, obs in sorted(_guard_obs.items())}


def guard_suspects() -> List[Dict]:
    with _graph_lock:
        return [dict(s) for s in _guard_suspects]


def install_guard_probe(cls: type, fields: List[str], every: int = 1):
    """Sampling proxy for annotated classes with no inline assertion
    points: wraps ``cls.__setattr__`` so every ``every``-th store to one
    of ``fields`` runs ``guards()`` first (the held-set at store time is
    what matters).  Returns a restore callable.  The sample counter is
    deliberately unlocked — it only paces sampling."""
    watched = frozenset(fields)
    orig = cls.__setattr__
    state = {"n": 0}

    def probing(self, name, value):
        if name in watched:
            state["n"] += 1
            if state["n"] % max(1, every) == 0:
                guards(self, name)
        orig(self, name, value)

    cls.__setattr__ = probing

    def restore():
        cls.__setattr__ = orig
    return restore


# -- introspection (doctor / tests / cross-validation) --------------------
def edges() -> List[Tuple[str, str]]:
    with _graph_lock:
        return sorted(_edges)


def cycles() -> List[Dict]:
    with _graph_lock:
        return [dict(c) for c in _cycles]


def held_by_thread() -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    names = {t.ident: t.name for t in threading.enumerate()}
    with _graph_lock:
        for ident, lst in _held_by_thread.items():
            if lst:
                out[names.get(ident, str(ident))] = list(lst)
    return out


def state() -> Dict:
    """JSON-able witness snapshot for doctor postmortems."""
    with _graph_lock:
        edge_list = [{"from": a, "to": b, **info}
                     for (a, b), info in sorted(_edges.items())]
        cyc = [dict(c) for c in _cycles]
        guard = {"enabled": guards_enabled(),
                 "sites_observed": len(_guard_obs),
                 "map_installed": len(_guard_map),
                 "suspects": [dict(s) for s in _guard_suspects]}
    return {"enabled": enabled(), "edges": edge_list, "cycles": cyc,
            "held": held_by_thread(), "guards": guard}


def reset() -> None:
    """Test helper: drop all recorded edges/cycles and guard
    observations, and re-resolve the guards flag (held-sets persist —
    they mirror locks actually held right now)."""
    global _guards_cache
    with _graph_lock:
        _edges.clear()
        _cycles.clear()
        _seen_cycles.clear()
        _guard_obs.clear()
        _guard_suspects.clear()
        _suspect_sites.clear()
        _guard_map.clear()
        _guards_cache = None
