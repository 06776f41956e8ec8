"""Online serving tier — read-only xbox replicas, atomic day hot-swap,
multi-tenant inference traffic (ROADMAP item 3: the BoxPS loop's third
leg, train → dump → **serve**).

Copy of ``paddlebox_tpu/ps/serving.py`` with the import paths rewritten.
Host code only (numpy, sockets, threads): it imports no torch, and no
replica, router or watcher thread makes a device call.  The device leg
of serving is the engine's ``freeze_for_serving`` (ps/pass_manager.py),
whose pulls run the hand-written gather kernels.

The reference feeds a serving fleet from the xbox base/delta dumps
(box_wrapper.cc:1286 SaveBase/SaveDelta); this module is the consumer
side.  Three pieces:

* :class:`FrozenHostTable` — an immutable snapshot of a
  ``ShardedHostTable``: keys sorted once at load, SoA row arrays frozen,
  lookups are pure numpy ``searchsorted`` gathers.  **No shard locks on
  the read path** (lint rule PB701 proves no table-mutating verb, shard
  lock, or optimizer call is reachable from it); misses serve the same
  key-deterministic defaults training would (``fv.default_rows_keyed``),
  so replica responses are bit-identical to an engine-side pull.

* :class:`ServingReplica` — a :class:`~paddlebox_tpu_torch.ps.service.PSServer`
  whose verb switch is replaced with a read-only serving surface over
  the same wire protocol (so ``PSClient``'s multi-stream pipelining,
  rids, and quantized payloads all apply unchanged): batched
  ``pull_sparse``, a ragged ``forward`` (per-sample sum-pool over
  [embed_w | mf] — the gather+pool inference kernel shape), ``size`` /
  ``list_tables`` / extended ``health``, and a ``swap`` control verb.
  Tables are namespaced ``<tenant>/<table>`` (≙ PSCORE's table
  hierarchy); per-tenant admission control bounds in-flight queries and
  sheds with a typed overload error (:data:`OVERLOADED` marker, so the
  router can tell shed from death); per-tenant
  ``serving.<tenant>.{qps,latency_s→p50/p99,inflight,shed}`` flow
  through the obs stack (/statz, timeline sampler, SLO watchdog).

  **Hot swap**: ``hot_swap(path)`` loads the next day's dump into a
  fresh generation off the serving path, flips one reference (a single
  attribute store — readers that already entered the old generation
  finish on its frozen tables), invalidates the attached DeviceRowCache
  at the flip, then retires the old generation after its in-flight
  queries drain.  The dump itself arrives via save_xbox's tmp+rename,
  and the day pointer via the xbox swap manifest
  (io/checkpoint.publish_xbox_manifest) — tmp+rename end to end; a
  replica watching the manifest (``watch_manifest``) swaps on a
  generation advance.

* :class:`ServingRouter` — client-side fan-over: one ``PSClient`` per
  replica, primary-first with failover on replica death
  (``pull_sparse``/``forward`` are rid-echo idempotent verbs, and
  replicas loaded from one dump answer bit-identically, so a retry on
  the survivor is safe and exact).  A typed :class:`ServingOverload`
  surfaces shed instead of blind retry; ``observe_generation`` clears
  every client's learned row-width estimates when the fleet's
  generation advances (the client side of the hot-swap coherence
  point).

Scale-out (ROADMAP item 3's remaining gap, closed here) — three layers
on top of the single-replica story above:

* **Sharded fleet**: a replica built with ``shard``/``n_shards`` keeps
  only its splitmix64 key range (``ps.cluster.owned_mask`` — the SAME
  placement as the training PS cluster) plus the replicated hot set, so
  serving capacity scales past one host's memory.  The router's
  ``shard_groups`` mode fans ``pull_sparse`` per shard through ONE
  multi-address ``PSClient`` — ps/cluster.py's partition, shared
  inflight budget, per-shard stats, and order-preserving position merge
  apply wholesale — and pools ``forward`` client-side with the exact
  replica kernel so N-shard answers stay bit-identical to one full
  table.

* **Delta freshness**: ``watch_ckpt`` streams io/checkpoint.py
  ``save_pass`` delta generations.  New chain links build a patched
  plane set OFF the serving path (:meth:`FrozenHostTable.patched` —
  copy-on-write, upserts applied in generation order) and flip through
  the same one-reference ``_Generation`` swap as a day hot-swap: zero
  failed requests during a flip, online-learned rows reach inference in
  one poll interval (``serving.staleness_s``).  A compaction or day
  rollover (the chain re-bases) falls back to a full rebuild of the new
  chain.  Torn MANIFEST reads (mid-rename) retry with bounded backoff
  and a ``manifest_retry`` flight event instead of killing the watcher.

* **Heat-driven hot-key replication**: the top-K keys of the serving
  ``HeatMap`` sketches (``heat.serving_hot_keys``,
  ``FLAGS_serving_hot_keys``) are replicated into EVERY shard group's
  frozen planes at build/patch time; the router routes hot keys by
  power-of-two-choices over live per-group load EWMAs, so one hot key's
  traffic spreads across the fleet instead of melting its owner shard.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import EmbeddingTableConfig
from paddlebox_tpu_torch.ps import cluster as ps_cluster
from paddlebox_tpu_torch.ps import feature_value as fv
from paddlebox_tpu_torch.ps import heat
from paddlebox_tpu_torch.ps import wire
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.service import DEFAULT_TABLE, PSClient, PSServer
from paddlebox_tpu_torch.utils import flight, lockdep
from paddlebox_tpu_torch.utils.monitor import (stat_add, stat_observe, stat_set,
                                         stat_snapshot)

flags.define_flag(
    "serve_max_inflight", 64,
    "per-tenant admission cap on a ServingReplica: queries in flight for "
    "one tenant beyond this shed with a typed overload error instead of "
    "queueing (0 = unbounded)")
flags.define_flag(
    "serve_tenants", "default",
    "comma-separated tenant namespaces a ServingReplica serves; each "
    "tenant sees the loaded tables as <tenant>/<table> and gets its own "
    "admission budget + serving.<tenant>.* metrics")
flags.define_flag(
    "serve_drain_s", 30.0,
    "hot-swap drain budget: seconds to wait for the old generation's "
    "in-flight queries before retiring it (the flip itself is atomic "
    "and never waits)")
flags.define_flag(
    "serving_hot_keys", 0,
    "hot-key replication set size for a sharded serving fleet: the top-K "
    "keys of the serve.* heat sketches are replicated into EVERY shard "
    "group's frozen planes at build/patch time so the router can spread "
    "their traffic power-of-two-choices across groups (0 = off; needs "
    "FLAGS_obs_heat unless an explicit hot set is passed)")
flags.define_flag(
    "serving_patch_poll_s", 2.0,
    "ckpt-manifest poll cadence for the delta-streaming watcher "
    "(ServingReplica.watch_ckpt): how often a replica looks for new "
    "save_pass generations to patch in — the freshness floor")
flags.define_flag(
    "serving_manifest_retries", 4,
    "bounded retry budget for a torn manifest read in a watcher poll "
    "(a writer mid-rename): each retry backs off 50ms doubling, emits a "
    "manifest_retry flight event, and the poll is abandoned (not the "
    "watcher) when the budget runs out")

# marker embedded in the shed error string: it survives the wire and the
# client's RuntimeError re-raise, so a router can type the failure
# without a schema change to the error path
OVERLOADED = "serving_overloaded"

_METERED_VERBS = frozenset({"pull_sparse", "forward"})
_READ_VERBS = frozenset({"pull_sparse", "forward", "size", "list_tables"})


class ServingOverload(RuntimeError):
    """Per-tenant admission shed — the replica is alive but this tenant
    is at its in-flight cap.  Deliberately NOT a ConnectionError: a shed
    must not trigger failover/retry storms against the next replica."""


class FrozenHostTable:
    """Immutable lookup-only snapshot of one embedding table.

    Built once at load (sort by key, copy the SoA into contiguous
    arrays); after that every ``lookup_rows`` is a pure numpy gather —
    no locks, no growth, no mutation surface at all.  Swaps replace the
    whole object by one reference flip.  Misses get the identical
    key-deterministic defaults a training-side ``bulk_pull`` would
    (``fv.default_rows_keyed`` with the same config + seed), which is
    what makes replica responses bit-identical to the engine."""

    def __init__(self, config: EmbeddingTableConfig, keys: np.ndarray,
                 soa: Dict[str, np.ndarray], seed: int = 0):
        self.config = config
        self.mf_dim = config.embedding_dim
        self.expand_dim = config.expand_dim
        self.adam = config.sgd.optimizer in ("adam", "shared_adam")
        self.optimizer = config.sgd.optimizer
        self.double_stats = config.accessor.accessor_type == "ctr_double"
        self._seed = seed
        keys = np.asarray(keys, np.uint64)
        order = np.argsort(keys, kind="stable")
        self._keys = np.ascontiguousarray(keys[order])
        self._soa = {f: np.ascontiguousarray(a[order])
                     for f, a in soa.items()}

    @classmethod
    def freeze(cls, table: ShardedHostTable) -> "FrozenHostTable":
        """Snapshot a live ShardedHostTable (load/control path — this
        DOES take the shard locks once; the resulting object never
        does)."""
        keys = table.export_keys()
        soa = table.bulk_pull(keys)
        return cls(table.config, keys, soa, seed=table._seed)

    def size(self) -> int:
        return int(len(self._keys))

    def resident_mask(self, keys: np.ndarray) -> np.ndarray:
        """Boolean mask of ``keys`` resident in the frozen planes (pure
        searchsorted probe — lock-free like every read here)."""
        keys = np.asarray(keys, np.uint64)
        if not len(self._keys) or not len(keys):
            return np.zeros(len(keys), bool)
        pos = np.minimum(np.searchsorted(self._keys, keys),
                         len(self._keys) - 1)
        return self._keys[pos] == keys

    def restrict(self, mask: np.ndarray) -> "FrozenHostTable":
        """Copy-on-write row filter: a NEW FrozenHostTable holding only
        the masked rows (shard-ownership / hot-set selection at build
        time) — this object's planes are never written (PB702)."""
        mask = np.asarray(mask, bool)
        return FrozenHostTable(
            self.config, self._keys[mask],
            {f: a[mask] for f, a in self._soa.items()}, seed=self._seed)

    def patched(self, updates: Sequence[Tuple[np.ndarray,
                                              Dict[str, np.ndarray]]]
                ) -> "FrozenHostTable":
        """Copy-on-write upsert chain: a NEW FrozenHostTable equal to
        this one with ``updates`` — ordered ``(keys, soa)`` pairs, later
        entries win — applied over it.  This is the delta-generation
        patch builder (watch_ckpt): the merge happens entirely off the
        serving path on fresh arrays, the live planes are never written
        (lint rule PB702 proves that structurally), and the caller
        publishes the result with the one-reference generation flip.

        Within the concatenated update stream, last-wins dedup falls out
        of a stable sort (equal keys keep arrival order; the tail of
        each equal-run is the newest generation's row — exactly
        ShardedHostTable.load(mode="upsert") replayed in chain order)."""
        ks = [np.asarray(k, np.uint64) for k, _ in updates]
        live = [i for i, k in enumerate(ks) if len(k)]
        if not live:
            return self
        allk = np.concatenate([ks[i] for i in live])
        cat = {f: np.concatenate(
            [np.asarray(updates[i][1][f]) for i in live])
            for f in self._soa}
        order = np.argsort(allk, kind="stable")
        sk = allk[order]
        newest = np.ones(len(sk), bool)
        newest[:-1] = sk[1:] != sk[:-1]
        sel = order[newest]                 # last occurrence per key
        upd_keys = sk[newest]               # sorted unique
        upd_soa = {}
        for f, tmpl in self._soa.items():
            a = cat[f][sel]
            # template dtype wins (the host_table.load from_ckpt rule)
            upd_soa[f] = a.astype(tmpl.dtype) \
                if a.dtype != tmpl.dtype else a
        if len(self._keys):
            pos = np.minimum(np.searchsorted(self._keys, upd_keys),
                             len(self._keys) - 1)
            hit = self._keys[pos] == upd_keys
            keep = np.ones(len(self._keys), bool)
            keep[pos[hit]] = False
            merged_keys = np.concatenate([self._keys[keep], upd_keys])
            merged_soa = {f: np.concatenate([a[keep], upd_soa[f]])
                          for f, a in self._soa.items()}
        else:
            merged_keys, merged_soa = upd_keys, upd_soa
        return FrozenHostTable(self.config, merged_keys, merged_soa,
                               seed=self._seed)

    def lookup_rows(self, keys: np.ndarray) -> Dict[str, np.ndarray]:
        """Rows for ``keys`` — resident rows from the frozen snapshot,
        misses as key-deterministic defaults.  Lock-free by
        construction: every array here is immutable after __init__."""
        keys = np.asarray(keys, np.uint64)
        out = fv.default_rows_keyed(keys, self.mf_dim, self._seed,
                                    self.config.sgd.mf_initial_range,
                                    self.config.sgd.initial_range,
                                    self.expand_dim, self.adam,
                                    self.config.sgd.beta1_decay_rate,
                                    self.config.sgd.beta2_decay_rate,
                                    self.optimizer, self.double_stats)
        if len(self._keys) and len(keys):
            pos = np.searchsorted(self._keys, keys)
            pos = np.minimum(pos, len(self._keys) - 1)
            found = self._keys[pos] == keys
            if found.any():
                src = pos[found]
                for f, arr in self._soa.items():
                    out[f][found] = arr[src]
        return out


class _Generation:
    """One loaded day: the frozen table namespace plus an in-flight
    counter so a hot swap can retire it only after the queries that
    entered it drain (readers grab the generation BEFORE touching its
    tables and exit in a finally)."""

    def __init__(self, tables: Dict[str, FrozenHostTable],
                 generation: int, day: str):
        self.tables = tables
        self.generation = int(generation)
        self.day = day
        self._inflight = 0
        self._cv = lockdep.condition("ps.serving._Generation._cv")

    def enter(self) -> None:
        with self._cv:
            self._inflight += 1

    def exit(self) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify_all()

    def drain(self, timeout: float) -> bool:
        """Wait for in-flight queries to reach zero; False on timeout
        (the straggler still holds its table references — retirement is
        reference-drop, never destruction, so it stays safe)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                self._cv.wait(rem)
        return True


class _LoadTarget:
    """Minimal engine shim for io.checkpoint.load_xbox: a serving-mode
    loader writing into a scratch ShardedHostTable that is frozen and
    dropped right after (the replica never exposes the mutable table)."""

    def __init__(self, config: EmbeddingTableConfig, seed: int):
        self.mode = "serving"
        self.config = config
        self.table = ShardedHostTable(config, seed=seed)
        self.cache = None


class ServingReplica(PSServer):
    """Read-only PSServer serving frozen xbox generations (docstring at
    module top).  Construct with the day-1 dump, then ``hot_swap`` (or
    the ``swap`` wire verb / ``watch_manifest``) to later days.

    Sharded fleet member: ``shard``/``n_shards`` make this replica keep
    only its splitmix64 key range (ps.cluster.owned_mask — the training
    cluster's placement) plus the replicated hot set, filtered at every
    build/patch point.  ``ckpt_root`` builds the initial generation from
    a TrainCheckpoint chain instead of an xbox dump; ``watch_ckpt``
    streams later delta generations in."""

    def __init__(self, config: Optional[EmbeddingTableConfig] = None,
                 xbox_path: Optional[str] = None,
                 tenants: Optional[Sequence[str]] = None,
                 max_inflight: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 day: str = "", generation: int = 1,
                 seed: int = 0, dedup_state=None,
                 shard: int = 0, n_shards: int = 1,
                 ckpt_root: Optional[str] = None,
                 hot_keys: Optional[np.ndarray] = None):
        self._config = config or EmbeddingTableConfig()
        self._seed = seed
        heat.maybe_enable_from_flags()
        if tenants is None:
            tenants = [t.strip() for t in
                       str(flags.get_flags("serve_tenants")).split(",")
                       if t.strip()]
        self.tenants: List[str] = list(tenants) or ["default"]
        self._max_inflight = int(
            flags.get_flags("serve_max_inflight")
            if max_inflight is None else max_inflight)
        self._adm_lock = lockdep.lock("ps.serving.ServingReplica._adm_lock")
        self._tenant_inflight = {t: 0 for t in self.tenants}
        self._swap_lock = lockdep.lock("ps.serving.ServingReplica._swap_lock")
        self._swapping = False
        # optional DeviceRowCache hook: a co-resident forward model's row
        # cache registered here is invalidated at every swap point
        self.cache = None
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        # sharded-fleet placement (set BEFORE the gen-0 build: the build
        # filters rows through _row_mask)
        self._shard = int(shard)
        self.n_shards = max(1, int(n_shards))
        self._hot_override = (None if hot_keys is None else
                              np.sort(np.asarray(hot_keys, np.uint64)))
        self._hot_keys = np.zeros(0, np.uint64)
        self._refresh_hot_keys()
        self._ckpt_root = ckpt_root
        self._applied_head: Optional[int] = None
        self._applied_chain: List[int] = []
        if ckpt_root is not None:
            gen0 = self._build_from_ckpt()
        else:
            gen0 = self._build_generation(xbox_path, day, int(generation))
        self._gen = gen0
        super().__init__(gen0.tables, host=host, port=port,
                         dedup_state=dedup_state, shard=self._shard)
        self.mode = "serving"

    # -- sharded placement ----------------------------------------------------
    def _refresh_hot_keys(self) -> None:
        """Re-resolve the replicated hot set: an explicit ctor override
        wins (deterministic fleets, tests); otherwise the measured top-K
        of the serve.* heat sketches (FLAGS_serving_hot_keys).  Only
        meaningful at n_shards > 1 — a full-table replica already holds
        every row."""
        if self._hot_override is not None:
            self._hot_keys = self._hot_override
            return
        if self.n_shards <= 1:
            self._hot_keys = np.zeros(0, np.uint64)
            return
        k = int(flags.get_flags("serving_hot_keys"))
        self._hot_keys = heat.serving_hot_keys(k)

    def _row_mask(self, keys: np.ndarray) -> np.ndarray:
        """Rows this replica answers for: its splitmix64 ownership range
        plus the replicated hot set (sorted searchsorted probe)."""
        keys = np.asarray(keys, np.uint64)
        mask = ps_cluster.owned_mask(keys, self._shard, self.n_shards)
        hot = self._hot_keys
        if len(hot) and len(keys):
            pos = np.minimum(np.searchsorted(hot, keys), len(hot) - 1)
            mask = mask | (hot[pos] == keys)
        return mask

    def _template_rows(self) -> Dict[str, np.ndarray]:
        """One default row as the field-set/dtype template for checkpoint
        reads (io.checkpoint.read_gen_rows) — the same generator the miss
        path uses, so chain replays conform to serving's row schema."""
        c = self._config
        return fv.default_rows_keyed(
            np.zeros(1, np.uint64), c.embedding_dim, self._seed,
            c.sgd.mf_initial_range, c.sgd.initial_range, c.expand_dim,
            c.sgd.optimizer in ("adam", "shared_adam"),
            c.sgd.beta1_decay_rate, c.sgd.beta2_decay_rate,
            c.sgd.optimizer,
            c.accessor.accessor_type == "ctr_double")

    def _missing_fill(self) -> Dict[str, float]:
        # host_table.load from_ckpt rule: adam beta-power trackers a dump
        # lacks init to the config decay rates, everything else to 0
        return {"_b1p": self._config.sgd.beta1_decay_rate,
                "_b2p": self._config.sgd.beta2_decay_rate}

    def _tables_ns(self, frozen: FrozenHostTable
                   ) -> Dict[str, FrozenHostTable]:
        tables: Dict[str, FrozenHostTable] = {DEFAULT_TABLE: frozen}
        for t in self.tenants:
            tables[f"{t}/{DEFAULT_TABLE}"] = frozen
        return tables

    # -- generation load / swap ----------------------------------------------
    def _build_generation(self, xbox_path: Optional[str], day: str,
                          generation: int) -> _Generation:
        t0 = time.monotonic()
        if xbox_path:
            from paddlebox_tpu_torch.io.checkpoint import load_xbox
            shim = _LoadTarget(self._config, self._seed)
            load_xbox(shim, xbox_path)
            frozen = FrozenHostTable.freeze(shim.table)
        else:
            frozen = FrozenHostTable.freeze(
                ShardedHostTable(self._config, seed=self._seed))
        if self.n_shards > 1:
            frozen = frozen.restrict(self._row_mask(frozen._keys))
        g = _Generation(self._tables_ns(frozen), generation, day)
        stat_set("serving.generation", float(generation))
        stat_observe("serving.load_s", time.monotonic() - t0)
        flight.record("serving_load", generation=generation, day=day,
                      rows=frozen.size(), source=xbox_path or "<empty>")
        return g

    def _frozen_from_chain(self, ck, chain: Sequence[int]
                           ) -> FrozenHostTable:
        """From-scratch chain replay: the base generation's rows (shard-
        filtered) frozen, then every delta generation upserted in chain
        order through the copy-on-write patch builder — the reference
        state every incremental patch must stay bit-identical to."""
        tmpl = self._template_rows()
        fill = self._missing_fill()
        keys, soa = ck.read_gen_rows(chain[0], tmpl, fill)
        mask = self._row_mask(keys)
        frozen = FrozenHostTable(self._config, keys[mask],
                                 {f: a[mask] for f, a in soa.items()},
                                 seed=self._seed)
        updates = []
        for n in chain[1:]:
            dk, dsoa = ck.read_gen_rows(n, tmpl, fill)
            dm = self._row_mask(dk)
            updates.append((dk[dm], {f: a[dm] for f, a in dsoa.items()}))
        return frozen.patched(updates)

    def _build_from_ckpt(self) -> _Generation:
        """Initial generation from a TrainCheckpoint chain (ckpt_root
        mode): head's base + deltas, or an empty generation 0 when
        nothing has committed yet (watch_ckpt picks up the first
        commit)."""
        from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
        ck = TrainCheckpoint(self._ckpt_root)
        head = ck.head()
        if head is None:
            return self._build_generation(None, "", 0)
        t0 = time.monotonic()
        st = ck.gen_state(head)
        chain = [int(c) for c in st.get("chain", [head])]
        frozen = self._frozen_from_chain(ck, chain)
        g = _Generation(self._tables_ns(frozen), head,
                        str(st.get("day_id", "")))
        self._applied_head, self._applied_chain = head, chain
        stat_set("serving.generation", float(head))
        stat_observe("serving.load_s", time.monotonic() - t0)
        flight.record("serving_load", generation=head,
                      day=str(st.get("day_id", "")), rows=frozen.size(),
                      source=f"ckpt:{self._ckpt_root}")
        return g

    def _swap_in(self, new: _Generation,
              drain_timeout: Optional[float] = None
              ) -> Tuple[_Generation, bool]:
        """THE swap, shared by day hot-swaps and streamed delta patches:
        one reference store under _swap_lock (a reader that already did
        ``g = self._gen; g.enter()`` finishes on the old generation's
        frozen tables; every later reader sees the new one whole — zero
        failed requests by construction), cache coherence point, then
        retire the old generation after its in-flight queries drain."""
        with self._swap_lock:
            old = self._gen
            self._gen = new
            self.tables = dict(new.tables)
        cache = self.cache
        if cache is not None:
            # coherence point: any device-resident rows mirror the
            # RETIRED generation now
            cache.invalidate("serving_swap")
        budget = float(flags.get_flags("serve_drain_s")
                       if drain_timeout is None else drain_timeout)
        drained = old.drain(budget)
        if not drained:
            stat_add("serving.swap_drain_timeout")
        stat_set("serving.generation", float(new.generation))
        return old, drained

    def hot_swap(self, xbox_path: str, day: str = "",
                 generation: Optional[int] = None,
                 drain_timeout: Optional[float] = None) -> int:
        """Load ``xbox_path`` as the next generation, flip atomically,
        retire the old generation after its in-flight queries drain.
        Serialized against concurrent swaps; the flip never blocks the
        serving path (readers see either generation whole)."""
        with self._swap_lock:
            if self._swapping:
                raise RuntimeError("hot_swap already in progress")
            self._swapping = True
        try:
            cur = self._gen
            gen_no = (cur.generation + 1 if generation is None
                      else int(generation))
            new = self._build_generation(xbox_path, day, gen_no)
            old, drained = self._swap_in(new, drain_timeout)
        finally:
            with self._swap_lock:
                self._swapping = False
        stat_add("serving.swap")
        flight.record("serving_swap", generation=gen_no, day=day,
                      prev_generation=old.generation, drained=drained)
        return gen_no

    def _manifest_poll(self, fn, what: str):
        """Run a manifest/STATE read tolerating a torn file (a publisher
        mid-rename): retry on decode/IO error with bounded 50ms-doubling
        backoff (FLAGS_serving_manifest_retries attempts), a
        ``manifest_retry`` flight event per retry, and None — the POLL
        abandoned, never the watcher — when the budget runs out."""
        retries = max(0, int(flags.get_flags("serving_manifest_retries")))
        for i in range(retries + 1):
            try:
                return fn()
            except (ValueError, KeyError, OSError) as e:
                # json.JSONDecodeError is a ValueError: the torn-read case
                if i >= retries:
                    stat_add("serving.manifest_giveup")
                    flight.record("manifest_giveup", what=what,
                                  error=type(e).__name__)
                    return None
                stat_add("serving.manifest_retry")
                flight.record("manifest_retry", what=what, attempt=i + 1,
                              error=type(e).__name__)
                if self._watch_stop.wait(min(0.05 * (2 ** i), 0.5)):
                    return None
        return None

    def watch_manifest(self, root: str, poll_s: float = 2.0) -> None:
        """Poll the xbox swap manifest under ``root`` and hot-swap when
        its generation advances past the loaded one (the replica side of
        the train→publish→serve day loop).  A torn manifest read rides
        the bounded-backoff manifest_retry discipline instead of burning
        a whole poll interval."""
        from paddlebox_tpu_torch.io.checkpoint import read_xbox_manifest

        def run() -> None:
            while not self._watch_stop.wait(poll_s):
                try:
                    man = self._manifest_poll(
                        lambda: read_xbox_manifest(root), "xbox_manifest")
                    if man and int(man["generation"]) > self._gen.generation:
                        self.hot_swap(man["path"],
                                      day=str(man.get("day", "")),
                                      generation=int(man["generation"]))
                except Exception:  # noqa: BLE001 — the watcher must outlive a bad day
                    stat_add("serving.watch_errors")

        # pboxlint: disable-next=PB405 -- joined in shutdown() via _watch_stop
        self._watch_thread = threading.Thread(
            target=run, name="pbox-serving-watch", daemon=True)
        self._watch_thread.start()

    # -- streamed delta freshness (TrainCheckpoint chain) --------------------
    def _poll_ckpt(self, ck) -> None:
        """One delta-stream poll: when the committed head advanced, build
        the next plane set OFF the serving path and flip it.

        The cheap common case — the new chain EXTENDS the applied one —
        patches only the unseen delta generations onto the live frozen
        planes (copy-on-write, never a write to them: PB702).  A re-based
        chain (compaction cadence hit, day rollover, or a replica that
        fell behind the GC horizon) rebuilds from the new chain's base;
        that is also where the hot-key replication set re-resolves from
        the current heat sketches."""
        head = self._manifest_poll(ck.head, "ckpt_manifest")
        with self._swap_lock:
            applied_head = self._applied_head
            applied = list(self._applied_chain)
        if head is None or head == applied_head:
            return
        st = self._manifest_poll(lambda: ck.gen_state(head), "ckpt_state")
        if st is None:
            return
        chain = [int(c) for c in st.get("chain", [head])]
        cur = self._gen
        t0 = time.monotonic()
        incremental = (bool(applied) and len(chain) > len(applied)
                       and chain[:len(applied)] == applied)
        if incremental:
            tmpl = self._template_rows()
            fill = self._missing_fill()
            updates = []
            for n in chain[len(applied):]:
                got = self._manifest_poll(
                    lambda g=n: ck.read_gen_rows(g, tmpl, fill),
                    "ckpt_gen_rows")
                if got is None:
                    return              # torn mid-GC read: next poll retries
                dk, dsoa = got
                dm = self._row_mask(dk)
                updates.append(
                    (dk[dm], {f: a[dm] for f, a in dsoa.items()}))
            frozen = cur.tables[DEFAULT_TABLE].patched(updates)
        else:
            self._refresh_hot_keys()
            got = self._manifest_poll(
                lambda: self._frozen_from_chain(ck, chain), "ckpt_chain")
            if got is None:
                return
            frozen = got
        new = _Generation(self._tables_ns(frozen), head,
                          str(st.get("day_id", "")))
        with self._swap_lock:
            if self._swapping:
                return                  # a day hot-swap owns the flip
            self._swapping = True
        try:
            old, drained = self._swap_in(new)
            with self._swap_lock:
                self._applied_head, self._applied_chain = head, chain
        finally:
            with self._swap_lock:
                self._swapping = False
        mt = self._manifest_poll(lambda: ck.gen_mtime(head), "ckpt_mtime")
        staleness = max(0.0, time.time() - mt) if mt is not None else 0.0
        stat_add("serving.delta_flip")
        stat_observe("serving.staleness_s", staleness)
        stat_observe("serving.patch_s", time.monotonic() - t0)
        flight.record("serving_delta_flip", generation=head,
                      prev_generation=old.generation,
                      chain=len(chain), incremental=incremental,
                      rows=frozen.size(), drained=drained,
                      staleness_s=round(staleness, 3))

    def watch_ckpt(self, root: Optional[str] = None,
                   poll_s: Optional[float] = None) -> None:
        """Stream save_pass delta generations from a TrainCheckpoint
        under ``root`` (default: the ctor's ckpt_root): poll the
        committed head every FLAGS_serving_patch_poll_s and flip patched
        plane sets in as it advances — online-learned rows reach
        inference one poll interval after they commit
        (``serving.staleness_s``)."""
        from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
        with self._swap_lock:
            root = self._ckpt_root if root is None else root
            if root is None:
                raise ValueError("watch_ckpt needs a ckpt root (ctor "
                                 "ckpt_root= or the root argument)")
            self._ckpt_root = root
        ck = TrainCheckpoint(root)
        cadence = float(flags.get_flags("serving_patch_poll_s")
                        if poll_s is None else poll_s)

        def run() -> None:
            while not self._watch_stop.wait(cadence):
                try:
                    self._poll_ckpt(ck)
                except Exception:  # noqa: BLE001 — the watcher must outlive a bad gen
                    stat_add("serving.watch_errors")

        # pboxlint: disable-next=PB405 -- joined in shutdown() via _watch_stop
        self._watch_thread = threading.Thread(
            target=run, name="pbox-serving-ckpt-watch", daemon=True)
        self._watch_thread.start()

    def shutdown(self, drain_timeout: float = 5.0) -> None:
        self._watch_stop.set()
        t = self._watch_thread
        if t is not None:
            t.join(timeout=5.0)
        super().shutdown(drain_timeout)

    def kill(self) -> None:
        self._watch_stop.set()      # abrupt death: no join, but no swaps
        super().kill()

    # -- verb surface ---------------------------------------------------------
    def _exec_verb(self, req: Dict) -> Dict:
        cmd = req["cmd"]
        if cmd == "health":
            return self._health_verb()
        if cmd == "swap":
            return self._swap_verb(req)
        if cmd in _READ_VERBS:
            return self._serve_read(req)
        return {"ok": False, "readonly": True,
                "error": f"serving replica: verb {cmd!r} not available "
                         f"on the read-only tier (reads: "
                         f"{sorted(_READ_VERBS)}, control: health/swap)"}

    def _swap_verb(self, req: Dict) -> Dict:
        gen = self.hot_swap(req["path"], day=str(req.get("day", "")),
                            generation=req.get("generation"),
                            drain_timeout=req.get("drain_timeout"))
        return {"ok": True, "generation": gen}

    def _health_verb(self) -> Dict:
        with self._inflight_cv:
            inflight = self._inflight
        g = self._gen
        with self._adm_lock:
            per_tenant = dict(self._tenant_inflight)
        out = {"ok": True, "mode": "serving", "draining": self._draining,
               "inflight": inflight,
               "generation": g.generation, "day": g.day,
               "shard": self._shard, "n_shards": self.n_shards,
               "hot_keys": ",".join(str(int(k)) for k in self._hot_keys),
               "tenants": ",".join(self.tenants),
               "tenant_inflight": per_tenant,
               "tables": ",".join(sorted(g.tables)),
               "stats": {k: float(v)
                         for k, v in stat_snapshot("serving.").items()}}
        hs = heat.summary()
        if hs is not None:
            out["heat"] = hs
        return out

    def _serve_read(self, req: Dict) -> Dict:
        """THE serving read path — lint rule PB701 proves no
        table-mutating verb, shard-lock acquisition, or optimizer call
        is transitively reachable from here."""
        cmd = req["cmd"]
        name = req.get("table") or DEFAULT_TABLE
        tenant = name.split("/", 1)[0] if "/" in name else "default"
        metered = cmd in _METERED_VERBS
        cap = self._max_inflight
        with self._adm_lock:
            cur = self._tenant_inflight.get(tenant)
            if cur is None:
                return {"ok": False,
                        "error": f"unknown tenant {tenant!r} (serving "
                                 f"{sorted(self._tenant_inflight)})"}
            if metered and cap > 0 and cur >= cap:
                stat_add(f"serving.{tenant}.shed")
                return {"ok": False, "shed": True, "tenant": tenant,
                        "error": f"{OVERLOADED}: tenant {tenant!r} at "
                                 f"max inflight {cap}"}
            self._tenant_inflight[tenant] = cur + 1
        stat_set(f"serving.{tenant}.inflight", float(cur + 1))
        g = self._gen
        g.enter()
        t0 = time.monotonic()
        try:
            tab = g.tables.get(name)
            if tab is None:
                return {"ok": False,
                        "error": f"unknown table {name!r} "
                                 f"(have {sorted(g.tables)})"}
            if cmd == "size":
                return {"ok": True, "size": tab.size(),
                        "generation": g.generation}
            if cmd == "list_tables":
                return {"ok": True, "generation": g.generation,
                        "tables": {n: t.size()
                                   for n, t in g.tables.items()}}
            if self.n_shards > 1:
                # misrouted keys would silently serve miss-defaults
                # instead of their owner shard's rows — reject typed so
                # the router bug surfaces, never corrupt
                bad = ~self._row_mask(req["keys"])
                if bad.any():
                    stat_add("serving.not_owner")
                    return {"ok": False, "not_owner": True,
                            "error": f"not_owner: {int(bad.sum())} keys "
                                     f"outside shard {self._shard}/"
                                     f"{self.n_shards} + hot set"}
            if heat.ACTIVE is not None:
                heat.ACTIVE.observe(f"serve.{tenant}", req["keys"])
            if cmd == "forward":
                pooled = self._forward(tab, req["keys"], req["lod"])
                return {"ok": True, "pooled": pooled,
                        "generation": g.generation}
            rows = tab.lookup_rows(req["keys"])
            wd = req.get("wire_dtype")
            if wd and wd != "f32":
                rows = wire.quantize_rows(rows, wd, verb="pull_sparse")
            return {"ok": True, "rows": rows, "generation": g.generation}
        finally:
            g.exit()
            if metered:
                stat_add(f"serving.{tenant}.qps")
                stat_observe(f"serving.{tenant}.latency_s",
                             time.monotonic() - t0)
            with self._adm_lock:
                self._tenant_inflight[tenant] -= 1
                left = self._tenant_inflight[tenant]
            stat_set(f"serving.{tenant}.inflight", float(left))

    @staticmethod
    def _forward(tab: FrozenHostTable, keys: np.ndarray,
                 lod: np.ndarray) -> np.ndarray:
        """Ragged inference pool: per-sample sum over [embed_w | mf] of
        that sample's keys (``lod`` = n+1 offsets into ``keys``) — the
        batched gather+pool kernel shape of sparse-CTR serving."""
        return _pool_rows(tab.lookup_rows(keys), lod)


def _pool_rows(rows: Dict[str, np.ndarray], lod: np.ndarray) -> np.ndarray:
    """THE forward pool kernel, shared by the replica verb and the
    router's client-side pooling over sharded pulls: exact segment sums
    via f64 prefix differences (reduceat mishandles empty segments).
    One implementation is what keeps an N-shard fleet's ``forward``
    bit-identical to a single full-table replica's — the rows are merged
    back into caller key order BEFORE pooling, so the cumsum walks the
    exact same sequence either way (f64 addition is not reorderable)."""
    emb = np.concatenate([rows["embed_w"][:, None], rows["mf"]], axis=1)
    lod = np.asarray(lod, np.int64)
    csum = np.concatenate(
        [np.zeros((1, emb.shape[1]), np.float64),
         np.cumsum(emb.astype(np.float64), axis=0)], axis=0)
    return (csum[lod[1:]] - csum[lod[:-1]]).astype(np.float32)


class ServingRouter:
    """Client-side fan-over across serving replicas: primary-first with
    failover on replica death.  ``pull_sparse``/``forward`` are rid-echo
    idempotent verbs and every replica of one generation answers
    bit-identically, so a failover retry cannot duplicate or corrupt a
    query — exactly one response per query, byte-equal to a
    single-replica run.  Shed (:data:`OVERLOADED` in the error) raises
    the typed :class:`ServingOverload` instead of failing over: the
    fleet is alive, the tenant is just over budget.

    **Sharded mode** (``shard_groups``): group k's replicas own shard k
    of the splitmix64 key space (ServingReplica ``shard=k, n_shards=N``).
    ``pull_sparse`` fans per shard through ONE multi-address
    :class:`PSClient` over the current group primaries — ps/cluster.py's
    partition, shared inflight budget, and order-preserving position
    merge apply wholesale, and group order IS shard order, so the fan
    client's ServerMap routes each key to its owner group.  Keys in the
    router's replicated hot set instead route power-of-two-choices over
    live per-group (outstanding, latency-EWMA) load, spreading one hot
    key's traffic across the whole fleet.  ``forward`` pulls routed and
    pools client-side with the replica's exact kernel (:func:`_pool_rows`)
    — N-shard answers stay bit-identical to a full-table replica.  A
    dead primary rotates to a probed-live group member (supervisors
    restart in place, so primaries also come back)."""

    def __init__(self, addrs: Optional[Sequence[Tuple[str, int]]] = None,
                 tenant: str = "default",
                 shard_groups: Optional[
                     Sequence[Sequence[Tuple[str, int]]]] = None,
                 hot_keys: Optional[np.ndarray] = None,
                 seed: int = 0, **client_kwargs):
        client_kwargs.setdefault("retries", 1)
        client_kwargs.setdefault("deadline", 10.0)
        self.tenant = tenant
        self._client_kwargs = dict(client_kwargs)
        self._lock = lockdep.lock("ps.serving.ServingRouter._lock")
        self._last_generation: Optional[int] = None
        self.sharded = shard_groups is not None
        if not self.sharded:
            if addrs is None:
                raise ValueError("ServingRouter needs addrs or "
                                 "shard_groups")
            self._clients = [PSClient(tuple(a), **client_kwargs)
                             for a in addrs]
            self._dead = [False] * len(self._clients)
            self._primary = 0
            return
        self._groups = [[tuple(a) for a in g] for g in shard_groups]
        if not self._groups or not all(self._groups):
            raise ValueError("shard_groups must be non-empty groups of "
                             "replica addrs (group k = shard k)")
        n = len(self._groups)
        self._gprimary = [0] * n
        self._gdead = [[False] * len(g) for g in self._groups]
        self._gload = [0] * n                 # outstanding hot routes
        self._gewma = [0.0] * n               # hot-route latency EWMA (s)
        self._rng = random.Random(seed)
        self._hot = (np.sort(np.asarray(hot_keys, np.uint64))
                     if hot_keys is not None else np.zeros(0, np.uint64))
        self._gclients = [PSClient(self._groups[g][0], **client_kwargs)
                          for g in range(n)]
        self._fan_client = PSClient(
            [self._groups[g][0] for g in range(n)], **client_kwargs)

    def _order(self) -> List[Tuple[int, PSClient]]:
        with self._lock:
            idxs = list(range(len(self._clients)))
            order = idxs[self._primary:] + idxs[:self._primary]
            return [(i, self._clients[i]) for i in order
                    if not self._dead[i]]

    def _mark_dead(self, idx: int) -> None:
        with self._lock:
            self._dead[idx] = True
            live = [i for i in range(len(self._clients))
                    if not self._dead[i]]
            if live:
                self._primary = live[0]

    def _qualify(self, table: Optional[str]) -> str:
        name = table or DEFAULT_TABLE
        return name if "/" in name else f"{self.tenant}/{name}"

    def _resurrect(self) -> bool:
        """Second-chance probe when the live set is empty: a supervisor
        (launch.ServingReplicaSupervisor) restarts a dead replica IN
        PLACE on the same port, so a dead address can come back.  Each
        dead slot gets a fresh client (the old one's sockets died with
        the peer) and a health probe; responders rejoin the rotation."""
        with self._lock:
            dead = [(i, self._clients[i].addr)
                    for i, d in enumerate(self._dead) if d]
        revived = False
        for i, addr in dead:
            probe = PSClient(addr, **self._client_kwargs)
            try:
                probe.health(timeout=2.0)
            except (ConnectionError, RuntimeError, OSError):
                probe.close()
                continue
            with self._lock:
                self._clients[i].close()
                self._clients[i] = probe
                self._dead[i] = False
            stat_add("serving.router.resurrect")
            flight.record("serving_resurrect", replica=i)
            revived = True
        return revived

    def _fan(self, call, verb: str):
        errs: List[str] = []
        for attempt in range(2):
            for i, c in self._order():
                try:
                    return call(c)
                except ConnectionError as e:
                    self._mark_dead(i)
                    stat_add("serving.router.failover")
                    flight.record("serving_failover", replica=i,
                                  verb=verb, error=type(e).__name__)
                    errs.append(f"replica[{i}]: {e}")
                    continue
                except RuntimeError as e:
                    if OVERLOADED in str(e):
                        stat_add("serving.router.shed")
                        raise ServingOverload(str(e)) from e
                    raise
            if attempt == 0 and not self._resurrect():
                break
        raise ConnectionError(
            f"all serving replicas failed for {verb!r}: "
            + ("; ".join(errs) or "none alive"))

    # -- sharded-mode plumbing ------------------------------------------------
    def _rebuild_fan(self) -> None:
        """Swap the fan client to the CURRENT group primaries (after a
        rotation).  In-flight calls on the old client finish or raise on
        their own sockets; it is closed once replaced."""
        with self._lock:
            prims = [self._groups[g][self._gprimary[g]]
                     for g in range(len(self._groups))]
            old, self._fan_client = self._fan_client, PSClient(
                prims, **self._client_kwargs)
        old.close()

    def _g_recover(self) -> bool:
        """Probe every group: a dead current primary rotates to a
        probed-live member (fresh client — the old one's sockets died
        with the peer); a previously-dead member that answers rejoins.
        Supervisors restart replicas IN PLACE on the same port, so a
        fully-dead group heals on a later pass.  Rebuilds the fan client
        when any primary moved."""
        rotated = False
        for g in range(len(self._groups)):
            with self._lock:
                p = self._gprimary[g]
                addr = self._groups[g][p]
            probe = PSClient(addr, **self._client_kwargs)
            try:
                probe.health(timeout=2.0)
                probe.close()
                with self._lock:
                    self._gdead[g][p] = False
                continue
            except (ConnectionError, RuntimeError, OSError):
                probe.close()
            with self._lock:
                self._gdead[g][p] = True
                members = len(self._groups[g])
            for m in range(members):
                if m == p:
                    continue
                cand = PSClient(self._groups[g][m], **self._client_kwargs)
                try:
                    cand.health(timeout=2.0)
                except (ConnectionError, RuntimeError, OSError):
                    cand.close()
                    with self._lock:
                        self._gdead[g][m] = True
                    continue
                with self._lock:
                    self._gprimary[g] = m
                    self._gdead[g][m] = False
                    old = self._gclients[g]
                    self._gclients[g] = cand
                old.close()
                stat_add("serving.router.failover")
                flight.record("serving_failover", group=g, member=m)
                rotated = True
                break
        if rotated:
            self._rebuild_fan()
        return rotated

    def _g_call(self, call, verb: str):
        """Sharded-mode call wrapper: failover-recover-retry on
        ConnectionError, typed shed passthrough."""
        errs: List[str] = []
        for _ in range(3):
            try:
                return call()
            except ConnectionError as e:
                errs.append(str(e))
                stat_add("serving.router.failover")
                self._g_recover()
                continue
            except RuntimeError as e:
                if OVERLOADED in str(e):
                    stat_add("serving.router.shed")
                    raise ServingOverload(str(e)) from e
                raise
        raise ConnectionError(
            f"sharded serving fleet failed for {verb!r}: "
            + "; ".join(errs))

    def _p2c(self) -> int:
        """Power-of-two-choices over live groups: sample two, take the
        lower (outstanding, latency-EWMA) — the classic load-balance
        result: near-best-of-N balance at O(1) probes."""
        with self._lock:
            live = [g for g in range(len(self._groups))
                    if not all(self._gdead[g])]
            if not live:
                live = list(range(len(self._groups)))
            if len(live) == 1:
                return live[0]
            a, b = self._rng.sample(live, 2)
            ka = (self._gload[a], self._gewma[a])
            kb = (self._gload[b], self._gewma[b])
            return a if ka <= kb else b

    def _hot_route(self, hkeys: np.ndarray,
                   full: str) -> Dict[str, np.ndarray]:
        """Route replicated hot keys to a p2c-chosen group (ANY group
        holds them), tracking per-group outstanding + latency EWMA.  A
        replica whose replicated set lags ours answers not_owner — we
        re-learn the fleet's common set and fall back to owner routing
        (a hot key's owner always serves it)."""
        for _ in range(2):
            g = self._p2c()
            with self._lock:
                self._gload[g] += 1
            t0 = time.monotonic()
            try:
                rows = self._gclients[g].pull_sparse(hkeys, table=full)
                stat_add("serving.router.hot_routed")
                if heat.ACTIVE is not None:
                    heat.ACTIVE.observe_shard(g, len(hkeys))
                return rows
            except ConnectionError:
                stat_add("serving.router.failover")
                self._g_recover()
                continue
            except RuntimeError as e:
                if OVERLOADED in str(e):
                    stat_add("serving.router.shed")
                    raise ServingOverload(str(e)) from e
                if "not_owner" in str(e):
                    stat_add("serving.router.hot_stale")
                    self.refresh_hot_keys()
                    break
                raise
            finally:
                dt = time.monotonic() - t0
                with self._lock:
                    self._gload[g] -= 1
                    self._gewma[g] = 0.8 * self._gewma[g] + 0.2 * dt
        return self._g_call(
            lambda: self._fan_client.pull_sparse(hkeys, table=full),
            "pull_sparse")

    def _pull_sharded(self, keys: np.ndarray,
                      full: str) -> Dict[str, np.ndarray]:
        keys = np.asarray(keys, np.uint64)
        hot = self._hot
        if len(hot) and len(keys):
            p = np.minimum(np.searchsorted(hot, keys), len(hot) - 1)
            hm = hot[p] == keys
        else:
            hm = np.zeros(len(keys), bool)
        hot_pos = np.flatnonzero(hm)
        cold_pos = np.flatnonzero(~hm)
        parts: List[Tuple[np.ndarray, Dict[str, np.ndarray]]] = []
        if len(cold_pos):
            parts.append((cold_pos, self._g_call(
                lambda: self._fan_client.pull_sparse(keys[cold_pos],
                                                     table=full),
                "pull_sparse")))
        if len(hot_pos):
            parts.append((hot_pos, self._hot_route(keys[hot_pos], full)))
        if len(parts) == 1 and len(parts[0][0]) == len(keys):
            return parts[0][1]
        if not parts:
            return self._g_call(
                lambda: self._fan_client.pull_sparse(keys, table=full),
                "pull_sparse")
        # position merge back into caller key order (bit-exact: each row
        # lands at the index its key came from)
        out: Dict[str, np.ndarray] = {}
        for f, a in parts[0][1].items():
            out[f] = np.empty((len(keys),) + a.shape[1:], a.dtype)
        for pos, rows in parts:
            for f, a in rows.items():
                out[f][pos] = a
        return out

    def refresh_hot_keys(self) -> int:
        """Adopt the intersection of the live groups' replicated hot
        sets from fleet health (a key may route anywhere only when EVERY
        group replicates it).  Returns the adopted set size; keeps the
        current set when any group is unreachable (a partial view could
        adopt keys a silent group lacks)."""
        if not self.sharded:
            return 0
        arrs: List[np.ndarray] = []
        for h in self.health():
            if h is None:
                return len(self._hot)
            s = str(h.get("hot_keys", ""))
            arrs.append(np.array([int(x) for x in s.split(",") if x],
                                 np.uint64))
        common = arrs[0]
        for a in arrs[1:]:
            common = np.intersect1d(common, a)
        with self._lock:
            self._hot = common.astype(np.uint64)
        stat_set("serving.router.hot_keys", float(len(common)))
        return len(common)

    # -- verbs ---------------------------------------------------------------
    def pull_sparse(self, keys: np.ndarray,
                    table: Optional[str] = None) -> Dict[str, np.ndarray]:
        full = self._qualify(table)
        if self.sharded:
            return self._pull_sharded(keys, full)
        return self._fan(lambda c: c.pull_sparse(keys, table=full),
                         "pull_sparse")

    def forward(self, keys: np.ndarray, lod: np.ndarray,
                table: Optional[str] = None) -> np.ndarray:
        full = self._qualify(table)
        if self.sharded:
            # routed pull (owner shards + p2c hot routes), then the
            # replica's exact pool kernel client-side: bit-identical to
            # one full-table replica's forward
            return _pool_rows(self._pull_sharded(keys, full), lod)
        return self._fan(lambda c: c.forward(keys, lod, table=full),
                         "forward")

    def health(self) -> List[Optional[Dict]]:
        """Per-replica health (None for dead/unreachable replicas) —
        mixed ``generation`` values across live replicas expose a
        half-finished fleet hot-swap.  Sharded mode reports one entry
        per GROUP (its current primary)."""
        if self.sharded:
            for attempt in range(2):
                out: List[Optional[Dict]] = []
                for g in range(len(self._groups)):
                    try:
                        out.append(self._gclients[g].health(timeout=2.0))
                    except (ConnectionError, RuntimeError, OSError):
                        out.append(None)
                if attempt == 0 and any(h is None for h in out) \
                        and self._g_recover():
                    continue            # a primary rotated: re-probe once
                return out
            return out
        with self._lock:
            any_dead = any(self._dead)
        if any_dead:
            self._resurrect()
        out = []
        for i, c in enumerate(self._clients):
            with self._lock:
                dead = self._dead[i]
            if dead:
                out.append(None)
                continue
            try:
                out.append(c.health(timeout=2.0))
            except (ConnectionError, RuntimeError, OSError):
                self._mark_dead(i)
                out.append(None)
        return out

    def generations(self) -> List[int]:
        """Distinct loaded generations across live replicas (len > 1 ⇒
        a hot-swap is in flight somewhere)."""
        gens = {int(h["generation"]) for h in self.health()
                if h and "generation" in h}
        return sorted(gens)

    def observe_generation(self) -> bool:
        """Client-side hot-swap coherence point: when the fleet's max
        generation advances past the last one seen, drop every client's
        learned row-width estimates (a new day's dump may change row
        widths; a stale estimate would mis-chunk the first pull).
        Returns True when an advance was observed."""
        gens = self.generations()
        if not gens:
            return False
        head = gens[-1]
        with self._lock:
            last = self._last_generation
            self._last_generation = head
        if last is not None and head > last:
            for c in self._all_clients():
                c.invalidate_row_width()
            stat_add("serving.router.gen_advance")
            return True
        return False

    def _all_clients(self) -> List[PSClient]:
        if self.sharded:
            with self._lock:
                return [self._fan_client] + list(self._gclients)
        return list(self._clients)

    def close(self) -> None:
        for c in self._all_clients():
            c.close()
