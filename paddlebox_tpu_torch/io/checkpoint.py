"""Checkpoint / resume orchestration — generation-chained and crash-safe.

Port of ``paddlebox_tpu/io/checkpoint.py`` (≙ the reference's two-tier
day/pass persistence: sparse SaveBase/SaveDelta + dense
save_persistables).  One ``TrainCheckpoint`` atomically captures {dense
weights, dense optimizer state, day/pass cursor} next to the sparse table
dump, so a killed job resumes mid-day (``resume()`` → last completed
pass).

Layout (immutable generations + one atomic pointer)::

  <root>/MANIFEST.json        {"generation": n, "shards": N[, "ps_epoch",
                              "ps_addrs"]} — the ONLY mutable file,
                              swapped via tmp+rename (_atomic_write)
  <root>/gen-<n>/STATE.json   {generation, kind, chain, day_id, pass_id,
                              phase, rows, shards, ps_epoch, ...extra}
  <root>/gen-<n>/sparse/…     per-shard npz: the full table (kind=base)
                              or just the rows the pass wrote (kind=delta);
                              through a remote table over an N-shard PS
                              fleet, one ``shard-<k:03d>/`` dir a shard,
                              each server's ``DEDUP.bin`` beside its rows
  <root>/gen-<n>/dense.pt     ``torch.save`` of {"model": the trainer's
                              module state_dict, "opt": its dense
                              optimizer's state_dict}; tensors only, so
                              ``torch.load(weights_only=True)`` reads it
  <root>/XBOX_MANIFEST.json   the serving day pointer {generation, path,
                              day} (publish_xbox_manifest)

MANIFEST, STATE and the sparse files are the JAX package's layout, so the
sparse half of a generation loads into either package's table
(``load_table``).  The dense half is each package's own: the JAX package
writes flax msgpack.

The xbox half (``save_xbox``, ``dump_table_xbox``, ``load_xbox``, the
swap manifest) is a copy of the JAX package's, with the native TSV
writer/parser of ``native/dump_writer.cc``: either package reads the
other's dumps, and both writers give the same bytes.  Only the dense
half imports torch (inside the functions that need it), so the host
tier — a PS server's ``dump_xbox`` verb, a serving replica's loader and
its delta watcher — uses this module without loading torch.

Crash-safety: a generation is assembled under ``gen-<n>.tmp``, renamed to
``gen-<n>``, and only THEN does MANIFEST advance.  A crash at any point
leaves either the old MANIFEST pointing at a complete old generation
(tmp/orphan dirs are ignored and reclaimed by the next save's GC) or the
new MANIFEST pointing at a complete new one.

Incremental cost: ``save_pass`` writes a *delta* generation holding only
the rows the finished pass wrote (``engine._last_written``).  Every
``FLAGS_ckpt_every_passes`` generations the chain is compacted into a
fresh base, and the first save of a new day is a base; ``FLAGS_ckpt_keep``
bounds retained history (retain-K GC never collects a generation a
surviving chain still references).

Resume walks the head generation's chain: load the base wholesale, upsert
each delta in order, then restore the dense weights, the optimizer state
(moments and step counts, on the trainer's device, into the same
``Parameter`` objects) and the cursors from the head.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import time
import warnings
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe, stat_set

if TYPE_CHECKING:
    from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine

flags.define_flag(
    "ckpt_keep", 3,
    "retain-K checkpoint GC: keep the newest K committed generations "
    "(plus every older generation a surviving delta chain references)")
flags.define_flag(
    "ckpt_every_passes", 8,
    "base-compaction cadence: after this many generations on one delta "
    "chain, the next per-pass save writes a full base instead of a delta")
flags.define_flag(
    "auto_resume", 0,
    "crash-recovery budget for fleet.train_passes: on a trainer-side "
    "failure, roll back to the last committed generation and re-drive "
    "the partial pass, at most this many times per call (0 disables)")
flags.define_flag(
    "ckpt_dir", "",
    "default TrainCheckpoint root for fleet.train_passes — when set, "
    "train_passes saves a delta generation after every pass and "
    "auto-resume restores from here")

MANIFEST = "MANIFEST.json"
DENSE = "dense.pt"


def _atomic_write(path: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class TrainCheckpoint:
    """Generation-chained checkpoint store (see module docstring).

    ``save``       full base generation (table mode="all" + dense + cursor)
    ``save_pass``  incremental per-pass generation: delta rows only, with
                   periodic base compaction
    ``resume``     restore table (base + delta chain), dense, cursors
    """

    def __init__(self, root: str, keep: Optional[int] = None,
                 base_every: Optional[int] = None):
        self.root = root
        self.keep = max(1, int(flags.get_flags("ckpt_keep")
                               if keep is None else keep))
        self.base_every = max(1, int(flags.get_flags("ckpt_every_passes")
                                     if base_every is None else base_every))
        os.makedirs(root, exist_ok=True)

    # -- layout helpers ------------------------------------------------------
    def _gen_dir(self, n: int) -> str:
        return os.path.join(self.root, f"gen-{n:06d}")

    def _manifest(self) -> Optional[int]:
        path = os.path.join(self.root, MANIFEST)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            gen = json.load(f).get("generation")
        # a membership-only manifest (commit_membership before any
        # checkpoint ever committed) carries generation: null
        return None if gen is None else int(gen)

    def _sparse_dir(self, n: int) -> str:
        return os.path.join(self._gen_dir(n), "sparse")

    def _state(self, n: int) -> Dict:
        with open(os.path.join(self._gen_dir(n), "STATE.json")) as f:
            return json.load(f)

    def _committed(self) -> List[int]:
        """Committed generation numbers ≤ the manifest head, ascending.
        Orphans past the head (a crash between dir rename and pointer
        swap) are excluded — they never became reachable."""
        head = self._manifest()
        if head is None:
            return []
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("gen-") or name.endswith(".tmp"):
                continue
            try:
                n = int(name[4:])
            except ValueError:
                continue
            if n <= head and \
                    os.path.exists(os.path.join(self.root, name,
                                                "STATE.json")):
                out.append(n)
        return sorted(out)

    # -- save ----------------------------------------------------------------
    def save(self, engine: BoxPSEngine, trainer,
             extra: Optional[Dict] = None) -> int:
        """Full checkpoint: a new BASE generation.  Returns its number."""
        return self._save_generation(engine, trainer, extra, kind="base")

    def save_pass(self, engine: BoxPSEngine, trainer,
                  extra: Optional[Dict] = None) -> int:
        """Incremental end-of-pass checkpoint: a DELTA generation holding
        only the rows the finished pass wrote (cost ∝ the pass delta).
        Falls back to a base when there is no parent chain, when the
        chain hit the compaction cadence, or when the engine has no
        written-keys record yet."""
        kind = "delta"
        head = self._manifest()
        keys = getattr(engine, "_last_written", None)
        if head is None or keys is None or len(keys) == 0:
            kind = "base"
        else:
            st = self._state(head)
            chain = st.get("chain", [head])
            # a day rollover (end_day) decays EVERY row but a delta only
            # captures the pass's written rows — chaining across the
            # boundary would roll untouched rows back to their undecayed
            # previous-day values, so the first save of a new day is a
            # full base
            if st.get("day_id") != engine.day_id \
                    or len(chain) >= self.base_every:
                kind = "base"
        return self._save_generation(engine, trainer, extra, kind=kind,
                                     delta_keys=None if kind == "base"
                                     else keys)

    def _save_generation(self, engine: BoxPSEngine, trainer,
                         extra: Optional[Dict], kind: str,
                         delta_keys: Optional[np.ndarray] = None) -> int:
        t0 = time.monotonic()
        head = self._manifest()
        gen = 0 if head is None else head + 1
        if kind == "base" or head is None:
            chain = [gen]
        else:
            chain = list(self._state(head).get("chain", [head])) + [gen]
        tmpdir = self._gen_dir(gen) + ".tmp"
        if os.path.exists(tmpdir):          # leftover of a crashed save
            shutil.rmtree(tmpdir)
        os.makedirs(tmpdir)

        sparse_dir = os.path.join(tmpdir, "sparse")
        if kind == "base":
            rows = engine.table.save(sparse_dir, mode="all")
        else:
            rows = engine.table.save(sparse_dir, mode="rows",
                                     keys=delta_keys)
            stat_add("ckpt.delta_rows", float(rows))
        if faults.ACTIVE is not None:
            # mid-WAL kill point: sparse shard files are down but the
            # generation is not yet assembled — a crash here must leave
            # the previous generation loadable
            faults.on_lifecycle("ckpt_sparse")

        import torch
        torch.save({"model": trainer.model.state_dict(),
                    "opt": trainer.dense_opt.state_dict()},
                   os.path.join(tmpdir, DENSE))

        # cluster topology rides in the generation record: at n > 1 the
        # sparse dir holds per-shard ``shard-<k:03d>/`` subdirs (the
        # client's save fan-out, ps/cluster.cluster_save) and THIS
        # MANIFEST advance below is the single cluster-wide commit point
        # naming all N shard heads at once
        smap = getattr(engine.table, "server_map", None)
        n_shards = getattr(smap, "n", 1)
        state = {"generation": gen, "kind": kind, "chain": chain,
                 "day_id": engine.day_id, "pass_id": engine.pass_id,
                 "phase": engine.phase, "rows": int(rows),
                 "shards": int(n_shards),
                 "ps_epoch": int(getattr(smap, "epoch", 0) or 0)}
        if extra:
            state.update(extra)
        with open(os.path.join(tmpdir, "STATE.json"), "w") as f:
            f.write(json.dumps(state))

        final = self._gen_dir(gen)
        if os.path.exists(final):
            # an orphan from a crash between dir rename and pointer swap
            # reused this number — it was never reachable, reclaim it
            shutil.rmtree(final)
        os.replace(tmpdir, final)
        if faults.ACTIVE is not None:
            # the crash window the MANIFEST swap closes: generation dir
            # complete, pointer not yet advanced → old generation loads
            faults.on_lifecycle("ckpt_commit")
        man = {"generation": gen, "shards": int(n_shards)}
        if smap is not None and getattr(smap, "epoch", 0):
            # elastic fleet: the manifest names the committed membership
            # alongside the generation head — a restart reads BOTH from
            # one atomically-swapped pointer (ps/reshard.py rollback)
            man["ps_epoch"] = int(smap.epoch)
            man["ps_addrs"] = [[h, int(p)] for h, p in smap.addrs]
        _atomic_write(os.path.join(self.root, MANIFEST),
                      json.dumps(man).encode())
        dt = time.monotonic() - t0
        stat_observe("ckpt.save_s", dt)
        stat_set("ckpt.generation", float(gen))
        flight.record("ckpt_commit", generation=gen, gen_kind=kind,
                      rows=int(rows), chain_len=len(chain),
                      save_s=round(dt, 3))
        self._gc()
        return gen

    def _gc(self) -> None:
        """Retain-K GC over committed generations: keep the newest
        ``keep`` heads plus every generation their chains reference;
        remove the rest (and stale .tmp assembly dirs)."""
        committed = self._committed()
        heads = committed[-self.keep:]
        keep: set = set()
        for h in heads:
            keep.update(self._state(h).get("chain", [h]))
        removed = []
        for n in committed:
            if n not in keep:
                shutil.rmtree(self._gen_dir(n), ignore_errors=True)
                removed.append(n)
        for name in os.listdir(self.root):
            if name.startswith("gen-") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        if removed:
            stat_add("ckpt.gc_removed", float(len(removed)))
            flight.record("ckpt_gc", removed=len(removed),
                          kept=len(keep))

    # -- resume --------------------------------------------------------------
    def load_table(self, table, shard: Optional[int] = None
                   ) -> Optional[int]:
        """Table-only restore (the PSServerSupervisor's reload path,
        launch.py): walk the head generation's chain into ``table`` —
        base load, then delta upserts — without touching any trainer
        state.  ``shard`` narrows the walk to one cluster shard's
        ``shard-<k:03d>/`` subdirs (a restarting shard reloads ONLY its
        own rows + DEDUP.bin).  A server-side table also recovers its
        dedup window here (the load verb restores DEDUP.bin,
        ps/service.py).  Returns the head generation number, or None when
        empty."""
        head = self._manifest()
        if head is None:
            return None
        chain = self._state(head).get("chain", [head])

        def sparse_dir(n: int) -> str:
            p = self._sparse_dir(n)
            return p if shard is None else os.path.join(
                p, f"shard-{shard:03d}")

        table.load(sparse_dir(chain[0]))
        for n in chain[1:]:
            table.load(sparse_dir(n), mode="upsert")
        return head

    # -- generation readers: a read-only face of the chain walk ------------
    def head(self) -> Optional[int]:
        """Committed head generation number (MANIFEST pointer), or None
        when nothing has ever committed."""
        return self._manifest()

    def gen_state(self, n: int) -> Dict:
        """STATE dict of committed generation ``n`` (kind/chain/day_id/
        pass_id/rows) — stable once the generation dir is renamed in."""
        return self._state(n)

    def gen_mtime(self, n: int) -> float:
        """Commit wall-time of generation ``n`` (its STATE.json mtime) —
        the freshness basis for a serving replica's staleness."""
        return os.path.getmtime(
            os.path.join(self._gen_dir(n), "STATE.json"))

    def gen_sparse_dirs(self, n: int) -> List[str]:
        """Sparse dump dirs of generation ``n``: the flat ``sparse/`` dir
        for a single-table save, else its per-cluster-shard
        ``shard-<k:03d>/`` subdirs (cluster_save layout) — the trainer's
        shard count need not match a reader's, so readers walk every
        subdir and re-filter by key hash themselves."""
        base = self._sparse_dir(n)
        subs = sorted(
            os.path.join(base, d) for d in os.listdir(base)
            if d.startswith("shard-")
            and os.path.isdir(os.path.join(base, d))) \
            if os.path.isdir(base) else []
        return subs or [base]

    def read_gen_rows(self, n: int, template: Dict[str, np.ndarray],
                      missing_fill: Optional[Dict[str, float]] = None
                      ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """All rows of generation ``n`` as ``(keys, soa)`` arrays, field
        set conformed to ``template`` (a one-row dict giving each field's
        dtype + trailing shape — fv.default_rows_keyed output works).

        Mirrors ShardedHostTable.load's checkpoint-compat rules, so a
        chain replay lands the same state a table load does: fields the
        dump lacks init like fresh rows (0, or ``missing_fill``'s value
        for fields whose name ends with one of its suffixes — the adam
        beta-power trackers), and the template dtype wins over the
        dump's.  Keys are unique within one generation (table keys are
        unique per shard and shards partition the key space), so callers
        may apply the rows order-free within a generation and in chain
        order across them."""
        keys_parts: List[np.ndarray] = []
        soa_parts: Dict[str, List[np.ndarray]] = {f: [] for f in template}
        for d in self.gen_sparse_dirs(n):
            if not os.path.isdir(d):
                continue
            for fname in sorted(os.listdir(d)):
                if not fname.endswith(".shard.npz"):
                    continue
                with np.load(os.path.join(d, fname)) as z:
                    part_keys = np.asarray(z["keys"], np.uint64)
                    if not len(part_keys):
                        continue
                    keys_parts.append(part_keys)
                    for f, tmpl in template.items():
                        tmpl = np.asarray(tmpl)
                        if f in z.files:
                            arr = z[f]
                            if arr.dtype != tmpl.dtype:
                                arr = arr.astype(tmpl.dtype)
                        else:
                            fill = next(
                                (v for suf, v in (missing_fill
                                                  or {}).items()
                                 if f.endswith(suf)), 0.0)
                            arr = np.full(
                                (len(part_keys),) + tmpl.shape[1:],
                                fill, tmpl.dtype)
                        soa_parts[f].append(arr)
        if not keys_parts:
            empty = {f: np.zeros((0,) + np.asarray(t).shape[1:],
                                 np.asarray(t).dtype)
                     for f, t in template.items()}
            return np.zeros(0, np.uint64), empty
        return (np.concatenate(keys_parts),
                {f: np.concatenate(parts)
                 for f, parts in soa_parts.items()})

    def read_state(self) -> Optional[Dict]:
        """The head generation's STATE dict (day/pass cursor + any
        ``extra`` the saver embedded) WITHOUT loading any table or
        trainer state."""
        head = self._manifest()
        if head is None:
            return None
        return self._state(head)

    def _load_dense(self, n: int, trainer) -> None:
        """Generation ``n``'s dense half into the trainer's own module and
        optimizer: ``load_state_dict`` copies into the existing
        ``Parameter`` objects (the optimizer stays bound to them) and
        moves the moments onto the parameters' device; Adam's step counts
        stay where Adam keeps them."""
        import torch
        dense = torch.load(os.path.join(self._gen_dir(n), DENSE),
                           map_location="cpu", weights_only=True)
        trainer.model.load_state_dict(dense["model"])
        trainer.dense_opt.load_state_dict(dense["opt"])

    def restore_dense(self, trainer) -> Optional[int]:
        """Dense-only restore (params + optimizer state) from the head
        generation, leaving the table as it is.  Returns the head
        generation, or None when empty."""
        head = self._manifest()
        if head is None:
            return None
        self._load_dense(head, trainer)
        stat_add("ckpt.dense_restores")
        return head

    def resume(self, engine: BoxPSEngine, trainer) -> Optional[Dict]:
        """Restore everything from the newest committed generation (base
        load + delta-chain upserts); returns the head STATE dict or None
        when the root holds no checkpoint."""
        head = self._manifest()
        if head is None:
            return None
        t0 = time.monotonic()
        state = self._state(head)
        chain = state.get("chain", [head])
        flight.record("resume_begin", generation=head,
                      chain_len=len(chain))
        if hasattr(engine, "reset_feed_state"):
            # abandon any half-open feed pass / pending working set from
            # the crashed run before overwriting the table under it
            engine.reset_feed_state()
        engine.table.load(self._sparse_dir(chain[0]))
        for n in chain[1:]:
            engine.table.load(self._sparse_dir(n), mode="upsert")
        if getattr(engine, "cache", None) is not None:
            # the table just rolled back under the device cache —
            # reset_feed_state above already dropped it once, but the
            # chain load is the authoritative coherence point: every
            # resident row is now potentially stale, rebuild cold
            engine.cache.invalidate("resume")
        engine.day_id = state.get("day_id")
        engine.pass_id = state.get("pass_id", 0)
        engine.phase = state.get("phase", 1)
        self._load_dense(head, trainer)
        dt = time.monotonic() - t0
        stat_observe("ckpt.restore_s", dt)
        stat_set("ckpt.restore_gen", float(head))
        flight.record("resume_ok", generation=head,
                      pass_id=engine.pass_id, restore_s=round(dt, 3))
        return state


def commit_membership(root: str, server_map) -> bool:
    """Record a committed PS membership (epoch + addresses) in the
    checkpoint MANIFEST — the durable half of the reshard cutover
    (ps/reshard.py phase 5).  Atomic pointer swap like every MANIFEST
    advance: a crash before this call leaves the OLD membership in the
    manifest, and a restart resharding-on-load against it is the whole
    rollback story.  Epoch-guarded (a stale/duplicate commit no-ops);
    preserves the generation head untouched.  Returns True when the
    manifest advanced."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, MANIFEST)
    man: Dict = {"generation": None}
    if os.path.exists(path):
        with open(path) as f:
            man = json.load(f)
    if int(man.get("ps_epoch", 0)) >= int(server_map.epoch):
        return False
    man["ps_epoch"] = int(server_map.epoch)
    man["ps_addrs"] = [[h, int(p)] for h, p in server_map.addrs]
    man["shards"] = int(server_map.n)
    _atomic_write(path, json.dumps(man).encode())
    flight.record("membership_commit", epoch=int(server_map.epoch),
                  shards=int(server_map.n))
    return True


def read_membership(root: str):
    """The committed PS membership from ``<root>/MANIFEST.json`` as a
    ServerMap, or None when the manifest is absent or membership-less
    (pre-elastic checkpoints)."""
    from paddlebox_tpu_torch.ps import cluster as ps_cluster
    path = os.path.join(root, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        man = json.load(f)
    addrs = man.get("ps_addrs")
    if not addrs:
        return None
    return ps_cluster.make_server_map([tuple(a) for a in addrs],
                                      epoch=int(man.get("ps_epoch", 0)))


def save_xbox(engine: BoxPSEngine, path: str, base: bool = True) -> int:
    """Serving-model dump (≙ the "xbox" base/delta format written by
    SaveBase/SaveDelta, box_wrapper.cc:1286): one line per surviving
    feature — key \\t show \\t click \\t embed_w \\t mf...  Quantization of
    embedx (quant_bits) applies here when configured.

    A local engine table dumps in-process (dump_table_xbox).  An engine
    running against a remote PS — including an N-way sharded cluster —
    asks each server to dump ITS rows server-side (the ``dump_xbox``
    verb) into per-shard part files, then concatenates them; row
    ownership is disjoint by the ServerMap, so the concatenation is the
    exact union and the downstream last-wins load semantics are
    unaffected by part order.
    """
    acc = engine.config.accessor
    qbits = engine.config.quant_bits
    table = engine.table
    if not hasattr(table, "_shards") and hasattr(table, "client"):
        return _save_xbox_remote(
            table.client, getattr(table, "table", None), path, base,
            float(acc.base_threshold), float(acc.delta_threshold),
            int(qbits or 0))
    return dump_table_xbox(table, path, base=base,
                           base_threshold=float(acc.base_threshold),
                           delta_threshold=float(acc.delta_threshold),
                           quant_bits=int(qbits or 0))


def _save_xbox_remote(client, table_name: Optional[str], path: str,
                      base: bool, base_threshold: float,
                      delta_threshold: float, quant_bits: int) -> int:
    """Fan the xbox dump out across the PS cluster: every shard writes a
    ``<path>.shard-<k:03d>`` part server-side (itself tmp+rename atomic),
    then the parts concatenate under ``path + ".tmp"`` and rename into
    place — the published file appears atomically, never partially."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    parts = []
    for shard in range(getattr(client, "n_shards", 1)):
        part = f"{path}.shard-{shard:03d}"
        resp = client._call(
            {"cmd": "dump_xbox", "path": part, "base": base,
             "base_threshold": base_threshold,
             "delta_threshold": delta_threshold,
             "quant_bits": quant_bits, "table": table_name},
            shard=shard, timeout=120)
        n += int(resp["dumped"])
        parts.append(part)
    tmp_path = path + ".tmp"
    with open(tmp_path, "wb") as out:
        for part in parts:
            with open(part, "rb") as fh:
                shutil.copyfileobj(fh, out)
            os.remove(part)
    os.replace(tmp_path, path)
    return n


def dump_table_xbox(table, path: str, base: bool = True,
                    base_threshold: float = 0.0,
                    delta_threshold: float = 0.0,
                    quant_bits: int = 0) -> int:
    """Dump one LOCAL ShardedHostTable in the xbox TSV format — the body
    shared by the in-process save_xbox path and the server-side
    ``dump_xbox`` verb (each cluster shard dumps its own rows).

    Row selection/masking is vectorized per shard and formatting runs in
    the native TSV writer (native/dump_writer.cc, ≙ the reference's
    native dump IO through PaddleFileMgr) with a per-row Python fallback.
    The dump assembles under ``path + ".tmp"`` and renames into place so
    a crashed dump never leaves a half-written file at the final path
    (PB502 tmp+rename discipline).
    """
    from paddlebox_tpu_torch.native import dump_writer
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    qbits = quant_bits
    n = 0
    tmp_path = path + ".tmp"
    fh = None if dump_writer.available() else open(tmp_path, "w")
    try:
        for shard in table._shards:
            with shard.lock:
                soa = shard.soa
                score = table._score(soa)
                keep = (score >= base_threshold) if base else \
                    (np.abs(soa["delta_score"]) >= delta_threshold)
                idx = np.nonzero(keep)[0]
                if not len(idx):
                    continue
                keys = shard.keys[idx]
                show = soa["show"][idx]
                click = soa["click"][idx]
                embed_w = soa["embed_w"][idx]
                # uncreated embedx serves zeros in training (pull_sparse
                # masks by mf_size) — dump the SAME values or the serving
                # side would see the random candidate init
                mf = np.where((soa["mf_size"][idx] > 0)[:, None],
                              soa["mf"][idx], np.float32(0))
                if qbits:
                    scale = (1 << (qbits - 1)) - 1
                    mf = np.round(mf * scale) / scale
            if fh is None:
                dump_writer.dump_rows(tmp_path, append=n > 0, keys=keys,
                                      show=show, click=click,
                                      embed_w=embed_w, mf=mf)
            else:
                for i in range(len(keys)):
                    vals = " ".join(f"{v:.6g}" for v in mf[i])
                    fh.write(f"{keys[i]}\t{show[i]:.6g}\t{click[i]:.6g}\t"
                             f"{embed_w[i]:.6g}\t{vals}\n")
            n += len(idx)
        if fh is None and n == 0:
            open(tmp_path, "w").close()  # empty dump still creates the file
    finally:
        if fh is not None:
            fh.close()
    os.replace(tmp_path, path)
    return n


def load_xbox(engine: BoxPSEngine, path: str) -> np.ndarray:
    """Serving-side read-back of an xbox dump — the loader the reference
    keeps in its serving stack (the dump of SaveBase/SaveDelta,
    box_wrapper.cc:1286, is what the online predictor consumes).

    Writes the dumped rows into the engine's host table (optimizer state
    zero-initialized — serving never pushes) and returns the loaded keys;
    the caller then runs the normal pass lifecycle over them and
    optionally `engine.freeze_for_serving()` for int16 embedx pulls:

        keys = load_xbox(engine, path)
        engine.begin_feed_pass(); engine.add_keys(keys)
        engine.end_feed_pass(); engine.begin_pass()
        engine.freeze_for_serving()
    """
    if getattr(engine, "mode", "train") != "serving":
        warnings.warn(
            "load_xbox on a training-mode engine: the xbox dump re-derives "
            "mf_size as any(mf != 0), so a created row whose embedx "
            "trained to exactly all zeros round-trips as uncreated and "
            "would re-initialize on training resume.  Use load_checkpoint "
            "(TrainCheckpoint.resume) for training resume, or build the "
            "engine with mode='serving' for a serving path.",
            UserWarning, stacklevel=2)
    from paddlebox_tpu_torch.native import dump_writer
    d = engine.config.embedding_dim
    native = dump_writer.load_rows(path, d)
    if native is not None:
        keys, shows, clicks, ws_, mf_mat = native
    else:
        keys, shows, clicks, ws_, mfs = [], [], [], [], []
        # Parity contract: for WRITER-PRODUCED files (save_xbox / the
        # native dump_writer — plain decimal, single-tab-separated), this
        # fallback and pbox_load_xbox give the same verdict and the same
        # reported row index.  Hand-edited exotica (hex floats, '_' digit
        # grouping, whitespace-padded fields) are outside that contract
        # and may parse differently between the two.
        with open(path) as f:
            lineno = 0      # counts parsed (non-empty) rows, exactly like
            for line in f:  # the native parser's -(row+1) — same file,
                # same reported index on native and fallback hosts
                parts = line.rstrip("\n").split("\t")
                if not line.strip():
                    continue
                lineno += 1
                if len(parts) != 5:
                    raise ValueError(
                        f"malformed xbox line {lineno}: {line[:80]!r}")
                try:
                    key = int(parts[0])
                    if not 0 <= key < 1 << 64:
                        raise ValueError("key out of uint64 range")
                    stats = [float(parts[1]), float(parts[2]),
                             float(parts[3])]
                    with np.errstate(over="ignore"):  # inf rejected below
                        mf = (np.array(parts[4].split(), np.float32)
                              if parts[4] else np.zeros((0,), np.float32))
                except ValueError as e:
                    raise ValueError(
                        f"malformed xbox line {lineno}: {line[:80]!r}"
                    ) from e
                keys.append(key)
                # reject overflow-to-inf exactly like the native parser
                # (pbox_load_xbox), so the same file parses — or fails —
                # identically on fallback-only hosts
                if not all(map(math.isfinite, stats)) or \
                        not np.all(np.isfinite(mf)):
                    raise ValueError(
                        f"malformed xbox line {lineno}: non-finite value "
                        f"in {line[:80]!r}")
                shows.append(stats[0])
                clicks.append(stats[1])
                ws_.append(stats[2])
                if len(mf) != d:
                    raise ValueError(
                        f"malformed xbox line {lineno}: mf width "
                        f"{len(mf)} != table dim {d}")
                mfs.append(mf)
        mf_mat = (np.stack(mfs) if mfs
                  else np.zeros((0, d), np.float32))
    keys = np.asarray(keys, np.uint64)
    if not len(keys):
        return keys
    shows = np.asarray(shows, np.float32)
    clicks = np.asarray(clicks, np.float32)
    ws_ = np.asarray(ws_, np.float32)
    # dedupe LAST-wins: a concatenated base+delta file naturally repeats
    # keys, and the table's upsert contract requires unique keys per call
    # (host_table.py — duplicates would double-insert)
    last = len(keys) - 1 - np.unique(keys[::-1], return_index=True)[1]
    if len(last) != len(keys):
        sel = np.sort(last)
        keys = keys[sel]
        shows, clicks, ws_ = shows[sel], clicks[sel], ws_[sel]
        mf_mat = mf_mat[sel]
    rows = engine.table.bulk_pull(keys)     # schema defaults
    rows["show"] = shows
    rows["click"] = clicks
    rows["embed_w"] = ws_
    rows["mf"] = np.asarray(mf_mat, np.float32)
    # the dump writes zeros for uncreated embedx (see save_xbox) — derive
    # mf_size so serving pulls mask exactly like training did.  SERVING-ONLY
    # contract: a created row whose embedding trained to exactly all zeros
    # round-trips as uncreated (served values identical — zeros either way),
    # but resuming TRAINING from an xbox dump would re-initialize such rows'
    # embedx; use save_checkpoint/load_checkpoint (which carry mf_size
    # explicitly) for training resume.
    created = np.any(rows["mf"] != 0.0, axis=1)
    rows["mf_size"] = np.where(created, d, 0).astype(rows["mf_size"].dtype)
    # zero every field the dump does not carry (optimizer state, scores)
    # — serving never pushes, and a delta-refresh over existing rows must
    # not resurrect their stale training state
    keep = {"show", "click", "embed_w", "mf", "mf_size", "slot"}
    for fld in rows:
        if fld not in keep:
            rows[fld] = np.zeros_like(rows[fld])
    engine.table.bulk_write(keys, rows)
    # coherence point (hot-swap contract): the rows just changed UNDER
    # every consumer that mirrors them.  A device-resident row cache now
    # holds the retired day's values, and a PSClient's learned row-width
    # estimates were sized from the old contents — both must drop HERE,
    # not just in freeze_for_serving (a replica that load_xbox'es day N+1
    # over day N never calls freeze again).
    cache = getattr(engine, "cache", None)
    if cache is not None:
        cache.invalidate("load_xbox")
    inval = getattr(engine.table, "invalidate_row_width", None)
    if inval is not None:
        inval()
    return keys


# -- xbox swap manifest (train→serve day pointer) ---------------------------
# The dump itself lands via save_xbox's tmp+rename; this publishes WHICH
# dump is current — the trainer's last act of a day, the serving fleet's
# swap trigger (ServingReplica.watch_manifest).  Same discipline as the
# checkpoint MANIFEST: one mutable file, swapped whole via _atomic_write,
# so a reader sees the old complete pointer or the new one, never a torn
# write or a pointer to a half-written dump.
XBOX_MANIFEST = "XBOX_MANIFEST.json"


def publish_xbox_manifest(root: str, path: str, generation: int,
                          day: str = "") -> str:
    """Atomically point ``<root>/XBOX_MANIFEST.json`` at the dump at
    ``path`` (already fully written — call this AFTER save_xbox
    returns).  Returns the manifest path."""
    os.makedirs(root, exist_ok=True)
    man = os.path.join(root, XBOX_MANIFEST)
    _atomic_write(man, json.dumps(
        {"generation": int(generation), "path": path, "day": day,
         "published_unix": time.time()}).encode())
    return man


def read_xbox_manifest(root: str) -> Optional[Dict]:
    """The current swap pointer, or None when nothing is published yet.
    Raises on a malformed manifest — tmp+rename means a torn file is a
    bug upstream, not a transient to paper over."""
    man = os.path.join(root, XBOX_MANIFEST)
    if not os.path.exists(man):
        return None
    with open(man, "r") as f:
        out = json.load(f)
    if "generation" not in out or "path" not in out:
        raise ValueError(f"malformed xbox manifest {man}: {out!r}")
    return out
