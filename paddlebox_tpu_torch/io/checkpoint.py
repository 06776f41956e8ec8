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

MANIFEST, STATE and the sparse files are the JAX package's layout, so the
sparse half of a generation loads into either package's table
(``load_table``).  The dense half is each package's own: the JAX package
writes flax msgpack.

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
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.ps import faults
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe, stat_set

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
