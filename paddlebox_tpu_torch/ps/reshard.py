"""Live key-range handoff: grow or shrink the PS fleet WITHOUT a
save/load outage.

Copy of ``paddlebox_tpu/ps/reshard.py`` with the import paths rewritten
(host code: numpy, files, sockets and threads; no device call).

The driver turns "change the fleet from ``old_addrs`` to ``new_addrs``"
into the snapshot → delta catch-up → freeze → cutover sequence the
servers implement (ps/service.py ``reshard_begin`` / ``reshard_delta`` /
the ``reshard_cutover`` lifecycle verbs):

1. **Snapshot** — every OLD member dumps the rows the proposed map
   assigns elsewhere, split per destination into
   ``<workdir>/snap/src-<s>/dst-<d>/table-<name>`` (the same tmp+rename
   per-shard npz files checkpoints use — the dump IS the snapshot, no
   extra format).  Serving continues at full rate; the server starts
   recording writes into the moving range (its dirty set).
2. **Ingest** — every NEW-map member upsert-loads exactly its own
   ``dst-<d>`` slices.  Keyed upsert makes every ingest idempotent, so
   no rid pinning is needed on the data path — retries and re-runs
   re-apply the same rows to the same keys.
3. **Delta rounds** — sources re-dump their (cumulative) dirty sets,
   destinations re-ingest; last-write-wins per key converges the moved
   range while writes keep flowing.
4. **Freeze + final delta** — moving-range WRITES start drawing typed
   ``migrating`` redirects (clients back off bounded — ps/service.py
   ``_fence_recover``; non-moving keys never stall), in-flight verbs
   drain, and the closing delta ships.  Only this window blocks, and
   only for the moving range.
5. **Cutover** — one ``two_phase_lifecycle`` round ("reshard_cutover")
   across the UNION of old and new members flips everyone to the
   ``epoch+1`` map, drops rows each server no longer owns, and
   unfreezes.  The frame is self-contained (membership + assignment
   ride in it), prepare/commit rids are pinned, so a driver retry after
   any partial failure replays the SAME rids and the per-shard dedup
   windows collapse duplicates — the only non-idempotent step in the
   whole migration is exactly-once.
6. **Manifest** — the new epoch + membership commit to the checkpoint
   MANIFEST (io/checkpoint.commit_membership) AFTER the cutover: a
   crash anywhere earlier leaves the manifest pointing at the old
   membership, and rollback is an atomic pointer swap — the old fleet
   is immediately serviceable (abort unfreezes it and destination
   servers drop ingested-but-unowned rows).

Crash-anywhere story: every phase before the cutover is restartable by
re-running :func:`reshard` with a FRESH ``workdir`` — ``reshard_begin``
re-snapshots CURRENT state (nothing written between attempts can be
lost), ingest is idempotent, and an abandoned attempt's residue is
dropped by the servers' unowned-row cleanup at the next begin/abort.
The cutover itself is exactly-once via pinned rids + the epoch guard.

Assumptions (enforced by the launcher, documented in DEPLOY.md): all
fleet members share the table config — in particular the internal
``shard_num`` — so per-shard npz part files align across servers; no
``end_day``/``shrink`` runs concurrently with a migration (deletes are
not tracked by the dirty set); client retry deadlines exceed the freeze
window.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from paddlebox_tpu_torch.ps import cluster as ps_cluster
from paddlebox_tpu_torch.utils import flight
from paddlebox_tpu_torch.utils.monitor import stat_add, stat_observe

__all__ = ["reshard"]


def _norm_addrs(addrs) -> List[Tuple[str, int]]:
    return [(str(h), int(p)) for h, p in addrs]


def _abort_all(admin, n: int, timeout: float) -> None:
    """Best-effort rollback fan-out: unfreeze sources, make destinations
    drop ingested-but-unowned rows.  Never raises — rollback must not
    mask the original failure."""
    for s in range(n):
        try:
            admin._call({"cmd": "lifecycle_abort",
                         "verb": "reshard_cutover"},
                        shard=s, dedup=True, timeout=timeout)
        except Exception:
            pass
    stat_add("ps.reshard.abort")


def reshard(client, new_addrs: Sequence[Tuple[str, int]], workdir: str,
            *, rounds: int = 2, settle_rows: int = 0,
            timeout: float = 120.0,
            manifest_root: Optional[str] = None) -> ps_cluster.ServerMap:
    """Migrate the live fleet behind ``client`` to ``new_addrs``.

    Every server in ``new_addrs`` that is not already a member must be
    up and reachable (started membership-aware with ``shard=-1`` — it
    answers typed ``not_owner`` redirects until the cutover admits it).
    Returns the committed new :class:`~paddlebox_tpu_torch.ps.cluster.ServerMap`;
    ``client`` has already adopted it (its map listeners — e.g. the
    DeviceRowCache moved-range invalidation — have fired).

    ``rounds`` counts delta catch-up rounds before the freeze (≥ 1);
    a round that ships ``settle_rows`` rows or fewer cuts over early.
    ``manifest_root`` names the checkpoint root whose MANIFEST records
    the committed membership (skipped when None).
    """
    from paddlebox_tpu_torch.ps.service import PSClient  # lazy: avoid cycle

    t0 = time.perf_counter()
    old_map = client.server_map
    new_list = _norm_addrs(new_addrs)
    if not new_list:
        raise ValueError("reshard to an empty fleet")
    if new_list == list(old_map.addrs):
        return old_map
    new_map = ps_cluster.make_server_map(new_list,
                                         epoch=old_map.epoch + 1)
    desc = new_map.describe()
    union = list(old_map.addrs) + [a for a in new_list
                                   if a not in old_map.addrs]
    assign = {f"{h}:{p}": (new_list.index((h, p))
                           if (h, p) in new_list else -1)
              for h, p in union}
    n_old = old_map.n
    flight.record("reshard_drive", epoch=new_map.epoch,
                  n_old=n_old, n_new=new_map.n)

    admin = PSClient(union, retries=None,
                     retry_sleep=getattr(client, "retry_sleep", 0.1),
                     backoff_cap=getattr(client, "backoff_cap", 2.0),
                     deadline=timeout)
    try:
        tables = sorted(admin.list_tables())

        def ingest(path: str) -> None:
            # destinations pull exactly their own dst-<d> slices; a
            # (src, dst, table) dir that was never written means no rows
            # moved along that edge this round.  RESHARD_FIELD exempts
            # these loads from the control-plane epoch fence — a pending
            # destination is not yet in any map, so no client epoch can
            # ever match it
            from paddlebox_tpu_torch.ps.service import RESHARD_FIELD
            for d, addr in enumerate(new_list):
                u = union.index(addr)
                for s in range(n_old):
                    for name in tables:
                        p = os.path.join(path, f"src-{s:03d}",
                                         f"dst-{d:03d}", f"table-{name}")
                        if not os.path.isdir(p):
                            continue
                        admin._call({"cmd": "load", "table": name,
                                     "path": p, "mode": "upsert",
                                     RESHARD_FIELD: True},
                                    shard=u, dedup=True, timeout=timeout)

        def delta_round(path: str, freeze: bool) -> int:
            moved = 0
            for s in range(n_old):
                r = admin._call({"cmd": "reshard_delta",
                                 "path": os.path.join(path,
                                                      f"src-{s:03d}"),
                                 "freeze": freeze},
                                shard=s, dedup=True, timeout=timeout)
                moved += int(r.get("moved", 0))
            ingest(path)
            return moved

        # -- phase 1: snapshot (serving continues, dirty tracking on)
        snapped = 0
        for s in range(n_old):
            h, p = old_map.addrs[s]
            r = admin._call({"cmd": "reshard_begin", "membership": desc,
                             "self_new": assign[f"{h}:{p}"],
                             "path": os.path.join(workdir, "snap",
                                                  f"src-{s:03d}")},
                            shard=s, dedup=True, timeout=timeout)
            snapped += int(r.get("moved", 0))
        ingest(os.path.join(workdir, "snap"))
        stat_add("ps.reshard.snapshot_rows", float(snapped))

        # -- phase 2: delta catch-up (bounded rounds, early settle)
        total_delta = 0
        for i in range(1, max(1, int(rounds))):
            moved = delta_round(os.path.join(workdir, f"delta-{i}"),
                                freeze=False)
            total_delta += moved
            stat_add("ps.reshard.delta_rows", float(moved))
            if moved <= int(settle_rows):
                break

        # -- phase 3: freeze + closing delta (only the moving range
        # blocks, and only from here to the cutover commit)
        t_freeze = time.perf_counter()
        moved = delta_round(os.path.join(workdir, "freeze"), freeze=True)
        total_delta += moved
        stat_add("ps.reshard.delta_rows", float(moved))
    except BaseException:
        # pre-cutover failure: rollback is safe — no server has adopted
        # the new map, abort unfreezes and drops destination ingest
        _abort_all(admin, len(union), min(timeout, 5.0))
        admin.close()
        raise
    try:
        # -- phase 4: exactly-once cutover across the union.  A failure
        # HERE retries FORWARD (the prepare/commit rids are pinned on
        # ``admin``, so a re-drive replays the same frames and the dedup
        # windows + the epoch guard collapse duplicates); aborting a
        # half-committed cutover would strand the fleet at mixed epochs.
        # Even exhausting the retries is recoverable: re-running
        # reshard() to the SAME target recomputes epoch+1, finds nothing
        # left to move, and its cutover no-ops committed members while
        # finishing the stragglers.
        attempt = 0
        while True:
            try:
                ps_cluster.two_phase_lifecycle(
                    admin, "reshard_cutover", timeout=timeout,
                    extra={"membership": desc, "assign": assign})
                break
            except Exception:
                attempt += 1
                stat_add("ps.reshard.cutover_retry")
                if attempt >= 3:
                    raise
                time.sleep(min(0.1 * (2 ** attempt), 2.0))
        stall_ms = (time.perf_counter() - t_freeze) * 1000.0
        stat_observe("ps.reshard.cutover_stall_ms", stall_ms)
    finally:
        admin.close()

    # -- phase 5: durable membership pointer (after the cutover: a crash
    # before this line rolls back to the old epoch on restart)
    if manifest_root is not None:
        from paddlebox_tpu_torch.io.checkpoint import commit_membership
        commit_membership(manifest_root, new_map)

    client._adopt_map(new_map)
    moved_rows = snapped + total_delta
    dt = time.perf_counter() - t0
    stat_add("ps.reshard.completed")
    stat_add("ps.reshard.rows_moved", float(moved_rows))
    if dt > 0:
        stat_observe("ps.reshard.rows_per_s", moved_rows / dt)
    flight.record("reshard_done", epoch=new_map.epoch,
                  rows=moved_rows, ms=dt * 1000.0)
    return new_map
