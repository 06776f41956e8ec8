"""Standalone PS server process — one cluster shard per OS process.

Copy of ``paddlebox_tpu/ps/server_main.py`` with the import paths rewritten
(host code: numpy, files, sockets and threads; no device call).

``launch.PSFleet(N)`` supervises N in-process servers, which is
the right shape for tests and single-host chaos drills (shared fault
injection, in-memory dedup handoff).  A production fleet — and any
CPU-honest throughput measurement — runs each shard as its OWN process
so table work scales across cores instead of serializing on one
interpreter lock.  This module is that process:

    python -m paddlebox_tpu_torch.ps.server_main --port 0 --mf_dim 8 --seed 0

It builds an identically-seeded ``ShardedHostTable`` (fresh-row defaults
are pure in (seed, key), so N such processes form one consistent key
space), optionally reloads its cluster shard from a generation
checkpoint (``--ckpt_root`` + ``--shard``, the same ``shard-<k:03d>/``
handoff PSServerSupervisor uses), serves until SIGTERM/SIGINT, then
drains.  The bound address is announced on stdout as one line

    PS_ADDR <host>:<port>

so a parent (an orchestrator, a test) can spawn with ``--port 0`` and
scrape the ephemeral port.  Imports stay in the numpy/socket layer (no
torch), so a shard comes up in well under a second.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paddlebox_tpu_torch.ps.server_main",
        description="run one PS cluster shard as a standalone process")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral, announced on stdout)")
    ap.add_argument("--mf_dim", type=int, default=8,
                    help="embedding_dim of the hosted table")
    ap.add_argument("--shard_num", type=int, default=4,
                    help="host-table lock shards (NOT the cluster width)")
    ap.add_argument("--seed", type=int, default=0,
                    help="table seed — MUST match every other shard")
    ap.add_argument("--ckpt_root", default=None,
                    help="generation-checkpoint root to reload from")
    ap.add_argument("--shard", type=int, default=None,
                    help="cluster rank: reload only shard-<k:03d>/ subdirs")
    ap.add_argument("--membership", default=None,
                    help="fleet membership 'h1:p1,h2:p2,...' — enables "
                         "epoch fencing; --shard -1 joins as a pending "
                         "member (answers typed redirects until a "
                         "reshard cutover admits it)")
    ap.add_argument("--epoch", type=int, default=0,
                    help="membership epoch the address list is valid at")
    args = ap.parse_args(argv)

    from paddlebox_tpu_torch.config import EmbeddingTableConfig
    from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
    from paddlebox_tpu_torch.ps.service import PSServer, _dedup_read

    table = ShardedHostTable(
        EmbeddingTableConfig(embedding_dim=args.mf_dim,
                             shard_num=args.shard_num),
        seed=args.seed)
    dedup = None
    if args.ckpt_root:
        from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
        ck = TrainCheckpoint(args.ckpt_root)
        head = ck.load_table(table, shard=args.shard)
        if head is not None:
            sparse = os.path.join(ck._gen_dir(head), "sparse")
            if args.shard is not None:
                sparse = os.path.join(sparse, f"shard-{args.shard:03d}")
            dedup = _dedup_read(sparse)

    membership = None
    if args.membership:
        from paddlebox_tpu_torch.ps import cluster as ps_cluster
        membership = ps_cluster.make_server_map(
            ps_cluster.parse_addrs(args.membership), epoch=args.epoch)
    srv = PSServer(table, host=args.host, port=args.port,
                   dedup_state=dedup, membership=membership,
                   shard=args.shard if args.shard is not None else 0)
    print(f"PS_ADDR {srv.addr[0]}:{srv.addr[1]}", flush=True)

    done = threading.Event()

    def _stop(signum, frame):
        done.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    done.wait()
    srv.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
