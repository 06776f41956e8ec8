"""Standalone serving-replica entrypoint — the third leg of the BoxPS
day loop (train → save_xbox → **serve**), runnable on a box that never
trains.

The port's counterpart of the repository's root ``serve.py``: the same
arguments, run as ``python -m paddlebox_tpu_torch.serve``; it imports
only ``paddlebox_tpu_torch``, and only its host tier (no torch, no
device call: a replica serves a frozen host table).

Loads an xbox dump (or the current one named by an xbox swap manifest)
into a read-only :class:`~paddlebox_tpu_torch.ps.serving.ServingReplica`,
optionally watches the manifest and hot-swaps when the trainer publishes
the next day, and blocks until interrupted.  Observability comes up
in-process: ``--obs_port`` serves /statz + /timelinez, the telemetry
timeline samples ``serving.<tenant>.*`` on a cadence, and the SLO
watchdog evaluates the serving rule set (per-tenant p99 budget +
sustained-shed) alongside the defaults.

Usage:
    python -m paddlebox_tpu_torch.serve --xbox /dumps/xbox_base_20260805
    python -m paddlebox_tpu_torch.serve --manifest /dumps --watch_s 2 \
        --tenants ads,feed --max_inflight 128 --obs_port 9200
    python -m paddlebox_tpu_torch.serve --ckpt /ckpt --shard 2 --n_shards 4

Multiple replicas: run this once per port (each loads the dump
independently and answers bit-identically) and point a
``ServingRouter([(host, port), ...])`` at the set — or run
``launch.serve_fleet`` to supervise an in-process fleet with
restart-in-place.

Sharded fleets: give every process the SAME ``--n_shards`` and a
distinct ``--shard``, then point a ``ServingRouter(shard_groups=[
[(h, p), ...], ...])`` (group k = shard k's replicas) at the set.
``--ckpt`` streams pass-delta freshness from a TrainCheckpoint root
instead of day-granularity xbox manifests: each published ``save_pass``
generation is hot-patched into the live planes copy-on-write.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--xbox", default="",
                     help="xbox dump path to serve (pinned generation)")
    src.add_argument("--manifest", default="",
                     help="directory holding XBOX_MANIFEST.json; serves "
                          "the manifest's current dump")
    src.add_argument("--ckpt", default="",
                     help="TrainCheckpoint root to stream: loads the "
                          "manifest head's base+delta chain and hot-"
                          "patches each new save_pass generation "
                          "(pass-granularity freshness)")
    ap.add_argument("--watch_s", type=float, default=0.0,
                    help="poll the manifest every N seconds and hot-swap "
                         "on a generation advance (0 = never; swap verb "
                         "only).  Requires --manifest")
    ap.add_argument("--day", default="", help="day label for --xbox mode")
    ap.add_argument("--generation", type=int, default=1,
                    help="starting generation number for --xbox mode")
    ap.add_argument("--tenants", default="default",
                    help="comma-separated tenant namespaces "
                         "(FLAGS_serve_tenants)")
    ap.add_argument("--max_inflight", type=int, default=None,
                    help="per-tenant admission cap "
                         "(FLAGS_serve_max_inflight; 0 = unbounded)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral, printed on start)")
    ap.add_argument("--mf_dim", type=int, default=8,
                    help="table embedding_dim — must match the trainer "
                         "that wrote the dump")
    ap.add_argument("--seed", type=int, default=0,
                    help="default-row seed — must match the trainer for "
                         "bit-identical miss rows")
    ap.add_argument("--shard", type=int, default=0,
                    help="ServerMap shard this replica owns (with "
                         "--n_shards > 1 it keeps only its key range "
                         "plus the replicated hot set)")
    ap.add_argument("--n_shards", type=int, default=1,
                    help="total ServerMap shards in the fleet — must "
                         "match every other replica AND the router")
    ap.add_argument("--hot_keys", type=int, default=None,
                    help="top-K heat-sketch keys replicated into every "
                         "shard (0 = off) (FLAGS_serving_hot_keys)")
    ap.add_argument("--patch_poll_s", type=float, default=None,
                    help="--ckpt manifest poll cadence "
                         "(FLAGS_serving_patch_poll_s)")
    ap.add_argument("--obs_port", type=int, default=0,
                    help="/statz + /timelinez exporter port (0 = off)")
    ap.add_argument("--timeline_s", type=float, default=1.0,
                    help="timeline sample cadence feeding the SLO "
                         "watchdog (0 = off)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from paddlebox_tpu_torch import flags
    from paddlebox_tpu_torch.config import EmbeddingTableConfig
    from paddlebox_tpu_torch.io.checkpoint import read_xbox_manifest
    from paddlebox_tpu_torch.ps.serving import ServingReplica
    from paddlebox_tpu_torch.utils import obs_server, timeline

    tenants = [t.strip() for t in args.tenants.split(",") if t.strip()]
    fl = {"serve_tenants": ",".join(tenants) or "default"}
    if args.max_inflight is not None:
        fl["serve_max_inflight"] = args.max_inflight
    if args.obs_port:
        fl["obs_port"] = args.obs_port
    if args.hot_keys is not None:
        fl["serving_hot_keys"] = args.hot_keys
    if args.patch_poll_s is not None:
        fl["serving_patch_poll_s"] = args.patch_poll_s
    flags.set_flags(fl)

    path, day, gen = args.xbox, args.day, args.generation
    if args.manifest:
        man = read_xbox_manifest(args.manifest)
        if man is None:
            print(f"serve: no {args.manifest}/XBOX_MANIFEST.json yet — "
                  f"waiting for the trainer to publish one",
                  file=sys.stderr)
            while man is None:
                time.sleep(max(args.watch_s, 0.5))
                man = read_xbox_manifest(args.manifest)
        path, day, gen = (man["path"], str(man.get("day", "")),
                          int(man["generation"]))

    config = EmbeddingTableConfig(embedding_dim=args.mf_dim)
    rep = ServingReplica(config=config, xbox_path=path, tenants=tenants,
                         max_inflight=args.max_inflight, host=args.host,
                         port=args.port, day=day, generation=gen,
                         seed=args.seed, shard=args.shard,
                         n_shards=args.n_shards,
                         ckpt_root=args.ckpt or None)
    if args.ckpt:
        rep.watch_ckpt()
    elif args.manifest and args.watch_s > 0:
        rep.watch_manifest(args.manifest, args.watch_s)

    obs_server.maybe_start_from_flags()
    sampler = None
    if args.timeline_s > 0:
        rules = timeline.default_rules() + timeline.serving_rules(tenants)
        sampler = timeline.start(interval_s=args.timeline_s, rules=rules)

    src = f"ckpt={args.ckpt}" if args.ckpt else f"dump={path}"
    print(f"serve: replica {rep.addr[0]}:{rep.addr[1]} "
          f"shard={args.shard}/{max(1, args.n_shards)} "
          f"generation={rep._gen.generation} "
          f"tenants={','.join(tenants)} {src}",
          file=sys.stderr, flush=True)
    try:
        while not rep._dead:
            time.sleep(1.0)
        print("serve: replica died", file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 0
    finally:
        if sampler is not None:
            timeline.stop()
        rep.shutdown()


if __name__ == "__main__":
    sys.exit(main())
