"""Single-rank trainer process: the N x M deployment entry.

Port of ``paddlebox_tpu/trainer/fleet_main.py``: one OS process per
trainer rank.  The rank is supervised IN-PROCESS by
:class:`paddlebox_tpu_torch.launch.TrainerSupervisor` with a factory that
rebuilds the full incarnation (PSClient + shuffle transport + FleetRunner)
per attempt, so crash-anywhere recovery is the same code path whether
ranks are threads (tests, fleet.run_trainer_fleet) or processes
(deployment).  The rank trains on ``--device`` (``cuda`` unless ``cpu``
is asked for); several rank processes may share one card.

Spec file (``--spec``, JSON)::

    {"days": [["20260701", [["f0.txt", "f1.txt"], ...]], ...],
     "n_slots": 3, "mf_dim": 4, "dense_dim": 2}

Slots follow the e2e layout: dense ``label`` (dim 1), dense ``dense0``
(dim ``dense_dim``), then ``n_slots`` sparse slots with ids 101+.

On success prints ONE line to stdout::

    FLEETMAIN {"rank": ..., "wall_s": ..., "restarts": ...,
               "history": [...], "stats": {trainer.* snapshot}}

``stats`` is the whole-process ``trainer.`` snapshot — per-rank by
construction because each rank IS a process (thread-mode ranks fold
their wait/byte counters into one registry)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Tuple


def _parse_addrs(s: str) -> List[Tuple[str, int]]:
    out = []
    for part in filter(None, s.split(",")):
        host, _, port = part.rpartition(":")
        out.append((host, int(port)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--ps", required=True,
                    help="comma-separated host:port PS shard list")
    ap.add_argument("--trainer_addrs", default="",
                    help="comma-separated host:port per rank (world > 1); "
                         "use fixed non-ephemeral ports — a restarted "
                         "rank must be able to re-bind its own address")
    ap.add_argument("--workdir", required=True,
                    help="shared fleet workdir (manifest, heartbeats)")
    ap.add_argument("--spec", required=True, help="day/model spec JSON")
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--virtual_shards", type=int, default=None)
    ap.add_argument("--table_seed", type=int, default=1)
    ap.add_argument("--trainer_seed", type=int, default=2)
    ap.add_argument("--prefetch", action="store_true")
    ap.add_argument("--max_restarts", type=int, default=3)
    ap.add_argument("--client_deadline", type=float, default=60.0)
    ap.add_argument("--fault_site", default="",
                    help="arm a seeded FaultPlan kill at this lifecycle "
                         "site on the FIRST incarnation")
    ap.add_argument("--fault_at", type=int, default=1)
    ap.add_argument("--fault_seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where the rank's engines and trainer work "
                         "(cuda or cpu)")
    ap.add_argument("--warm", action="store_true",
                    help="run the schedule once un-timed first (kernel "
                         "load, cuBLAS handles, table residency), then "
                         "re-run fresh and report only the measured run, "
                         "so that wall_s and cpu_s exclude the warm-up")
    args = ap.parse_args(argv)

    from paddlebox_tpu_torch.config import (DataFeedConfig,
                                            EmbeddingTableConfig,
                                            SlotConfig, SparseSGDConfig)
    from paddlebox_tpu_torch.data.shuffle_transport import TcpShuffleTransport
    from paddlebox_tpu_torch.launch import TrainerSupervisor
    from paddlebox_tpu_torch.models.deepfm import DeepFM
    from paddlebox_tpu_torch.ps import faults
    from paddlebox_tpu_torch.ps.service import PSClient
    from paddlebox_tpu_torch.trainer.fleet_runner import FleetRunner
    from paddlebox_tpu_torch.utils.monitor import stat_snapshot

    with open(args.spec) as f:
        spec = json.load(f)
    n_slots = int(spec.get("n_slots", 3))
    mf_dim = int(spec.get("mf_dim", 4))
    dense_dim = int(spec.get("dense_dim", 2))
    days = [(str(d), [list(fl) for fl in passes])
            for d, passes in spec["days"]]

    ps_addrs = _parse_addrs(args.ps)
    tr_addrs = _parse_addrs(args.trainer_addrs) or None
    if args.world > 1 and not tr_addrs:
        ap.error("--trainer_addrs required when --world > 1")

    tcfg = EmbeddingTableConfig(
        embedding_dim=mf_dim, shard_num=4,
        sgd=SparseSGDConfig(mf_create_thresholds=2.0))
    slots = [SlotConfig("label", dtype="float", is_dense=True, dim=1),
             SlotConfig("dense0", dtype="float", is_dense=True,
                        dim=dense_dim)]
    slots += [SlotConfig(f"slot_{i}", slot_id=101 + i, capacity=2)
              for i in range(n_slots)]
    feed = DataFeedConfig(slots=tuple(slots), batch_size=args.batch_size,
                          rand_seed=42)

    def model_fn():
        return DeepFM(num_slots=n_slots, emb_width=3 + mf_dim,
                      dense_dim=dense_dim, hidden=(16, 8))

    plans = {}
    if args.fault_site:
        plans[0] = faults.FaultPlan(seed=args.fault_seed).kill_at(
            args.fault_site, at=(args.fault_at,))

    def make_factory(workdir, faulted):
        def factory(rank: int):
            plan = plans.pop(0, None) if faulted else None  # 1st inc only
            client = PSClient(ps_addrs, deadline=args.client_deadline)
            transport = (TcpShuffleTransport(rank, tr_addrs)
                         if args.world > 1 else None)
            return FleetRunner(
                rank=rank, world=args.world, client=client,
                workdir=workdir, table_config=tcfg, model_fn=model_fn,
                feed_config=feed, batch_size=args.batch_size,
                virtual_shards=args.virtual_shards,
                table_seed=args.table_seed,
                trainer_seed=args.trainer_seed,
                prefetch=args.prefetch, transport=transport,
                fault_plan=plan, device=args.device)
        return factory

    if args.warm:
        # un-timed first lap: kernel load, PS row creation, conn warmup.
        # All ranks lap together (same barriers as the measured run), so
        # the measured fleet starts from an identical warm table.
        TrainerSupervisor(make_factory(args.workdir + "-warm", False),
                          args.rank, days, max_restarts=0).join()

    stats_warm = stat_snapshot("trainer.")
    cpu0 = time.process_time()
    t0 = time.monotonic()
    sup = TrainerSupervisor(make_factory(args.workdir, True), args.rank,
                            days, max_restarts=args.max_restarts)
    result = sup.join()
    wall = time.monotonic() - t0
    cpu = time.process_time() - cpu0
    out = {"rank": args.rank, "wall_s": round(wall, 3),
           "cpu_s": round(cpu, 3),     # contention-free busy basis
           "restarts": sup.restarts,
           "history": [{k: m.get(k) for k in ("loss", "auc", "batches")}
                       for m in result["history"]],
           "stats": stat_snapshot("trainer."),
           "stats_warm": stats_warm}
    print("FLEETMAIN " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
