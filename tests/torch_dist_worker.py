"""Two-process integration worker of the PyTorch port (spawned by
``tests/test_torch_launch.py`` through ``python -m
paddlebox_tpu_torch.launch``): the port's copy of ``tests/_dist_worker.py``.

Every rank first joins the launcher's rendezvous through
``launch.init_distributed()`` (a gloo group) and sums ``rank + 1`` with
``torch.distributed.all_reduce``.  With ``DW_DATA`` set it then reads the
data file, keeps rows ``rank::world`` of it, global-shuffles them across
the workers over TCP, trains passes against the shared PS service with
delta write-back on the CPU, and dumps the loss/auc trajectory as JSON.

Env: PBOX_RANK, PBOX_WORLD_SIZE, PBOX_COORDINATOR (launcher-set),
DW_OUT (json path prefix); for training also DW_PS_ADDR (host:port),
DW_SHUFFLE_PORTS (comma), DW_DATA (file), DW_BATCH, DW_PASSES.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from paddlebox_tpu_torch.config import (DataFeedConfig,  # noqa: E402
                                        EmbeddingTableConfig, SlotConfig,
                                        SparseSGDConfig)
from paddlebox_tpu_torch.launch import init_distributed  # noqa: E402

MF_DIM = 4
N_SLOTS = 3


def feed_config():
    # nonzero: rand_seed=0 means "unseeded", and an unseeded shuffle
    # (the global one's destinations, the local one's order) made the
    # solo-vs-duo AUC gap a coin-flip near its 0.08 bound
    return DataFeedConfig(slots=(
        SlotConfig("label", dtype="float", is_dense=True, dim=1),
        SlotConfig("dense0", dtype="float", is_dense=True, dim=2),
        SlotConfig("slot_a", slot_id=101, capacity=2),
        SlotConfig("slot_b", slot_id=102, capacity=2),
        SlotConfig("slot_c", slot_id=103, capacity=1),
    ), rand_seed=42)


def train(rank, world):
    from paddlebox_tpu_torch.data.dataset import SlotDataset
    from paddlebox_tpu_torch.data.shuffle_transport import \
        TcpShuffleTransport
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
    from paddlebox_tpu_torch.metrics.auc import (AucCalculator,
                                                 allreduce_auc_state)
    from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
    from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
    from paddlebox_tpu_torch.ps.service import PSClient, RemoteTableAdapter
    from paddlebox_tpu_torch.trainer.trainer import SparseTrainer

    ps_addr = os.environ["DW_PS_ADDR"].rsplit(":", 1)
    ports = [int(p) for p in os.environ["DW_SHUFFLE_PORTS"].split(",")]
    batch = int(os.environ["DW_BATCH"])
    passes = int(os.environ["DW_PASSES"])

    client = PSClient((ps_addr[0], int(ps_addr[1])))
    cfg = feed_config()
    transport = TcpShuffleTransport(
        rank, [("127.0.0.1", p) for p in ports]) if world > 1 else None
    ds = SlotDataset(cfg, read_threads=1, transport=transport)
    ds.set_filelist([os.environ["DW_DATA"]])

    engine = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF_DIM, shard_num=4,
        sgd=SparseSGDConfig(mf_create_thresholds=0.0)), seed=1,
        device="cpu")
    engine.table = RemoteTableAdapter(client, delta_mode=world > 1)

    model = CtrDnn(num_slots=N_SLOTS, emb_width=3 + MF_DIM, dense_dim=2,
                   hidden=(64, 32))
    trainer = SparseTrainer(engine, model, cfg, batch_size=batch,
                            auc_table_size=10_000, seed=2, device="cpu")

    # shard the records: worker w keeps rows [w::world] of its file read
    # (each worker reads the same file here; a real job reads disjoint
    # files), then the global shuffle redistributes them randomly
    results = []
    for p in range(passes):
        engine.begin_feed_pass()
        ds.load_into_memory()
        if world > 1:
            full = SlotRecordBlock.concat(ds.get_blocks())
            ds._blocks = [full.select(np.arange(rank, full.n, world))]
            ds.global_shuffle()
        else:
            ds.local_shuffle()
        for blk in ds.get_blocks():   # key tap over the post-shuffle shard
            engine.add_keys(blk.all_keys())
        engine.end_feed_pass()
        client.barrier(world)      # all shards registered before training
        engine.begin_pass()
        trainer.reset_metrics()
        out = trainer.train_pass(ds)
        engine.end_pass()
        client.barrier(world)      # pass deltas all merged before next pull
        # EXACT global metrics: allreduce the bucket tables through the PS
        # (≙ fleet.metrics.auc) — every rank must report the same value
        if world > 1:
            g = allreduce_auc_state(trainer.auc_state, client, world,
                                    key=f"auc-{p}")
            calc = AucCalculator(10_000)
            calc.merge_device_state(g)
            gauc = calc.compute()["auc"]
        else:
            gauc = out["auc"]
        results.append({"loss": out["loss"], "auc": out["auc"],
                        "gauc": gauc, "batches": out["batches"]})
        ds.release_memory()
    if transport is not None:
        transport.close()
    client.close()
    return results


def main():
    rank = init_distributed()
    world = int(os.environ.get("PBOX_WORLD_SIZE", "1"))
    out = {"rank": rank, "world": world}
    if world > 1:
        t = torch.tensor([rank + 1.0])
        dist.all_reduce(t)
        out["all_reduce"] = float(t.item())
        out["backend"] = dist.get_backend()
    if os.environ.get("DW_DATA"):
        out["passes"] = train(rank, world)
    if world > 1:
        dist.destroy_process_group()
    with open(os.environ["DW_OUT"] + f".rank{rank}", "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
