"""A rank of a dp axis that spans processes (spawned by
``tests/test_torch_multiprocess.py`` through ``python -m
paddlebox_tpu_torch.launch --nproc_per_node 2``).  Imports the port only.

Every rank joins the launcher's gloo group (``launch.init_distributed``)
and builds ``HybridTopology(MeshConfig(dp=2, sharding=4), devices=["cpu"]
* 4, process_group=launch.process_group())``: rank r holds the four
shards of dp coordinate r.  The configuration is
``tests/test_torch_mxu_sharded_trainer.py``'s (4 slots × capacity 3,
mf_dim 4, 3 dense, DeepFM (16,), batch 64, 192 records: three batches),
its records made here by :func:`make_block` from the same seeds.

    python -m paddlebox_tpu_torch.launch --nproc_per_node 2 \\
        --coordinator 127.0.0.1:<port> tests/torch_mesh_worker.py <out dir>

``<out dir>/spec.json`` names the seed; ``<out dir>/params.npz`` holds
the dense weights to start from (``save_params``).  Each rank writes
``<out dir>/rank<r>.npz``: for the streaming and the packed pass its
losses, AUC, working set and dense params; a two-pass day's losses and
host table (``end_pass`` write-back); the cross-process collectives'
results on its shards; and the messages of the refusals of what the
cross-process dp axis does not carry (ROADMAP item 4.5).  The same functions
with ``group`` None run the mesh in one process (:func:`topology`).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddlebox_tpu_torch import config as tcfg  # noqa: E402
from paddlebox_tpu_torch import launch  # noqa: E402
from paddlebox_tpu_torch.data.dataset import SlotDataset  # noqa: E402
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock  # noqa: E402
from paddlebox_tpu_torch.models.deepfm import DeepFM  # noqa: E402
from paddlebox_tpu_torch.parallel import collective as col  # noqa: E402
from paddlebox_tpu_torch.parallel.topology import (HybridTopology,  # noqa: E402
                                                   Spec)
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine  # noqa: E402
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer  # noqa: E402

N_SLOTS, DENSE_DIM, MF, CAP, B = 4, 3, 4, 3, 64
MESH = dict(dp=2, sharding=4)
DAY_SEEDS = (31, 32)


def feed_config():
    return tcfg.DataFeedConfig(slots=tuple(
        [tcfg.SlotConfig("label", dtype="float", is_dense=True, dim=1),
         tcfg.SlotConfig("dense0", dtype="float", is_dense=True,
                         dim=DENSE_DIM)]
        + [tcfg.SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(N_SLOTS)]))


def make_block(seed=0, n=192):
    """``test_torch_mxu_sharded_trainer._block`` with the port's class."""
    rng = np.random.default_rng(seed)
    blk = SlotRecordBlock(n=n)
    for i in range(N_SLOTS):
        lens = rng.integers(1, CAP + 1, size=n)
        off = np.zeros((n + 1,), np.int64)
        np.cumsum(lens, out=off[1:])
        blk.uint64_slots[f"s{i}"] = (
            rng.integers(1, 400, size=int(off[-1])).astype(np.uint64), off)
    blk.float_slots["label"] = (
        rng.integers(0, 2, size=n).astype(np.float32),
        np.arange(n + 1, dtype=np.int64))
    blk.float_slots["dense0"] = (
        rng.normal(0, 1, size=n * DENSE_DIM).astype(np.float32),
        np.arange(n + 1, dtype=np.int64) * DENSE_DIM)
    return blk


def save_params(path, params):
    """A DeepFM ``jax_params`` pytree as one npz."""
    flat = {"dense_w": params["dense_w"], "bias": params["bias"]}
    for i, layer in enumerate(params["mlp"]):
        flat[f"mlp.{i}.w"] = layer["w"]
        flat[f"mlp.{i}.b"] = layer["b"]
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_params(path):
    with np.load(path) as z:
        n = sum(k.startswith("mlp.") and k.endswith(".w") for k in z.files)
        return {"mlp": [{"w": z[f"mlp.{i}.w"], "b": z[f"mlp.{i}.b"]}
                        for i in range(n)],
                "dense_w": z["dense_w"], "bias": z["bias"]}


def topology(group, **degrees):
    """Over ``group``: this rank's half of the shards on the CPU.  With
    ``group`` None, the same mesh in one process, one device a dp row
    (``cpu:0`` / ``cpu:1``: the "halves" layout of
    ``tests/test_torch_multicard.py``), which every result of the ranks
    is held against."""
    cfg = tcfg.MeshConfig(**(degrees or MESH))
    half = cfg.world_size // 2
    if group is None:
        return HybridTopology(cfg, devices=[f"cpu:{k // half}"
                                            for k in range(cfg.world_size)])
    return HybridTopology(cfg, devices=["cpu"] * half, process_group=group)


def open_pass(eng, ds):
    eng.begin_feed_pass()
    for b in ds.get_blocks():
        eng.add_keys(b.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()


def dataset(seed):
    ds = SlotDataset(feed_config())
    ds._blocks = [make_block(seed)]
    return ds


def trainer(eng, topo, params):
    tr = SparseTrainer(eng, DeepFM(N_SLOTS, 3 + MF, DENSE_DIM, hidden=(16,)),
                       feed_config(), batch_size=B, seed=0, topology=topo,
                       device="cpu")
    tr.model.load_jax_params(params)
    return tr


def one_pass(group, seed, params, packed, out, tag):
    topo = topology(group)
    ds = dataset(seed)
    eng = BoxPSEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=MF, sgd=tcfg.SparseSGDConfig(
            mf_create_thresholds=0.0)), topology=topo)
    open_pass(eng, ds)
    tr = trainer(eng, topo, params)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    out[f"{tag}.path"] = np.array(tr._resolve_path())
    out[f"{tag}.losses"] = np.asarray(stats["losses"], np.float64)
    out[f"{tag}.auc"] = np.float64(stats["auc"])
    for k, v in eng.ws.items():
        out[f"{tag}.ws.{k}"] = np.array(v, copy=True)
    for i, p in enumerate(tr.model.parameters()):
        out[f"{tag}.param.{i}"] = p.detach().numpy().copy()


def day(group, params, out):
    """Two passes, the second built while the first trains, each written
    back by end_pass (a ctr_double table: f64 show / click on the host)."""
    topo = topology(group)
    days = [dataset(s) for s in DAY_SEEDS]
    eng = BoxPSEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=MF,
        accessor=tcfg.AccessorConfig(accessor_type="ctr_double"),
        sgd=tcfg.SparseSGDConfig(mf_create_thresholds=0.0)), topology=topo)
    open_pass(eng, days[0])
    tr = trainer(eng, topo, params)
    eng.begin_feed_pass()
    for b in days[1].get_blocks():
        eng.add_keys(b.all_keys())
    eng.end_feed_pass(async_build=True)
    losses = tr.train_pass(days[0])["losses"]
    eng.end_pass()
    eng.begin_pass()
    losses += tr.train_pass(tr.build_pass_feed(days[1]))["losses"]
    eng.end_pass()
    keys = np.sort(eng.table.export_keys())
    out["day.losses"] = np.asarray(losses, np.float64)
    out["day.keys"] = keys
    for f, v in eng.table.bulk_pull(keys).items():
        out[f"day.table.{f}"] = v


def collectives(group, out):
    """Each local shard's result of the collectives over the dp axis (and
    one over dp × sharding) on a seeded [8, 8, 3] split over the mesh."""
    topo = topology(group)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, (8, 8, 3)).astype(np.float32))
    xs = [None if t is None else t[0]
          for t in topo.split(x, Spec(("dp", "sharding")))]
    got = {f"all_reduce_{op}": col.all_reduce(xs, topo, "dp", op)
           for op in ("sum", "max", "min", "mean")}
    got["all_gather"] = col.all_gather(xs, topo, "dp")
    got["all_gather_stacked"] = col.all_gather(xs, topo, "dp", tiled=False,
                                               concat_dim=1)
    got["all_gather_world"] = col.all_gather(xs, topo, ("dp", "sharding"))
    for name, parts in got.items():
        for k in topo.local_shards:
            out[f"col.{name}.{k}"] = parts[k].numpy()


def refused_trainer(group, model=None, feed=None, degrees=None, **kw):
    """A trainer the cross-process topology must refuse (``kw`` to the
    trainer; ``degrees`` the mesh, else :data:`MESH`)."""
    topo = topology(group, **(degrees or {}))
    ds = dataset(0)
    eng = BoxPSEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=MF, sgd=tcfg.SparseSGDConfig(
            mf_create_thresholds=0.0)), topology=topo)
    open_pass(eng, ds)
    SparseTrainer(eng, model or DeepFM(N_SLOTS, 3 + MF, DENSE_DIM,
                                       hidden=(16,)),
                  feed or feed_config(), batch_size=B,
                  seed=0, topology=topo, device="cpu", **kw)


def refused_cache(group):
    """The device row cache on a table split across processes (dp 2)."""
    from paddlebox_tpu_torch import flags
    names = ("ps_device_cache", "ps_device_cache_rows")
    old = {n: flags.get_flags(n) for n in names}
    flags.set_flags({"ps_device_cache": True, "ps_device_cache_rows": 4096})
    try:
        refused_trainer(group, degrees=dict(dp=2))
    finally:
        flags.set_flags(old)


def refusals(group, params, out):
    """The messages of what a cross-process dp axis does not carry."""
    import dataclasses
    from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR
    cases = {
        "async_dense": lambda: refused_trainer(
            group, trainer_config=tcfg.TrainerConfig(
                dense_sync_mode="async_table")),
        "device_cache_split": lambda: refused_cache(group),
        "page_view_model": lambda: refused_trainer(
            group, model=RankAttentionCTR(N_SLOTS, 3 + MF, DENSE_DIM,
                                          hidden=(16,)),
            feed=dataclasses.replace(feed_config(), rank_offset=True)),
        # refused when the trainer is built: nothing is written
        "dump_path": lambda: refused_trainer(
            group, trainer_config=tcfg.TrainerConfig(dump_path="dump")),
        "uid_slot": lambda: refused_trainer(
            group, feed=dataclasses.replace(feed_config(), uid_slot="s0")),
    }
    for name, fn in cases.items():
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            out[f"refused.{name}"] = np.array(f"{type(e).__name__}: {e}")


def main():
    out_dir = sys.argv[1]
    rank = launch.init_distributed()
    group = launch.process_group()
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    params = load_params(os.path.join(out_dir, "params.npz"))
    out = {"rank": np.int64(rank)}
    for packed in (False, True):
        one_pass(group, spec["seed"], params, packed, out,
                 "packed" if packed else "streaming")
    day(group, params, out)
    collectives(group, out)
    refusals(group, params, out)
    tmp = os.path.join(out_dir, f"rank{rank}.tmp.npz")
    np.savez(tmp, **out)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.npz"))


if __name__ == "__main__":
    main()
