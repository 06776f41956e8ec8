"""A rank of a table split across processes (spawned by
``tests/test_torch_multiprocess_split.py`` through ``python -m
paddlebox_tpu_torch.launch --nproc_per_node 2``).  Imports the port only.

Every rank joins the launcher's gloo group and builds, for each run of
:data:`RUNS`, ``HybridTopology(MeshConfig(**degrees), devices=["cpu"] *
half, process_group=launch.process_group())``: rank r holds the shards
of dp coordinate r, and ``table_spec`` splits the working set's rows
over them, so each rank holds its own row blocks only (on dp × sharding,
the multi-node layout, a whole replica instead).  The model and
the data are ``tests/torch_mesh_worker.py``'s (4 slots × capacity 3,
mf_dim 4, 3 dense, DeepFM (16,), batch 64, three batches).

    python -m paddlebox_tpu_torch.launch --nproc_per_node 2 \\
        --coordinator 127.0.0.1:<port> tests/torch_split_worker.py <out dir>

``<out dir>/spec.json`` names the seed and the day's pass files;
``<out dir>/params.npz`` holds the dense weights to start from.  Each
rank writes ``<out dir>/rank<r>.npz``: for every run, streaming and
packed, its losses, AUC, working set (joined over the group), its
``pull_sparse`` of every row (a collective where the rows are split
across processes), dense params and host table after ``end_pass``; a
two-pass day through
``fleet.train_passes`` for :data:`DAY_RUNS`; the five collectives that
send each rank its own parts, on its shards; and ``Sharded.locate`` /
``gather_rows`` / the join of a split tensor.  The same functions with
``group`` None run each mesh in one process, one device a dp row
(``torch_mesh_worker.topology``).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddlebox_tpu_torch import config as tcfg  # noqa: E402
from paddlebox_tpu_torch import fleet, launch  # noqa: E402
from paddlebox_tpu_torch.models.deepfm import DeepFM  # noqa: E402
from paddlebox_tpu_torch.parallel import collective as col  # noqa: E402
from paddlebox_tpu_torch.parallel.topology import Spec  # noqa: E402
from paddlebox_tpu_torch.ps import embedding  # noqa: E402
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine  # noqa: E402
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer  # noqa: E402

import torch_mesh_worker as mw  # noqa: E402

# run: (mesh degrees, sparse_path, the lowering it resolves to); (r),
# (s) and (t) are the multi-node layout, each rank a whole replica
RUNS = {"m": (dict(dp=2), "auto", "mxu_sharded"),
        "n": (dict(dp=2), "mxu", "mxu"),
        "o": (dict(dp=2, mp=2), "auto", "fast"),
        "p": (dict(dp=2), "reference", "reference"),
        "q": (dict(dp=2), "fast", "fast"),
        "r": (mw.MESH, "mxu", "mxu"),
        "s": (mw.MESH, "fast", "fast"),
        "t": (mw.MESH, "reference", "reference")}
PASSES = ("streaming", "packed")
# run: whether its day runs through the pass prefetcher
DAY_RUNS = {"m": False, "o": True}


def engine(topo, **table_kw):
    return BoxPSEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=mw.MF, sgd=tcfg.SparseSGDConfig(
            optimizer="adagrad", mf_create_thresholds=0.0), **table_kw),
        topology=topo)


def trainer(eng, topo, path, params, feed_config=None, **kw):
    tr = SparseTrainer(eng, DeepFM(mw.N_SLOTS, 3 + mw.MF, mw.DENSE_DIM,
                                   hidden=(16,)),
                       feed_config or mw.feed_config(), batch_size=mw.B,
                       seed=0, topology=topo, sparse_path=path,
                       device="cpu", **kw)
    tr.model.load_jax_params(params)
    return tr


def table(eng, out, tag):
    keys = np.sort(eng.table.export_keys())
    out[f"{tag}.table.keys"] = keys
    for f, v in eng.table.bulk_pull(keys).items():
        out[f"{tag}.table.{f}"] = v


def one_pass(group, run, seed, params, packed, out):
    """Run ``run``'s pass, streaming or packed, then end_pass."""
    degrees, path, _ = RUNS[run]
    tag = f"{run}.{PASSES[packed]}"
    topo = mw.topology(group, **degrees)
    ds = mw.dataset(seed)
    eng = engine(topo)
    mw.open_pass(eng, ds)
    tr = trainer(eng, topo, path, params)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    out[f"{tag}.path"] = np.array(tr._resolve_path())
    out[f"{tag}.losses"] = np.asarray(stats["losses"], np.float64)
    out[f"{tag}.auc"] = np.float64(stats["auc"])
    for k, v in eng.ws.items():
        # a join over the group: every rank gets every row
        out[f"{tag}.ws.{k}"] = np.array(v, copy=True)
    # pull_sparse of every row: each rank's own replica on the multi-node
    # layout; where the rows are split across processes a collective that
    # reads the other rank's rows over the group
    rows = torch.arange(eng.ws["show"].shape[0])
    out[f"pull.{tag}"] = embedding.pull_sparse(eng.ws, rows).numpy()
    for i, p in enumerate(tr.model.parameters()):
        out[f"{tag}.param.{i}"] = p.detach().numpy().copy()
    eng.end_pass()
    table(eng, out, tag)


def day(group, run, files, params, out):
    """Two passes of ``files`` through ``fleet.train_passes`` (a
    ctr_double table: f64 show / click on the host)."""
    degrees, path, _ = RUNS[run]
    topo = mw.topology(group, **degrees)
    eng = engine(topo, accessor=tcfg.AccessorConfig(
        accessor_type="ctr_double"))
    ds = fleet.BoxPSDataset(mw.feed_config(), engine=eng, read_threads=1)
    tr = trainer(eng, topo, path, params)
    got = fleet.train_passes(tr, ds, files, date="20260801",
                             prefetch=DAY_RUNS[run])
    out[f"day.{run}.losses"] = np.asarray(
        [x for m in got for x in m["losses"]], np.float64)
    table(eng, out, f"day.{run}")


def collectives(group, out):
    """:func:`collectives_on` dp 2 × sharding 4 over ``group``."""
    collectives_on(mw.topology(group), out)


def collectives_on(topo, out):
    """Each local shard's result of the five collectives that send each
    rank its own parts, on a seeded [8, 8, 3] split over ``topo``'s dp 2
    × sharding 4 (one [8, 3] a shard), and of ``reduce_scatter_onto_shards``
    from sources with a replica on each rank."""
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, (8, 8, 3)).astype(np.float32))
    xs = [None if t is None else t[0]
          for t in topo.split(x, Spec(("dp", "sharding")))]
    every = list(range(topo.world_size))
    got = {
        "reduce_scatter": col.reduce_scatter(xs, topo, "dp"),
        "reduce_scatter_world": col.reduce_scatter(
            xs, topo, ("dp", "sharding")),
        "all_to_all": col.all_to_all(xs, topo, ("dp", "sharding"),
                                     split_dim=0, concat_dim=1),
        "ppermute": col.ppermute(xs, topo, "dp", [(0, 1), (1, 0)]),
        "ppermute_one_way": col.ppermute(
            [None if k == 1 else v for k, v in enumerate(xs)], topo, "dp",
            [(0, 1)]),
    }
    dsts = [0, 5, 3, 6]
    # x[i] held by shards i and i + 4 (one on each rank) for even i, by
    # shard i alone (rank 0) for odd i: a destination reads its own
    # rank's replica where there is one
    reps = [x[i] if i % 2 == 0 or topo.rank == 0 else None
            for i in range(4)]
    for name, res in (
            ("gather_onto", col.gather_onto_shards(xs, every, dsts, topo,
                                                   dim=1)),
            ("reduce_scatter_onto", col.reduce_scatter_onto_shards(
                xs, [(k,) for k in every], dsts, topo, dim=0)),
            ("reduce_scatter_onto_replicas", col.reduce_scatter_onto_shards(
                reps, [(i, i + 4) if i % 2 == 0 else (i,) for i in range(4)],
                dsts, topo, dim=0))):
        got[name] = [None] * topo.world_size
        for k, r in zip(dsts, res):
            got[name][k] = r
    for name, parts in got.items():
        for k in topo.local_shards:
            if parts[k] is not None:
                out[f"col.{name}.{k}"] = parts[k].numpy()


def rows_ops(group, out):
    """``Sharded.locate`` / ``gather_rows`` of this rank's rows and of
    the other rank's, and the join, on a [64, 3] placed over dp 2."""
    topo = mw.topology(group, dp=2)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (64, 3)).astype(np.float32))
    t = topo.place(x, topo.table_spec())
    mine = np.array([63, 40, 32, 33]) - 32 * (1 - topo.rank)
    which, local = t.locate(torch.as_tensor(mine))
    out["rows.which"], out["rows.local"] = which.numpy(), local.numpy()
    out["rows.gathered"] = t.gather_rows(mine, "cpu")[0].numpy()
    # the other rank's rows: a collective, both ranks asking
    out["rows.remote"] = t.gather_rows([5 + 32 * (1 - topo.rank)],
                                       "cpu")[0].numpy()
    out["rows.joined"] = np.asarray(t)


def main():
    out_dir = sys.argv[1]
    rank = launch.init_distributed()
    group = launch.process_group()
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    params = mw.load_params(os.path.join(out_dir, "params.npz"))
    out = {"rank": np.int64(rank)}
    for run in RUNS:
        for packed in (False, True):
            one_pass(group, run, spec["seed"], params, packed, out)
    for run in DAY_RUNS:
        day(group, run, spec["day_files"], params, out)
    collectives(group, out)
    rows_ops(group, out)
    tmp = os.path.join(out_dir, f"rank{rank}.tmp.npz")
    np.savez(tmp, **out)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.npz"))


if __name__ == "__main__":
    main()
