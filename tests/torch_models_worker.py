"""A rank of the trainer family across processes (spawned by
``tests/test_torch_multiprocess_models.py`` through ``python -m
paddlebox_tpu_torch.launch --nproc_per_node 2``).  Imports the port only.

Every rank joins the launcher's gloo group and builds each run's
``HybridTopology(MeshConfig(dp=2), devices=["cpu"],
process_group=launch.process_group())``: rank r holds dp coordinate r's
shard, and the working set's rows are split over the ranks.  Runs:

* ``s`` — ``RankAttentionCTR`` (att_out 8, max_rank 3, MLP (16,)) on a
  pv-aligned pass of four batches of up to 64 records, ``auto`` (→
  ``mxu_sharded``, flat), with the async dense table
  (``sync_weight_step`` 1, the default: a reload after every batch);
* ``a_flat`` / ``a_blocks`` — DeepFM (16,) on
  ``tests/torch_mesh_worker.py``'s pass with the async dense table on
  ``auto`` (→ ``mxu_sharded``) and on explicit ``mxu`` (the row blocks'
  step);
* ``t`` — ``MultiTaskSparseTrainer`` with MMoE (3 experts, 2 tasks) on the
  reference lowering, three batches;
* ``u`` — a three-pass day of DeepFM (16,) on explicit ``mxu`` through
  ``fleet.train_passes``, serial and prefetched, with the device row
  cache on (128 rows: the fold-backs evict) and off;
* ``v`` — ``GraphEmbeddingTrainer`` over a two-community graph: an epoch
  of pairs with the negatives fed in, and the walk loop on the trainer's
  own generator;
* ``rows`` — ``Sharded.gather_rows`` / ``scatter_rows`` and
  ``embedding.pull_sparse`` with each rank asking for other rows, one of
  them for none.

The streaming and packed passes, the multi-task batches and the graph
epoch use the records of ``tests/torch_data_helpers.py`` and the dense
weights in ``<out dir>/weights.pt`` (a state dict a model); the async
table is started from those weights.  On the ranks it is the port's own
table (:class:`CountedTable` only counts the reloads that find grads
not yet applied: none, as a reload across processes waits for the
queue); in one process (no group) the reference's table waits too
(:class:`WaitingTable`), so each reload is the same snapshot on every
run.  ``<out dir>/spec.json`` names the day's pass files,
``<out dir>/graph.npz`` the graph, its pairs and negatives.

    python -m paddlebox_tpu_torch.launch --nproc_per_node 2 \\
        --coordinator 127.0.0.1:<port> tests/torch_models_worker.py <out dir>

Each rank writes ``<out dir>/rank<r>.npz``.  The same functions with
``group`` None run each mesh in one process, one device a dp row
(``torch_mesh_worker.topology``).
"""

import json
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from paddlebox_tpu_torch import config as tcfg  # noqa: E402
from paddlebox_tpu_torch import flags, fleet, launch  # noqa: E402
from paddlebox_tpu_torch.data.dataset import SlotDataset  # noqa: E402
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock  # noqa: E402
from paddlebox_tpu_torch.graph.graph_table import GraphTable  # noqa: E402
from paddlebox_tpu_torch.models.deepfm import DeepFM  # noqa: E402
from paddlebox_tpu_torch.models.mmoe import MMoE  # noqa: E402
from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR  # noqa: E402
from paddlebox_tpu_torch.ps import embedding  # noqa: E402
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine  # noqa: E402
from paddlebox_tpu_torch.trainer import graph_trainer as gt  # noqa: E402
from paddlebox_tpu_torch.trainer.async_dense import AsyncDenseTable  # noqa: E402
from paddlebox_tpu_torch.trainer.multitask import (  # noqa: E402
    MultiTaskSparseTrainer)
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer  # noqa: E402
from paddlebox_tpu_torch.utils.monitor import stat_get  # noqa: E402

import torch_data_helpers as dh  # noqa: E402
import torch_mesh_worker as mw  # noqa: E402

TORCH = types.SimpleNamespace(Feed=tcfg.DataFeedConfig, Slot=tcfg.SlotConfig,
                              Block=SlotRecordBlock, Dataset=SlotDataset)
MESH = dict(dp=2)
E = 3 + dh.MF
RANK_KW = dict(att_out=8, max_rank=3, hidden=(16,))
MMOE_KW = dict(num_experts=3, num_tasks=2, expert_hidden=(16, 8),
               tower_hidden=(8,))
ASYNC = dict(dense_sync_mode="async_table", sync_weight_step=1)
PASSES = ("streaming", "packed")
# async run: sparse_path on dp 2 (auto → mxu_sharded; mxu → the blocks)
ASYNC_RUNS = {"a_flat": "auto", "a_blocks": "mxu"}
DAY_MODES = ("serial", "prefetch")
CACHE_ROWS = 128
CACHE_COUNTERS = ("ps.cache.hits", "ps.cache.misses", "ps.cache.evictions",
                  "ps.cache.gather_fallback_rows")
GRAPH_K, GRAPH_LR, GRAPH_SEED, GRAPH_BATCH = 4, 0.1, 7, 1024
RANK_SEED = 1
# rows rank 0 asks for (of both ranks' blocks, one twice) while rank 1
# asks for none, then the other way round
ROWS_ASKED = ([40, 5, 63, 0, 33, 40], [])


class CountedTable(AsyncDenseTable):
    """A rank's async table: the port's own, with its pulls counted, and
    those that found a pushed grad not yet applied."""
    pulls = behind = 0

    def pull(self):
        self.pulls += 1
        self.behind += self.applied < self.pushed
        return super().pull()


class WaitingTable(CountedTable):
    """The one-process reference's async table: its ``pull`` waits until
    every pushed grad is applied, as a rank's reload across processes
    does (in one process the plain pull reads whatever the update thread
    has applied so far)."""

    def pull(self):
        self.drain()
        return super().pull()


def load_weights(tr, state):
    """The dense weights ``state`` into the trainer's model, and under the
    async table a table started from them (the trainer seeded its own
    from the model's init): a :class:`CountedTable` on a rank, a
    :class:`WaitingTable` in one process."""
    tr.model.load_state_dict(state)
    if tr.async_dense is not None:
        tc = tr.trainer_config
        spans = tr.topology is not None and tr.topology.spans_processes
        tr.async_dense.finalize()
        tr.async_dense = (CountedTable if spans else WaitingTable)(
            {n: p.detach().numpy() for n, p in tr.model.named_parameters()},
            learning_rate=tc.async_dense_learning_rate,
            beta1=tc.async_dense_beta1, beta2=tc.async_dense_beta2,
            eps=tc.async_dense_eps)


def begin(topo, datasets, deepfm=False):
    """An engine on ``topo`` over every key of ``datasets``, its pass
    begun: ``tests/test_torch_multicard_models.py``'s table (host rows
    from seed 7), or with ``deepfm`` ``tests/torch_mesh_worker.py``'s."""
    if deepfm:
        table = tcfg.EmbeddingTableConfig(
            embedding_dim=mw.MF, sgd=tcfg.SparseSGDConfig(
                mf_create_thresholds=0.0))
        eng = BoxPSEngine(table, topology=topo)
    else:
        table = tcfg.EmbeddingTableConfig(
            embedding_dim=dh.MF, shard_num=4, sgd=tcfg.SparseSGDConfig(
                mf_create_thresholds=1.0))
        eng = BoxPSEngine(table, seed=7, topology=topo)
    eng.begin_feed_pass()
    for ds in datasets:
        for blk in ds.get_blocks():
            eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    return eng


def record(out, tag, eng, tr, losses, auc=None):
    """A pass's losses, AUC, the working set joined over the group, the
    dense params, the async table (with its pushes, applied pushes,
    reloads and reloads behind the queue), then end_pass and the host
    table."""
    out[f"{tag}.path"] = np.array(tr._resolve_path())
    out[f"{tag}.losses"] = np.asarray(losses, np.float64)
    if auc is not None:
        out[f"{tag}.auc"] = np.asarray(auc, np.float64)
    for k, v in eng.ws.items():
        out[f"{tag}.ws.{k}"] = np.array(v, copy=True)
    for i, p in enumerate(tr.model.parameters()):
        out[f"{tag}.param.{i}"] = p.detach().numpy().copy()
    if tr.async_dense is not None:
        t = tr.async_dense
        out[f"{tag}.async.counts"] = np.array([t.pushed, t.applied, t.pulls,
                                               t.behind])
        for n, v in tr.async_dense.finalize().items():
            out[f"{tag}.async.{n}"] = v
    eng.end_pass()
    table(eng, out, tag)


def table(eng, out, tag):
    keys = np.sort(eng.table.export_keys())
    out[f"{tag}.table.keys"] = keys
    for f, v in eng.table.bulk_pull(keys).items():
        out[f"{tag}.table.{f}"] = v


def rank_data(pkg):
    """The page-view pass of run ``s`` in ``pkg``'s classes."""
    return dh.pv_pass(pkg, RANK_SEED, nb=4, b=dh.B, rank_offset=True,
                      ads_offset=True, max_rank=3)


def rank_run(group, packed, state, out):
    """Run ``s``: the page-view model with the async table."""
    topo = mw.topology(group, **MESH)
    cfg, ds = rank_data(TORCH)
    eng = begin(topo, [ds])
    tr = SparseTrainer(eng, RankAttentionCTR(dh.S, E, dh.DENSE, **RANK_KW),
                       cfg, batch_size=dh.B, seed=3, topology=topo,
                       device="cpu",
                       trainer_config=tcfg.TrainerConfig(**ASYNC))
    load_weights(tr, state)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    record(out, f"s.{PASSES[packed]}", eng, tr, stats["losses"],
           stats["auc"])


def async_run(group, run, packed, state, seed, out):
    """Runs ``a_flat`` / ``a_blocks``: DeepFM with the async table."""
    topo = mw.topology(group, **MESH)
    ds = mw.dataset(seed)
    eng = begin(topo, [ds], deepfm=True)
    tr = SparseTrainer(eng, DeepFM(mw.N_SLOTS, 3 + mw.MF, mw.DENSE_DIM,
                                   hidden=(16,)),
                       mw.feed_config(), batch_size=mw.B, seed=0,
                       topology=topo, sparse_path=ASYNC_RUNS[run],
                       device="cpu",
                       trainer_config=tcfg.TrainerConfig(**ASYNC))
    load_weights(tr, state)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    record(out, f"{run}.{PASSES[packed]}", eng, tr, stats["losses"],
           stats["auc"])


def multitask_run(group, packed, state, out):
    """Run ``t``: MMoE through the multi-task trainer, one train_pass a
    batch; the per-task AUC after the last."""
    topo = mw.topology(group, **MESH)
    cfg, data = dh.datasets(TORCH, n_labels=2)
    eng = begin(topo, data)
    tr = MultiTaskSparseTrainer(eng, MMoE(dh.S, E, dh.DENSE, **MMOE_KW), cfg,
                                batch_size=dh.B,
                                label_slots=dh.label_names(2), seed=3,
                                topology=topo, device="cpu")
    load_weights(tr, state)
    stats = [tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
             for ds in data]
    record(out, f"t.{PASSES[packed]}", eng, tr,
           [x for s in stats for x in s["losses"]],
           [stats[-1][f"task{t}_auc"] for t in range(2)])


def day_run(group, files, prefetch, cache, state, out):
    """Run ``u``: a day of ``files`` (one pass each) on explicit mxu with
    the device row cache on or off; the losses, the cache's counters over
    the day, the dense params and the host table."""
    names = ("ps_device_cache", "ps_device_cache_rows")
    old = {n: flags.get_flags(n) for n in names}
    flags.set_flags({"ps_device_cache": cache,
                     "ps_device_cache_rows": CACHE_ROWS})
    try:
        topo = mw.topology(group, **MESH)
        eng = BoxPSEngine(tcfg.EmbeddingTableConfig(
            embedding_dim=mw.MF, sgd=tcfg.SparseSGDConfig(
                mf_create_thresholds=0.0)), topology=topo)
    finally:
        flags.set_flags(old)
    assert (eng.cache is not None) == cache
    ds = fleet.BoxPSDataset(mw.feed_config(), engine=eng, read_threads=1)
    tr = SparseTrainer(eng, DeepFM(mw.N_SLOTS, 3 + mw.MF, mw.DENSE_DIM,
                                   hidden=(16,)),
                       mw.feed_config(), batch_size=mw.B, seed=0,
                       topology=topo, sparse_path="mxu", device="cpu")
    load_weights(tr, state)
    c0 = {k: stat_get(k) for k in CACHE_COUNTERS}
    got = fleet.train_passes(tr, ds, files, date="20260801",
                             prefetch=prefetch)
    tag = f"u.{DAY_MODES[prefetch]}.{'on' if cache else 'off'}"
    out[f"{tag}.losses"] = np.asarray([x for m in got for x in m["losses"]],
                                      np.float64)
    for i, p in enumerate(tr.model.parameters()):
        out[f"{tag}.param.{i}"] = p.detach().numpy().copy()
    if cache:
        out[f"{tag}.cache"] = np.array([stat_get(k) - c0[k]
                                        for k in CACHE_COUNTERS])
        out[f"{tag}.cache.resident"] = np.int64(eng.cache.resident_rows)
    table(eng, out, tag)


def graph_case(path):
    with np.load(path) as z:
        return (z["edges"], int(z["n"]), z["pairs"],
                [z[f"negs.{i}"] for i in range(int(z["steps"]))])


def graph_engine(topo, n):
    eng = BoxPSEngine(tcfg.EmbeddingTableConfig(
        embedding_dim=8, shard_num=4,
        sgd=tcfg.SparseSGDConfig(mf_create_thresholds=0.0,
                                 mf_initial_range=0.1)),
        seed=0, topology=topo)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, n + 1, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    for _, blk in eng.ws["mf_size"].unique():
        blk.fill_(8)
    return eng


def graph_run(group, case, out):
    """Run ``v``: an epoch of the case's pairs with its negatives fed in,
    then the walk loop (walks, pairs and negatives from the trainer's
    seed); each ends with end_pass."""
    edges, n, pairs, negs = case
    topo = mw.topology(group, **MESH)
    for tag in ("v.pairs", "v.walks"):
        eng = graph_engine(topo, n)
        tr = gt.GraphEmbeddingTrainer(
            eng, GraphTable(edges, num_nodes=n + 1, device="cpu"),
            n_negatives=GRAPH_K, learning_rate=GRAPH_LR, seed=GRAPH_SEED)
        if tag == "v.pairs":
            it = iter(negs)
            tr.draw_negatives = lambda b: torch.from_numpy(next(it))
            loss = tr.train_pairs(pairs, batch_size=GRAPH_BATCH)
        else:
            loss = tr.train_walks(np.arange(1, n + 1), length=6,
                                  batch_size=256, seed=3)
        out[f"{tag}.loss"] = np.float64(loss)
        out[f"{tag}.losses"] = np.asarray(tr.stats["losses"], np.float64)
        for f in ("mf", "mf_g2sum"):
            out[f"{tag}.ws.{f}"] = np.array(eng.ws[f], copy=True)
        eng.end_pass()
        table(eng, out, tag)


def rows_run(group, out):
    """On a seeded [64, 3] placed over dp 2 (rank r holds rows [32 r,
    32 r + 32)): ``gather_rows`` with rank 0 asking for rows of both
    blocks and rank 1 for none, then the other way round;
    ``scatter_rows`` of rows rank 0 holds alone; ``pull_sparse`` of a
    working set's rows, each rank asking for its own ids."""
    topo = mw.topology(group, **MESH)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (64, 3)).astype(np.float32))
    t = topo.place(x, topo.table_spec())
    for turn in (0, 1):
        mine = ROWS_ASKED[topo.rank ^ turn]
        out[f"rows.gathered.{turn}"] = t.gather_rows(mine, "cpu")[0].numpy()
    t.scatter_rows([1, 2, 3], torch.full((3, 3), 7.0), "cpu")
    out["rows.scattered"] = np.asarray(t)
    eng = begin(topo, [mw.dataset(0)], deepfm=True)
    n = eng.ws["show"].shape[0]
    ids = torch.as_tensor(np.random.default_rng(2 + topo.rank).integers(
        0, n, (5, 7)))
    out["rows.pull_ids"] = ids.numpy()
    out["rows.pull"] = embedding.pull_sparse(eng.ws, ids).numpy()
    for f in ("show", "click", "embed_w", "mf", "mf_size"):
        out[f"rows.ws.{f}"] = np.asarray(eng.ws[f])


def run_all(group, spec, states, out):
    """Every run, in one order on every rank."""
    for packed in (False, True):
        rank_run(group, packed, states["rank"], out)
        for run in ASYNC_RUNS:
            async_run(group, run, packed, states["deepfm"], spec["seed"],
                      out)
        multitask_run(group, packed, states["mmoe"], out)
    for prefetch in (False, True):
        for cache in (False, True):
            day_run(group, spec["day_files"], prefetch, cache,
                    states["deepfm"], out)
    graph_run(group, graph_case(spec["graph"]), out)
    rows_run(group, out)


def load_states(out_dir):
    return torch.load(os.path.join(out_dir, "weights.pt"), weights_only=True)


def main():
    out_dir = sys.argv[1]
    rank = launch.init_distributed()
    group = launch.process_group()
    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    out = {"rank": np.int64(rank)}
    run_all(group, spec, load_states(out_dir), out)
    tmp = os.path.join(out_dir, f"rank{rank}.tmp.npz")
    np.savez(tmp, **out)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.npz"))


if __name__ == "__main__":
    main()
