"""The trainer family across processes: two ranks under ``python -m
paddlebox_tpu_torch.launch --nproc_per_node 2`` (``tests/
torch_models_worker.py``, which imports the port only, on
``device="cpu"``), one dp coordinate a rank over the launcher's gloo
group, each holding its own row blocks of the working set (dp 2).

Runs: (s) ``RankAttentionCTR`` with the async dense table on ``auto`` (→
``mxu_sharded``, flat), on a page-view pass whose page views straddle
the two ranks' batch blocks; the async table alone with DeepFM on
``auto`` (``a_flat``) and on explicit ``mxu`` (``a_blocks``, the row
blocks' step); (t) ``MultiTaskSparseTrainer`` with MMoE; (u) a
three-pass day through ``fleet.train_passes`` with the device row cache
on and off, serial and prefetched; (v) ``GraphEmbeddingTrainer``, an
epoch with the JAX trainer's negatives fed in and the walk loop; and
``Sharded.gather_rows`` / ``scatter_rows`` / ``embedding.pull_sparse``
of the other rank's rows.  The configurations are
``tests/test_torch_multicard_models.py``'s and
``tests/test_torch_multicard.py``'s (4 slots × capacity 3, mf_dim 4, 3
dense, batch 64).

Each run is held three ways.  The ranks are bit-equal to each other
(losses, AUC, per task for MMoE, the working set joined over the group,
the dense params, the async tables, the host tables after ``end_pass``
and after the day, the cache's hits, misses and evictions) and to the
same mesh in one process with one device a dp row (the worker's
functions with no group).  The one process holds the JAX package's
tolerances against it: the pass loss rtol 1e-4; the working set and the
dense params rtol 1e-5 / atol 1e-6; integer fields equal; a task's AUC
within 1e-6; the graph's loss, ``mf`` and ``mf_g2sum`` rtol 1e-5 / atol
1e-7.  The JAX package runs the page-view model, the async table and the
day on the same mesh over its virtual CPU devices; its multi-task and
graph trainers take no mesh, so those are held against its one-device
run (the function GSPMD computes for the sharded table and batch).  Both
packages' async tables start from the same weights and reload after
every batch (``sync_weight_step`` 1) a snapshot taken after their queue
drained: on the ranks the port's own reload waits across processes; the
one-process reference (``torch_models_worker.WaitingTable``) and the JAX
package's table (patched here) wait alike, so every reload is
deterministic.  A cached day equals the uncached day
bit for bit.  One spawn serves every test of the file.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu import config as jcfg
from paddlebox_tpu import fleet as jfleet
from paddlebox_tpu.graph.graph_table import GraphTable as JGraph
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.models.mmoe import MMoE as JMMoE
from paddlebox_tpu.models.rank_ctr import RankAttentionCTR as JRankCTR
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.trainer import graph_trainer as jgt
from paddlebox_tpu.trainer.async_dense import AsyncDenseTable as JTable
from paddlebox_tpu.trainer.multitask import (
    MultiTaskSparseTrainer as JMultiTask)
from paddlebox_tpu.trainer.trainer import SparseTrainer as JTrainer
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.models.mmoe import MMoE as TMMoE
from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR as TRankCTR

import test_torch_graph_trainer as gtest
import test_torch_multiprocess as mp
import test_torch_mxu_sharded_trainer as base
import torch_mesh_worker as mw
import torch_models_worker as wk
import torch_parity_helpers as h

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_models_worker.py")
SEED = 7
SPAWN_TIMEOUT_S = 180
TOL = dict(rtol=1e-5, atol=1e-6)
GRAPH_TOL = dict(rtol=1e-5, atol=1e-7)
DAY_PASSES = 3

TRAINED = ([f"s.{p}" for p in wk.PASSES]
           + [f"{r}.{p}" for r in wk.ASYNC_RUNS for p in wk.PASSES]
           + [f"t.{p}" for p in wk.PASSES])
DAYS = [f"u.{m}.{c}" for m in wk.DAY_MODES for c in ("off", "on")]
GRAPHS = ["v.pairs", "v.walks"]
PREFIXES = TRAINED + DAYS + GRAPHS
# the lowering each run resolves to
PATHS = {"s": "mxu_sharded", "a_flat": "mxu_sharded", "a_blocks": "mxu",
         "t": "reference"}


def _jax_async(trainer_cls, *a, **kw):
    return trainer_cls(*a, trainer_config=jcfg.TrainerConfig(**wk.ASYNC),
                       **kw)


def _rank_jax(packed):
    """Run (s) through the JAX package on dp 2 over its virtual devices:
    (its init, stats, working set, params, async table)."""
    cfg, ds = wk.rank_data(h.JAX)
    eng = _jax_engine([ds])
    tr = _jax_async(JTrainer, eng, JRankCTR(h.S, wk.E, h.DENSE,
                                            **wk.RANK_KW),
                    cfg, batch_size=h.B, seed=3,
                    topology=base.jax_topo(**wk.MESH))
    init = jax.tree.map(np.asarray, tr.params)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    return init, stats, h.ws_numpy(eng), jax.tree.map(
        np.asarray, tr.params), tr.async_dense.finalize()


def _jax_engine(data):
    eng = h.JAX.Engine(h.JAX.Table(embedding_dim=h.MF, shard_num=4,
                                   sgd=h.JAX.Sgd(mf_create_thresholds=1.0)),
                       seed=7, topology=base.jax_topo(**wk.MESH))
    eng.begin_feed_pass()
    for ds in data:
        for blk in ds.get_blocks():
            eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    return eng


def _async_jax(run, packed):
    """The async runs through the JAX package on dp 2 (DeepFM (16,))."""
    cfg = base._feed_config(jcfg)
    ds = h.JAX.Dataset(cfg)
    ds._blocks = [base._block(h.JAX.Block, SEED)]
    eng = JEngine(jcfg.EmbeddingTableConfig(
        embedding_dim=base.MF, sgd=jcfg.SparseSGDConfig(
            mf_create_thresholds=0.0)), topology=base.jax_topo(**wk.MESH))
    eng.begin_feed_pass()
    for b in ds.get_blocks():
        eng.add_keys(b.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    tr = _jax_async(JTrainer, eng, JDeepFM(num_slots=base.N_SLOTS,
                                           emb_width=3 + base.MF,
                                           dense_dim=base.DENSE_DIM,
                                           hidden=(16,)),
                    cfg, batch_size=base.B, seed=0,
                    topology=base.jax_topo(**wk.MESH),
                    sparse_path=wk.ASYNC_RUNS[run])
    init = jax.tree.map(np.asarray, tr.params)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    return init, stats, h.ws_numpy(eng), jax.tree.map(
        np.asarray, tr.params), tr.async_dense.finalize()


def _multitask_jax():
    """The JAX multi-task trainer's one-device streaming run."""
    cfg, data = h.datasets(h.JAX, n_labels=2)
    eng = h.engine(h.JAX, data)
    tr = JMultiTask(eng, JMMoE(h.S, wk.E, h.DENSE, **wk.MMOE_KW), cfg,
                    batch_size=h.B, label_slots=h.label_names(2), seed=3)
    init = jax.tree.map(np.asarray, tr.params)
    stats = h.train_batches(tr, data)
    return init, stats, h.ws_numpy(eng), jax.tree.map(np.asarray, tr.params)


def _day_jax(files):
    """The uncached day through the JAX package's ``fleet.train_passes``
    on dp 2, explicit mxu, from the DeepFM init (seed 0, as the async
    runs'): (losses, keys, table)."""
    topo = base.jax_topo(**wk.MESH)
    eng = JEngine(jcfg.EmbeddingTableConfig(
        embedding_dim=base.MF, sgd=jcfg.SparseSGDConfig(
            mf_create_thresholds=0.0)), topology=topo)
    cfg = base._feed_config(jcfg)
    ds = jfleet.BoxPSDataset(cfg, engine=eng, read_threads=1)
    tr = JTrainer(eng, JDeepFM(num_slots=base.N_SLOTS, emb_width=3 + base.MF,
                               dense_dim=base.DENSE_DIM, hidden=(16,)),
                  cfg, batch_size=base.B, seed=0, topology=topo,
                  sparse_path="mxu")
    got = jfleet.train_passes(tr, ds, files, date="20260801", prefetch=False)
    keys = np.sort(eng.table.export_keys())
    return [m["loss"] for m in got], keys, eng.table.bulk_pull(keys)


def _graph_case(seed=5000):
    rng = np.random.default_rng(seed)
    edges, n = gtest._two_communities(rng)
    pairs = rng.integers(0, n + 1, (seed, 2)).astype(np.int32)
    steps = -(-len(pairs) // wk.GRAPH_BATCH)
    negs = gtest._jax_negatives(wk.GRAPH_SEED, steps, wk.GRAPH_BATCH,
                                wk.GRAPH_K, n)
    return edges, n, pairs, negs


def _graph_jax(case):
    edges, n, pairs, _ = case
    jeng, _ = gtest._engines(n)
    jtr = jgt.GraphEmbeddingTrainer(jeng, JGraph(edges, num_nodes=n + 1),
                                    n_negatives=wk.GRAPH_K,
                                    learning_rate=wk.GRAPH_LR,
                                    seed=wk.GRAPH_SEED)
    loss = jtr.train_pairs(jnp.asarray(pairs), batch_size=wk.GRAPH_BATCH)
    return loss, {f: np.asarray(jeng.ws[f]) for f in ("mf", "mf_g2sum")}


def _drained_jax_pulls():
    plain = JTable.pull

    def pull(self):
        self.drain()
        return plain(self)
    return mock.patch.object(JTable, "pull", pull)


def _state(model, params):
    model.load_jax_params(params)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX reference, and the dense weights the port starts from
    (the JAX inits as state dicts)."""
    out = {}
    with _drained_jax_pulls():
        for packed in (False, True):
            name = wk.PASSES[packed]
            out[f"s.{name}"] = _rank_jax(packed)
            for run in wk.ASYNC_RUNS:
                out[f"{run}.{name}"] = _async_jax(run, packed)
    out["t"] = _multitask_jax()
    states = {
        "rank": _state(TRankCTR(h.S, wk.E, h.DENSE, **wk.RANK_KW),
                       out["s.streaming"][0]),
        "deepfm": _state(TDeepFM(base.N_SLOTS, 3 + base.MF, base.DENSE_DIM,
                                 hidden=(16,)), out["a_flat.streaming"][0]),
        "mmoe": _state(TMMoE(h.S, wk.E, h.DENSE, **wk.MMOE_KW),
                       out["t"][0])}
    case = _graph_case()
    out["v.pairs"] = _graph_jax(case)
    return out, states, case


@pytest.fixture(scope="module")
def work(jax_runs, tmp_path_factory):
    """The spawn's directory: the weights, the day's pass files and the
    graph case."""
    _, states, case = jax_runs
    out = tmp_path_factory.mktemp("models")
    torch.save(states, out / "weights.pt")
    edges, n, pairs, negs = case
    np.savez(out / "graph.npz", edges=edges, n=n, pairs=pairs,
             steps=len(negs), **{f"negs.{i}": x for i, x in enumerate(negs)})
    files = _day_files(out, DAY_PASSES)
    with open(out / "spec.json", "w") as f:
        json.dump({"seed": SEED, "day_files": files,
                   "graph": str(out / "graph.npz")}, f)
    return out


def _day_files(root, n):
    """``n`` pass files of 128 records (two batches) each."""
    files = []
    for p in range(n):
        path = os.path.join(root, f"day{p}.txt")
        rng = np.random.default_rng(40 + p)
        with open(path, "w") as f:
            for _ in range(128):
                parts = [f"1 {rng.integers(0, 2)}",
                         f"{mw.DENSE_DIM} " + " ".join(
                             f"{rng.normal():.4f}"
                             for _ in range(mw.DENSE_DIM))]
                for _s in range(mw.N_SLOTS):
                    k = rng.integers(1, mw.CAP + 1)
                    parts.append(f"{k} " + " ".join(
                        str(rng.integers(1, 300)) for _ in range(k)))
                f.write(" ".join(parts) + "\n")
        files.append([path])
    return files


@pytest.fixture(scope="module")
def spawned(work):
    """The two ranks, started (``torch_models_worker``)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.launch",
         "--nproc_per_node", "2", "--coordinator",
         f"127.0.0.1:{mp._free_port()}", WORKER, str(work)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def one_process(spawned, work, jax_runs):
    """The worker's runs with no group, while the ranks run: each mesh in
    one process, one device a dp row; and the JAX package's day."""
    with open(work / "spec.json") as f:
        spec = json.load(f)
    out = {}
    wk.run_all(None, spec, wk.load_states(str(work)), out)
    return out, _day_jax(spec["day_files"])


@pytest.fixture(scope="module")
def ranks(spawned, work, one_process):
    """Both ranks' results."""
    try:
        stdout, stderr = spawned.communicate(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        spawned.kill()
        spawned.communicate()
        pytest.fail(f"the two ranks did not finish in {SPAWN_TIMEOUT_S} s")
    assert spawned.returncode == 0, stdout[-3000:] + stderr[-3000:]
    got = []
    for r in range(2):
        with np.load(work / f"rank{r}.npz") as z:
            got.append(dict(z))
    assert [int(g["rank"]) for g in got] == [0, 1]
    return got


def _keys(res, prefix):
    return sorted(k for k in res if k.startswith(prefix + "."))


@pytest.mark.parametrize("prefix", PREFIXES)
def test_ranks_bit_equal(ranks, prefix):
    """Every recorded array of the run the same bits on both ranks: the
    losses, AUC, working set, dense params, async table and host table
    (and the cache's counters of the day)."""
    a, b = ranks
    keys = _keys(a, prefix)
    assert keys == _keys(b, prefix) and f"{prefix}.table.keys" in keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    run = prefix.split(".")[0]
    if run in PATHS:
        assert str(a[f"{prefix}.path"]) == PATHS[run]


@pytest.mark.parametrize("prefix", PREFIXES)
def test_ranks_equal_one_process_bitwise(ranks, one_process, prefix):
    """Each rank = the mesh in one process with one device a dp row, bit
    for bit."""
    want = one_process[0]
    keys = _keys(want, prefix)
    assert keys
    for res in ranks:
        assert _keys(res, prefix) == keys
        for k in keys:
            np.testing.assert_array_equal(res[k], want[k], err_msg=k)


def _as_jax(model, res, prefix):
    """The recorded params of ``prefix`` as ``model``'s JAX pytree."""
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.as_tensor(res[f"{prefix}.param.{i}"]))
    return model.jax_params()


def _assert_ws(res, prefix, want):
    for k in want:
        got = res[f"{prefix}.ws.{k}"]
        if want[k].dtype == np.int32:
            np.testing.assert_array_equal(got, want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got, want[k], err_msg=k, **TOL)


MODELS = {"s": lambda: TRankCTR(h.S, wk.E, h.DENSE, **wk.RANK_KW),
          "a_flat": lambda: TDeepFM(base.N_SLOTS, 3 + base.MF,
                                    base.DENSE_DIM, hidden=(16,)),
          "a_blocks": lambda: TDeepFM(base.N_SLOTS, 3 + base.MF,
                                      base.DENSE_DIM, hidden=(16,)),
          "t": lambda: TMMoE(h.S, wk.E, h.DENSE, **wk.MMOE_KW)}


@pytest.mark.parametrize("prefix", [p for p in TRAINED
                                    if not p.startswith("t.")])
def test_one_process_matches_jax_on_its_mesh(one_process, jax_runs, prefix):
    """The page-view model and the async table against the JAX package on
    dp 2 over its virtual CPU devices: the loss, AUC, working set, dense
    params and the async table's params."""
    res = one_process[0]
    _, js, jws, jparams, jtable = jax_runs[0][prefix]
    assert len(res[f"{prefix}.losses"]) == js["batches"]
    np.testing.assert_allclose(res[f"{prefix}.losses"].mean(), js["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(res[f"{prefix}.auc"], js["auc"], rtol=1e-4)
    _assert_ws(res, prefix, jws)
    run = prefix.split(".")[0]
    h.assert_tree_close(_as_jax(MODELS[run](), res, prefix), jparams, **TOL)
    counts = res[f"{prefix}.async.counts"]
    # a reload after every batch and one at the end of the pass, none of
    # them behind the queue (the ranks equal these counts bit for bit)
    assert counts.tolist() == [js["batches"]] * 2 + [js["batches"] + 1, 0]
    model = MODELS[run]()
    names = [n for n, _ in model.named_parameters()]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(res[f"{prefix}.async.{n}"]))
    h.assert_tree_close(model.jax_params(), jax.tree.map(np.asarray,
                                                         jtable), **TOL)
    # the module ends the pass on the table's params
    for i, n in enumerate(names):
        np.testing.assert_array_equal(res[f"{prefix}.param.{i}"],
                                      res[f"{prefix}.async.{n}"])


@pytest.mark.parametrize("name", wk.PASSES)
def test_multitask_matches_jax(one_process, jax_runs, name):
    """MMoE against the JAX multi-task trainer's one-device streaming
    run of the same batches: each batch's loss, each task's AUC, the
    working set and the params."""
    res, prefix = one_process[0], f"t.{name}"
    _, js, jws, jparams = jax_runs[0]["t"]
    np.testing.assert_allclose(res[f"{prefix}.losses"],
                               [s["loss"] for s in js], rtol=1e-4)
    for t in range(2):
        np.testing.assert_allclose(res[f"{prefix}.auc"][t],
                                   js[-1][f"task{t}_auc"], rtol=0,
                                   atol=1e-6)
    _assert_ws(res, prefix, jws)
    h.assert_tree_close(_as_jax(MODELS["t"](), res, prefix), jparams, **TOL)


def test_graph_matches_jax(one_process, jax_runs):
    """The epoch with the JAX trainer's negatives against its one-device
    run (its graph trainer takes no mesh)."""
    res = one_process[0]
    loss, jws = jax_runs[0]["v.pairs"]
    np.testing.assert_allclose(res["v.pairs.loss"], loss, rtol=1e-5)
    for f, want in jws.items():
        np.testing.assert_allclose(res[f"v.pairs.ws.{f}"], want, err_msg=f,
                                   **GRAPH_TOL)


def test_day_matches_jax(one_process):
    """The uncached serial day against the JAX package's
    ``fleet.train_passes`` on dp 2, explicit mxu: each pass's loss and
    the host table after the day."""
    res, (jlosses, jkeys, jrows) = one_process
    prefix = "u.serial.off"
    np.testing.assert_allclose(
        res[f"{prefix}.losses"].reshape(DAY_PASSES, -1).mean(1), jlosses,
        rtol=1e-4)
    np.testing.assert_array_equal(res[f"{prefix}.table.keys"], jkeys)
    for f, want in jrows.items():
        got = res[f"{prefix}.table.{f}"]
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, err_msg=f, **TOL)


@pytest.mark.parametrize("mode", wk.DAY_MODES)
def test_cached_day_equals_uncached(ranks, mode):
    """On each rank the day with the device row cache on equals the day
    with it off bit for bit: the losses, the dense params and the host
    table.  The cache hit (a warm pass: the second serial pass, the
    third prefetched one, whose snapshot follows the first's fold-back)
    and its 128 rows evicted."""
    for res in ranks:
        on, off = f"u.{mode}.on", f"u.{mode}.off"
        keys = [k[len(off):] for k in _keys(res, off)]
        assert ".table.keys" in keys
        for k in keys:
            np.testing.assert_array_equal(res[on + k], res[off + k],
                                          err_msg=k)
        hits, misses, evictions, _ = res[f"{on}.cache"]
        assert hits > 0 and misses > 0 and evictions > 0
        assert int(res[f"{on}.cache.resident"]) == wk.CACHE_ROWS


def test_page_views_straddle_the_ranks():
    """Run (s)'s pass: page views whose ranked ads have peers in the
    other rank's batch block (rows [0, 32) are rank 0's, [32, 64) rank
    1's)."""
    cfg, ds = wk.rank_data(h.TORCH)
    eng = h.engine(h.TORCH, [ds])
    tr = h.TORCH.Trainer(eng, TRankCTR(h.S, wk.E, h.DENSE, **wk.RANK_KW),
                         cfg, batch_size=h.B, seed=3, device="cpu")
    arrays = tr.pack_pass_host(ds)
    ro = arrays.rank_offset.reshape(arrays.n_batches, h.B, -1)
    crossing = 0
    for i in range(arrays.n_batches):
        for r in range(h.B):
            if ro[i, r, 0] <= 0:
                continue
            peers = ro[i, r, 2::2][ro[i, r, 1::2] > 0]
            crossing += int(np.any(peers // (h.B // 2) != r // (h.B // 2)))
    assert arrays.n_batches >= 3 and crossing > 0


def test_gather_and_scatter_rows_across_processes(ranks):
    """``gather_rows`` returns each rank's own rows in its own order, the
    other rank's included, also while the other rank asks for none;
    ``scatter_rows`` of rows rank 0 alone holds writes them there and
    nothing on rank 1; the join shows both."""
    x = np.random.default_rng(1).normal(0, 1, (64, 3)).astype(np.float32)
    y = x.copy()
    y[1:4] = 7.0
    for r, res in enumerate(ranks):
        for turn in (0, 1):
            rows = wk.ROWS_ASKED[r ^ turn]
            got = res[f"rows.gathered.{turn}"]
            assert got.shape == (len(rows), 3)
            np.testing.assert_array_equal(got, x[rows])
        np.testing.assert_array_equal(res["rows.scattered"], y)


def test_pull_sparse_across_processes(ranks, one_process):
    """``pull_sparse`` of each rank's own ids over the split set: the
    plain pull of the joined working set, bit for bit (a select), and
    rank 0's equal to one process's."""
    from paddlebox_tpu_torch.ps import embedding
    for res in ranks:
        ws = {f: torch.as_tensor(res[f"rows.ws.{f}"])
              for f in ("show", "click", "embed_w", "mf", "mf_size")}
        want = embedding.pull_sparse(ws, torch.as_tensor(res["rows.pull_ids"]))
        assert want.shape == (5, 7, 3 + mw.MF)
        np.testing.assert_array_equal(res["rows.pull"], want.numpy())
    assert not np.array_equal(ranks[0]["rows.pull_ids"],
                              ranks[1]["rows.pull_ids"])
    np.testing.assert_array_equal(ranks[0]["rows.pull"],
                                  one_process[0]["rows.pull"])
