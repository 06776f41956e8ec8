"""The lowerings and the device row cache with the shards on distinct
devices, on a card.

JAX-free on purpose, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_multicard_cuda.py

Without a card every test here skips.  With one card the topologies pair
it with the host: dp 2 over ``cuda:0`` and ``cpu``, and dp 2 × sharding 2
with one node on each (a test topology: the host shards run the kernels'
plain versions only because their tensors live in host memory).  With
two or more cards the same runs also go over ``cuda:0`` and ``cuda:1``.
Each is held against the same mesh on one card within the tolerances of
``tests/test_torch_multicard.py``: losses rtol 1e-4, the working set
rtol 1e-5 / atol 1e-6, mf_size equal and the slot column's touched rows
equal.  The lowerings are ``mxu_sharded`` and explicit ``mxu``, ``fast``
and ``reference`` (and ``auto`` on dp 2 × mp 2, which resolves to
``fast``), each kernel launched its predicted number of times a step on
the card and never for the host's blocks; the day loop with the device
row cache on equals it off bit for bit.  The page-view model
(``RankAttentionCTR`` on ``auto`` → mxu_sharded and ``fast``), the
multi-task trainer (MMoE, two tasks) and graph learning run there too,
held against one card the same way (the graph: ``mf`` and ``mf_g2sum``).
"""

import numpy as np
import pytest
import torch

from torch_port_fixtures import cuda_device  # noqa: F401

from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        MeshConfig, SlotConfig,
                                        SparseSGDConfig)
from paddlebox_tpu_torch.data.dataset import SlotDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.ops import pallas_gather as pg
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.parallel.topology import (HybridTopology, Sharded,
                                                   same_device)
from paddlebox_tpu_torch.ps import sharded_embedding as se
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer

N_SLOTS, CAP, MF, DENSE, B, N_BATCHES = 4, 3, 4, 3, 256, 3
MESHES = {"flat": dict(dp=2), "multinode": dict(dp=2, sharding=2)}


def _layouts():
    """(name, devices of each mesh's shards): the card beside the host,
    and with two cards, the two cards."""
    out = [("card_host", lambda n: ["cuda:0"] * (n // 2) + ["cpu"] * (n // 2))]
    if torch.cuda.device_count() >= 2:
        out.append(("two_cards",
                    lambda n: ["cuda:0"] * (n // 2) + ["cuda:1"] * (n // 2)))
    return out


def _block():
    rng = np.random.default_rng(3)
    n = N_BATCHES * B
    blk = SlotRecordBlock(n=n)
    for i in range(N_SLOTS):
        lens = rng.integers(1, CAP + 1, n)
        off = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        blk.uint64_slots[f"s{i}"] = (rng.integers(
            1, 5000, int(off[-1])).astype(np.uint64), off)
    blk.float_slots["label"] = (rng.integers(0, 2, n).astype(np.float32),
                                np.arange(n + 1, dtype=np.int64))
    blk.float_slots["dense0"] = (rng.normal(0, 1, n * DENSE).astype(
        np.float32), np.arange(n + 1, dtype=np.int64) * DENSE)
    return blk


def _feed_config():
    return DataFeedConfig(slots=tuple(
        [SlotConfig("label", dtype="float", is_dense=True, dim=1),
         SlotConfig("dense0", dtype="float", is_dense=True, dim=DENSE)]
        + [SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(N_SLOTS)]))


def _pass(topo, packed, on_step=None, path="auto", want="mxu_sharded"):
    """One pass of 3 batches on ``path`` (resolving to ``want``) from
    seeded data and the seeded dense init; returns (stats, the working
    set on the host, the trainer)."""
    cfg = _feed_config()
    blk = _block()
    ds = SlotDataset(cfg)
    ds._blocks = [blk]
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF, sgd=SparseSGDConfig(mf_create_thresholds=0.0)),
        device="cuda", topology=topo)
    eng.begin_feed_pass()
    eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    tr = SparseTrainer(eng, DeepFM(N_SLOTS, 3 + MF, DENSE, (16,)), cfg,
                       batch_size=B, seed=0, device="cuda", topology=topo,
                       sparse_path=path)
    assert tr._resolve_path() == want
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds,
                          progress=on_step and (lambda i: on_step(tr)))
    ws = {k: torch.as_tensor(np.asarray(v)) if isinstance(v, Sharded)
          else v.cpu() for k, v in eng.ws.items()}
    return stats, ws, tr


def _close(got, ws, ref, ws_ref):
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-4)
    for k in ws_ref:
        a, b = ws[k].numpy(), ws_ref[k].numpy()
        if k == "slot":
            assert np.array_equal(a != 0, b != 0)
        elif b.dtype == np.int32:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_multicard_pass_matches_one_card(cuda_device, mesh, packed,
                                         monkeypatch):
    """Every step each shard's table block, ids and plan sit on its
    shard's device, and the nodes' replicas of each table block are
    bit-equal; each sorted kernel launches once per card shard a step and
    gather_pool never; the pass within the tolerances of the same mesh on
    one card; a rerun bit-identical."""
    degrees = MESHES[mesh]
    n = MeshConfig(**degrees).world_size
    ref, ws_ref, _ = _pass(HybridTopology(MeshConfig(**degrees),
                                          device="cuda"), packed)
    for name, layout in _layouts():
        topo = HybridTopology(MeshConfig(**degrees), devices=layout(n))
        pull = se.pull_rows_sharded_mxu

        def spy(tables, idx, topo_, axis, plans, bf16):
            for k in range(n):
                for t in (tables[k], idx[k], *plans[k]):
                    assert same_device(t.device, topo.device_of(k)), name
            return pull(tables, idx, topo_, axis, plans, bf16)
        monkeypatch.setattr(se, "pull_rows_sharded_mxu", spy)

        def on_step(tr):
            reps = tr.dense_replicas()
            for a, b in zip(reps[0].parameters(), reps[1].parameters()):
                assert torch.equal(a.cpu(), b.cpu())
            # multinode: each node's replica of a table block, one on
            # each device, bit-equal after the step
            for f, t in tr.engine.ws.items():
                first = {}
                for k, blk in t.unique():
                    row0 = t.rows(k).start
                    if row0 in first:
                        seen["replicas"] += 1
                        assert torch.equal(blk.cpu(), first[row0]), (name, f)
                    else:
                        first[row0] = blk.cpu()
        card_shards = sum(d.type == "cuda" for d in topo.devices)
        g0, s0 = sp.gather_sorted.launches, sp.scatter_add_sorted.launches
        p0 = pg.gather_pool.launches
        seen = {"replicas": 0}
        got, ws, tr = _pass(topo, packed, on_step)
        # multinode: node 1's replica of each of the 2 table blocks
        assert seen["replicas"] == (N_BATCHES * len(tr.engine.ws) * 2
                                    if mesh == "multinode" else 0)
        assert sp.gather_sorted.launches - g0 == N_BATCHES * card_shards
        assert sp.scatter_add_sorted.launches - s0 == N_BATCHES * card_shards
        assert pg.gather_pool.launches == p0
        monkeypatch.setattr(se, "pull_rows_sharded_mxu", pull)
        _close(got, ws, ref, ws_ref)
        again, ws2, _ = _pass(topo, packed)
        assert again["losses"] == got["losses"], name
        for k in ws:
            assert torch.equal(ws[k], ws2[k]), (name, k)


@pytest.mark.cuda
def test_sorted_kernels_launch_on_their_tensors_card(cuda_device):
    """A tensor on the second card launches there: the result equals the
    plain version, and the caller's current device is left as it was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    dev = torch.device("cuda", 1)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, 500, 4096).astype(np.int32),
                          device=dev)
    dims = sp.spmm_dims(ids.numel(), 512)
    plan = sp.build_plan(ids, dims)
    tab = torch.randn((12, dims.n_kernel), device=dev)
    pay = torch.randn((12, dims.p_pad), device=dev)
    before = torch.cuda.current_device()
    got = sp.gather_sorted(tab, plan[0], dims)
    out = sp.scatter_add_sorted(pay, plan[0], plan[7], dims)
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == before
    assert got.device == dev and out.device == dev
    assert torch.equal(got, sp.gather_sorted_plain(tab, plan[0], dims))
    want = sp.scatter_add_sorted_plain(pay, plan[0], plan[7], dims)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


# (path, mesh, the lowering it resolves to, per row block on a card a
# step: gather_sorted, scatter_add_sorted, gather_pool launches)
PATH_RUNS = {"mxu": ("mxu", dict(dp=2), "mxu", (1, 1, 0)),
             "fast": ("fast", dict(dp=2), "fast", (0, 1, 1)),
             "reference": ("reference", dict(dp=2, sharding=2), "reference",
                           (0, 1, 0)),
             "auto_dp2xmp2": ("auto", dict(dp=2, mp=2), "fast", (0, 1, 1))}


def _card_blocks(topo, engine) -> int:
    """Row blocks of the working set whose first shard sits on a card."""
    return sum(topo.device_of(k).type == "cuda"
               for k, _, _ in engine.ws["show"].row_blocks())


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("run", list(PATH_RUNS))
def test_one_device_lowerings_match_one_card(cuda_device, run, packed):
    """Explicit mxu / fast / reference and auto on dp 2 × mp 2 with the
    shards on distinct devices: each kernel launched once a step for each
    row block on a card (the host's blocks run the plain versions), the
    pass within the tolerances of the same mesh on one card, a rerun
    bit-identical."""
    path, degrees, want, per_block = PATH_RUNS[run]
    n = MeshConfig(**degrees).world_size
    ref, ws_ref, _ = _pass(HybridTopology(MeshConfig(**degrees),
                                          device="cuda"), packed, path=path,
                           want=want)
    for name, layout in _layouts():
        topo = HybridTopology(MeshConfig(**degrees), devices=layout(n))
        before = [f.launches for f in (sp.gather_sorted,
                                       sp.scatter_add_sorted,
                                       pg.gather_pool)]
        got, ws, tr = _pass(topo, packed, path=path, want=want)
        blocks = _card_blocks(topo, tr.engine)
        assert blocks >= 1
        after = [f.launches for f in (sp.gather_sorted,
                                      sp.scatter_add_sorted,
                                      pg.gather_pool)]
        assert [a - b for a, b in zip(after, before)] == [
            N_BATCHES * blocks * k for k in per_block], name
        _close(got, ws, ref, ws_ref)
        again, ws2, _ = _pass(topo, packed, path=path, want=want)
        assert again["losses"] == got["losses"], name
        for k in ws:
            assert torch.equal(ws[k], ws2[k]), (name, k)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["serial", "prefetch"])
def test_day_loop_cache_on_card_and_host(cuda_device, tmp_path, prefetch):
    """Three passes of a day over dp 2 on the card and the host with the
    device row cache on equal the cache off bit for bit (the host table,
    the losses, the dense params), the warm passes hit, and the hits
    that live on the host's block crossed as copies."""
    from paddlebox_tpu_torch import fleet, flags
    from paddlebox_tpu_torch.utils.monitor import stat_get
    rng = np.random.default_rng(5)
    files = []
    for p in range(3):
        path = str(tmp_path / f"p{p}.txt")
        with open(path, "w") as f:
            for _ in range(2 * B):
                parts = [f"1 {rng.integers(0, 2)}", f"{DENSE} " + " ".join(
                    f"{rng.normal():.4f}" for _ in range(DENSE))]
                for _s in range(N_SLOTS):
                    k = rng.integers(1, CAP + 1)
                    parts.append(f"{k} " + " ".join(
                        str(rng.integers(1, 2000)) for _ in range(k)))
                f.write(" ".join(parts) + "\n")
        files.append([path])
    topo = HybridTopology(MeshConfig(dp=2), devices=_layouts()[0][1](2))
    old = (flags.get_flags("ps_device_cache"),
           flags.get_flags("ps_device_cache_rows"))
    out = []
    try:
        for cache in (False, True):
            flags.set_flags({"ps_device_cache": cache,
                             "ps_device_cache_rows": 1 << 14})
            eng = BoxPSEngine(EmbeddingTableConfig(
                embedding_dim=MF, sgd=SparseSGDConfig(
                    mf_create_thresholds=0.0)), device="cuda",
                topology=topo)
            ds = fleet.BoxPSDataset(_feed_config(), engine=eng,
                                    read_threads=1)
            tr = SparseTrainer(eng, DeepFM(N_SLOTS, 3 + MF, DENSE, (16,)),
                               _feed_config(), batch_size=B, seed=0,
                               device="cuda", topology=topo)
            hits0 = stat_get("ps.cache.hits")
            copies0 = stat_get("ps.cache.device_copy_rows")
            stats = fleet.train_passes(tr, ds, files, date="20260801",
                                       prefetch=prefetch)
            if cache:
                assert stat_get("ps.cache.hits") > hits0
                assert stat_get("ps.cache.device_copy_rows") > copies0
            keys = np.sort(eng.table.export_keys())
            out.append(([m["losses"] for m in stats], keys,
                        eng.table.bulk_pull(keys),
                        [p.detach().cpu() for p in tr.model.parameters()]))
    finally:
        flags.set_flags({"ps_device_cache": old[0],
                         "ps_device_cache_rows": old[1]})
    (l0, k0, t0, p0), (l1, k1, t1, p1) = out
    assert l0 == l1
    np.testing.assert_array_equal(k0, k1)
    for f in t0:
        np.testing.assert_array_equal(t0[f], t1[f], err_msg=f)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


# -- the page-view model, the multi-task trainer and graph learning -----------------

def _pv_dataset(cfg, label_slots=("label",)):
    """Seeded page views of 1-4 records (ranked ads among them) over
    N_BATCHES pv-aligned batches, grouped by ``preprocess_instance``."""
    rng = np.random.default_rng(9)
    sizes = rng.integers(1, 5, N_BATCHES * B // 3)
    n = int(sizes.sum())
    blk = SlotRecordBlock(n=n)
    for i in range(N_SLOTS):
        lens = rng.integers(1, CAP + 1, n)
        off = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        blk.uint64_slots[f"s{i}"] = (rng.integers(
            1, 5000, int(off[-1])).astype(np.uint64), off)
    for name in label_slots:
        blk.float_slots[name] = (rng.integers(0, 2, n).astype(np.float32),
                                 np.arange(n + 1, dtype=np.int64))
    blk.float_slots["dense0"] = (rng.normal(0, 1, n * DENSE).astype(
        np.float32), np.arange(n + 1, dtype=np.int64) * DENSE)
    blk.search_ids = np.repeat(np.arange(1, len(sizes) + 1, dtype=np.uint64),
                               sizes)
    blk.cmatch = rng.choice([222, 223, 224], n).astype(np.int32)
    blk.rank = rng.integers(0, 5, n).astype(np.int32)
    ds = SlotDataset(cfg)
    ds._blocks = [blk]
    ds.preprocess_instance()
    return ds


def _model_pass(topo, kind, path="auto", packed=True):
    """One pass of the rank model (``kind`` "rank") or of MMoE through
    the multi-task trainer ("multitask") on ``topo``; returns (stats, the
    working set on the host, the trainer)."""
    from paddlebox_tpu_torch.models.mmoe import MMoE
    from paddlebox_tpu_torch.models.rank_ctr import RankAttentionCTR
    from paddlebox_tpu_torch.trainer.multitask import MultiTaskSparseTrainer
    labels = ("label", "label1") if kind == "multitask" else ("label",)
    cfg = DataFeedConfig(
        slots=tuple([SlotConfig(n, dtype="float", is_dense=True, dim=1)
                     for n in labels]
                    + [SlotConfig("dense0", dtype="float", is_dense=True,
                                  dim=DENSE)]
                    + [SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
                       for i in range(N_SLOTS)]),
        rank_offset=kind == "rank", ads_offset=kind == "rank", max_rank=3)
    ds = _pv_dataset(cfg, labels)
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF, sgd=SparseSGDConfig(mf_create_thresholds=0.0)),
        device="cuda", topology=topo)
    eng.begin_feed_pass()
    for blk in ds.get_blocks():
        eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    if kind == "rank":
        tr = SparseTrainer(eng, RankAttentionCTR(N_SLOTS, 3 + MF, DENSE,
                                                 att_out=8, max_rank=3,
                                                 hidden=(16,)),
                           cfg, batch_size=B, seed=0, device="cuda",
                           topology=topo, sparse_path=path)
    else:
        tr = MultiTaskSparseTrainer(
            eng, MMoE(N_SLOTS, 3 + MF, DENSE, num_experts=2, num_tasks=2,
                      expert_hidden=(16,), tower_hidden=(8,)),
            cfg, batch_size=B, label_slots=list(labels), seed=0,
            device="cuda", topology=topo)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    ws = {k: torch.as_tensor(np.asarray(v)) if isinstance(v, Sharded)
          else v.cpu() for k, v in eng.ws.items()}
    return stats, ws, tr


# (kind, path, mesh, the lowering, per card row block or shard a step:
# gather_sorted, scatter_add_sorted, gather_pool launches)
MODEL_RUNS = {"rank_auto": ("rank", "auto", dict(dp=2), "mxu_sharded",
                            (1, 1, 0)),
              "rank_fast": ("rank", "fast", dict(dp=2), "fast", (0, 1, 1)),
              "multitask": ("multitask", "auto", dict(dp=2), "reference",
                            (0, 1, 0))}


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
@pytest.mark.parametrize("run", list(MODEL_RUNS))
def test_models_match_one_card(cuda_device, run, packed):
    """The rank model and the multi-task trainer with the shards on
    distinct devices: each kernel launched its predicted number of times
    a step for each card block, the pass within the tolerances of the
    same mesh on one card (the task AUCs within 1e-6), a rerun
    bit-identical."""
    kind, path, degrees, want, per_block = MODEL_RUNS[run]
    n = MeshConfig(**degrees).world_size
    ref, ws_ref, tr_ref = _model_pass(HybridTopology(MeshConfig(**degrees),
                                                     device="cuda"),
                                      kind, path, packed)
    assert tr_ref._resolve_path() == want
    for name, layout in _layouts():
        topo = HybridTopology(MeshConfig(**degrees), devices=layout(n))
        before = [f.launches for f in (sp.gather_sorted,
                                       sp.scatter_add_sorted,
                                       pg.gather_pool)]
        got, ws, tr = _model_pass(topo, kind, path, packed)
        cards = (sum(d.type == "cuda" for d in topo.devices)
                 if want == "mxu_sharded" else _card_blocks(topo, tr.engine))
        after = [f.launches for f in (sp.gather_sorted,
                                      sp.scatter_add_sorted,
                                      pg.gather_pool)]
        assert [a - b for a, b in zip(after, before)] == [
            got["batches"] * cards * k for k in per_block], name
        _close(got, ws, ref, ws_ref)
        if kind == "multitask":
            for t in range(2):
                np.testing.assert_allclose(got[f"task{t}_auc"],
                                           ref[f"task{t}_auc"], rtol=0,
                                           atol=1e-6)
        again, ws2, _ = _model_pass(topo, kind, path, packed)
        assert again["losses"] == got["losses"], name
        for k in ws:
            assert torch.equal(ws[k], ws2[k]), (name, k)


def _graph_epoch(topo, n_nodes=4000, steps=3, batch=2048):
    """An engine over nodes 1..n on ``topo`` and one ``train_pairs``
    epoch of seeded pairs; returns (losses, mf, mf_g2sum, engine)."""
    from paddlebox_tpu_torch.graph.graph_table import GraphTable
    from paddlebox_tpu_torch.trainer.graph_trainer import \
        GraphEmbeddingTrainer
    rng = np.random.default_rng(4)
    src = rng.integers(1, n_nodes + 1, 8 * n_nodes)
    dst = rng.integers(1, n_nodes + 1, 8 * n_nodes)
    edges = np.stack([src, dst], 1).astype(np.int64)
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=8, sgd=SparseSGDConfig(mf_create_thresholds=0.0,
                                             mf_initial_range=0.1)),
        device="cuda", topology=topo)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, n_nodes + 1, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    size = eng.ws["mf_size"]
    for _, blk in (size.unique() if isinstance(size, Sharded)
                   else [(0, size)]):
        blk.fill_(8)
    tr = GraphEmbeddingTrainer(eng, GraphTable(edges, num_nodes=n_nodes + 1,
                                               device="cuda"),
                               n_negatives=5, learning_rate=0.05, seed=2)
    pairs = rng.integers(1, n_nodes + 1, (steps * batch, 2)).astype(np.int32)
    tr.train_pairs(pairs, batch_size=batch)
    ws = {f: np.asarray(v) if isinstance(v, Sharded) else v.cpu().numpy()
          for f, v in eng.ws.items() if f in ("mf", "mf_g2sum")}
    return tr.stats["losses"], ws["mf"], ws["mf_g2sum"], eng


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", list(MESHES))
def test_graph_epoch_matches_one_card(cuda_device, mesh):
    """A graph epoch over the working set's row blocks on distinct
    devices: both sorted kernels once a step for each row block on a
    card, the losses, mf and mf_g2sum within the file's tolerances of
    the same mesh on one card, a rerun bit-identical."""
    degrees = MESHES[mesh]
    n = MeshConfig(**degrees).world_size
    ref = _graph_epoch(HybridTopology(MeshConfig(**degrees), device="cuda"))
    for name, layout in _layouts():
        topo = HybridTopology(MeshConfig(**degrees), devices=layout(n))
        g0, s0 = sp.gather_sorted.launches, sp.scatter_add_sorted.launches
        got = _graph_epoch(topo)
        blocks = _card_blocks(topo, got[3])
        assert sp.gather_sorted.launches - g0 == 3 * blocks, name
        assert sp.scatter_add_sorted.launches - s0 == 3 * blocks, name
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-4)
        for a, b in ((got[1], ref[1]), (got[2], ref[2])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        again = _graph_epoch(topo)
        assert again[0] == got[0], name
        np.testing.assert_array_equal(again[1], got[1])
