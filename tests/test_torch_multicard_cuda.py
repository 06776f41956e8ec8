"""The mxu_sharded lowering with its shards on distinct devices, on a card.

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
equal.
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


def _pass(topo, packed, on_step=None):
    """One pass of 3 batches on mxu_sharded (auto) from seeded data and
    the seeded dense init; returns (stats, the working set on the host,
    the trainer)."""
    cfg = DataFeedConfig(slots=tuple(
        [SlotConfig("label", dtype="float", is_dense=True, dim=1),
         SlotConfig("dense0", dtype="float", is_dense=True, dim=DENSE)]
        + [SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(N_SLOTS)]))
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
                       batch_size=B, seed=0, device="cuda", topology=topo)
    assert tr._resolve_path() == "mxu_sharded"
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
