"""The sorted kernels at a sharded plan's shapes, and the mxu_sharded step,
on a card.

JAX-free on purpose, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_sharded_cuda.py

Without a card every test here skips.  A sharded plan gives the kernels
shapes the one-device path never does: a shard's block is small (as
small as one tile), and every id another shard owns parks on the
sentinel row, one run at the end of the sorted domain that holds most of
it ((n - 1)/n of the ids at n table shards).  The gather must read exact
zeros there, and the scatter must sum that run into the sentinel tile
only.
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
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.parallel.topology import HybridTopology, Spec
from paddlebox_tpu_torch.ps import sharded_embedding as se
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer


def _sharded_plans(dev, rows_loc, n_shards=4, p_loc=3000, seed=0):
    """Per-shard plans of a batch whose ids are a third row-0 padding."""
    rng = np.random.default_rng(seed)
    n_rows = rows_loc * n_shards
    ids = rng.integers(1, n_rows, p_loc * n_shards)
    ids[rng.random(ids.size) < 1 / 3] = 0
    topo = HybridTopology(MeshConfig(dp=n_shards), device=dev)
    idx = topo.split(torch.as_tensor(ids.astype(np.int32), device=dev),
                     Spec("dp"))
    dims, plans = se.local_plan(idx, rows_loc, topo, "dp")
    return topo, ids, dims, plans


@pytest.mark.cuda
@pytest.mark.parametrize("rows_loc", [64, sp.TILE, 3 * sp.TILE + 5])
def test_kernels_match_plain_at_sharded_shapes(cuda_device, rows_loc):
    """Every shard's gather bit-equal to plain and zero on the sentinel
    run; its scatter within rtol 1e-5 plus 1e-5 of each row's sum of
    |terms| of plain, the sentinel run's sum only in the cut tile;
    reruns bit-identical; one launch per call."""
    topo, ids, dims, plans = _sharded_plans(cuda_device, rows_loc)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for k, plan in enumerate(plans):
        rows2d, first_occ = plan[0], plan[7]
        flat = rows2d.reshape(-1)
        outside = int((flat == dims.sentinel).sum())
        owned = int(((ids >= k * rows_loc) & (ids < (k + 1) * rows_loc))
                    .sum())
        assert outside == dims.p_pad - owned
        tab = torch.zeros((12, dims.n_kernel), device=cuda_device)
        tab[:, :rows_loc] = torch.randn((12, rows_loc), generator=g,
                                        device=cuda_device)
        n0 = sp.gather_sorted.launches
        got = sp.gather_sorted(tab, rows2d, dims)
        again = sp.gather_sorted(tab, rows2d, dims)
        assert sp.gather_sorted.launches == n0 + 2
        assert torch.equal(got, again)
        assert torch.equal(got, sp.gather_sorted_plain(tab, rows2d, dims))
        assert not got[:, flat == dims.sentinel].any()
        pay = torch.randn((12, dims.p_pad), generator=g, device=cuda_device)
        s0 = sp.scatter_add_sorted.launches
        out = sp.scatter_add_sorted(pay, rows2d, first_occ, dims)
        assert torch.equal(out, sp.scatter_add_sorted(pay, rows2d,
                                                      first_occ, dims))
        assert sp.scatter_add_sorted.launches == s0 + 2
        want = sp.scatter_add_sorted_plain(pay, rows2d, first_occ, dims)
        abs_sum = sp.scatter_add_sorted_plain(pay.abs(), rows2d, first_occ,
                                              dims)
        err = (out - want).abs()
        assert bool((err <= 1e-5 * want.abs() + 1e-5 * abs_sum
                     + 1e-6).all()), float(err.max())
        # everything the sentinel run sums lands past the owned rows
        sentinel_sum = pay[:, flat == dims.sentinel].sum(dim=1)
        torch.testing.assert_close(out[:, dims.sentinel], sentinel_sum,
                                   rtol=1e-4, atol=1e-3)
        assert not out[:, rows_loc:dims.sentinel].any()
        assert not out[:, dims.sentinel + 1:].any()


N_SLOTS, CAP, MF, DENSE, B = 4, 3, 4, 3, 256


def _pass(device, degrees):
    """One pass of 3 batches on mxu_sharded (auto) from seeded data and
    the same dense weights; returns the stats and the working set."""
    rng = np.random.default_rng(3)
    n = 3 * B
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
    cfg = DataFeedConfig(slots=tuple(
        [SlotConfig("label", dtype="float", is_dense=True, dim=1),
         SlotConfig("dense0", dtype="float", is_dense=True, dim=DENSE)]
        + [SlotConfig(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(N_SLOTS)]))
    ds = SlotDataset(cfg)
    ds._blocks = [blk]
    topo = HybridTopology(MeshConfig(**degrees), device=device)
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=MF, sgd=SparseSGDConfig(mf_create_thresholds=0.0)),
        topology=topo)
    eng.begin_feed_pass()
    eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    tr = SparseTrainer(eng, DeepFM(N_SLOTS, 3 + MF, DENSE, (16,)), cfg,
                       batch_size=B, seed=0, device=device, topology=topo)
    assert tr._resolve_path() == "mxu_sharded"
    stats = tr.train_pass(tr.build_pass_feed(ds))
    return stats, {k: v.cpu() for k, v in eng.ws.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("degrees", [dict(dp=4), dict(dp=2, sharding=2)],
                         ids=["flat", "multinode"])
def test_sharded_pass_on_card_matches_cpu(cuda_device, degrees):
    """The packed mxu_sharded pass on the card: one launch of each sorted
    kernel a shard a step, first-step loss = the CPU's (rtol 1e-4), a
    rerun bit-identical."""
    g0 = sp.gather_sorted.launches
    s0 = sp.scatter_add_sorted.launches
    card, ws = _pass("cuda", degrees)
    shards = MeshConfig(**degrees).world_size
    assert sp.gather_sorted.launches - g0 == 3 * shards
    assert sp.scatter_add_sorted.launches - s0 == 3 * shards
    cpu, _ = _pass("cpu", degrees)
    np.testing.assert_allclose(card["losses"][0], cpu["losses"][0],
                               rtol=1e-4)
    again, ws2 = _pass("cuda", degrees)
    assert again["losses"] == card["losses"]
    for k in ws:
        assert torch.equal(ws[k], ws2[k]), k
