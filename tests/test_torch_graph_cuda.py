"""The graph-learning step and the sorted kernels on a graph plan, on a
card.

JAX-free on purpose, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_graph_cuda.py

Without a card every test here skips.  A graph step's plan sorts the
batch's centers, contexts and K negatives together: walks make a few hub
rows hold long runs, and the negatives spread over every row.  The
gather must equal its plain version bit for bit and the scatter its
plain version within rtol 1e-5 (plus 1e-5 of each row's sum of |terms|:
the plain ``index_add_`` adds with atomics in another order).  The step
on the card must equal the same step on the CPU piece by piece: the
loss within rtol 1e-5, the merged gradient within the scatter's bound,
and mf and mf_g2sum updated from the card's merged gradient within rtol
1e-5 (atol 1e-7) — the update is replayed from it because adagrad's
first step divides a row's merged gradient by its own rms, so a hub row
whose terms cancel carries its sum's rounding (tiles on the card, a
sequence on the CPU) to the update's scale.  A rerun must give the same
bits.
"""

import numpy as np
import pytest
import torch

from torch_port_fixtures import cuda_device  # noqa: F401

from paddlebox_tpu_torch.config import EmbeddingTableConfig, SparseSGDConfig
from paddlebox_tpu_torch.graph.graph_table import GraphTable
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer import graph_trainer as gt

B, K, D = 4096, 5, 8


def _graph_rows(rng, n_rows, hub_share=0.3):
    """A step's rows: centers and contexts Zipf-1.2 over the table (a
    hub row holding ~hub_share of them), negatives uniform."""
    walk = (rng.zipf(1.2, 2 * B) - 1) % (n_rows - 1) + 1
    walk[rng.random(2 * B) < hub_share] = 1 + n_rows // 2
    negs = rng.integers(1, n_rows, B * K)
    return np.concatenate([walk, negs]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [64, sp.TILE, 3 * sp.TILE + 5])
def test_kernels_match_plain_on_graph_plans(cuda_device, n_rows):
    rng = np.random.default_rng(n_rows)
    rows = torch.as_tensor(_graph_rows(rng, n_rows), device=cuda_device)
    dims = sp.spmm_dims(rows.numel(), n_rows)
    plan = sp.build_plan(rows, dims)
    rows2d, first_occ = plan[0], plan[7]
    runs = torch.unique_consecutive(rows2d.reshape(-1),
                                    return_counts=True)[1]
    assert int(runs.max()) > B // 4          # a hub run
    g = torch.Generator(device=cuda_device).manual_seed(n_rows)
    table = torch.zeros((D, dims.n_kernel), device=cuda_device)
    table[:, 1:n_rows] = torch.randn((D, n_rows - 1), generator=g,
                                     device=cuda_device)
    n0 = sp.gather_sorted.launches
    got = sp.gather_sorted(table, rows2d, dims)
    assert torch.equal(got, sp.gather_sorted(table, rows2d, dims))
    assert sp.gather_sorted.launches == n0 + 2
    assert torch.equal(got, sp.gather_sorted_plain(table, rows2d, dims))
    pay = torch.randn((D, dims.p_pad), generator=g, device=cuda_device)
    pay[:, dims.p:] = 0.0
    s0 = sp.scatter_add_sorted.launches
    out = sp.scatter_add_sorted(pay, rows2d, first_occ, dims)
    assert torch.equal(out, sp.scatter_add_sorted(pay, rows2d, first_occ,
                                                  dims))
    assert sp.scatter_add_sorted.launches == s0 + 2
    want = sp.scatter_add_sorted_plain(pay, rows2d, first_occ, dims)
    abs_sum = sp.scatter_add_sorted_plain(pay.abs(), rows2d, first_occ, dims)
    err = (out - want).abs()
    assert bool((err <= 1e-5 * want.abs() + 1e-5 * abs_sum + 1e-6).all()), \
        float(err.max())


def _engine(device, n):
    eng = BoxPSEngine(EmbeddingTableConfig(
        embedding_dim=D, sgd=SparseSGDConfig(mf_create_thresholds=0.0,
                                             mf_initial_range=0.1)),
        device=device)
    eng.begin_feed_pass()
    eng.add_keys(np.arange(1, n + 1, dtype=np.uint64))
    eng.end_feed_pass()
    eng.begin_pass()
    eng.ws["mf_size"].fill_(D)
    return eng


@pytest.mark.cuda
def test_graph_step_on_card_equals_cpu(cuda_device):
    n = 50_000
    eng = _engine(cuda_device, n)
    rng = np.random.default_rng(0)
    rows = _graph_rows(rng, n)
    centers = torch.as_tensor(rows[:B], device=cuda_device)
    contexts = torch.as_tensor(rows[B:2 * B], device=cuda_device)
    contexts[:100] = 0                       # masked pairs
    negs = torch.as_tensor(rows[2 * B:].reshape(B, K), device=cuda_device)
    mf_fm, g2 = gt.to_feature_major(eng.ws["mf"], eng.ws["mf_g2sum"])
    host = [t.cpu().clone() for t in (mf_fm, g2, centers, contexts, negs)]
    n0 = (sp.gather_sorted.launches, sp.scatter_add_sorted.launches)
    loss, pay, (rows2d, first_occ, dims) = gt.skipgram_grad(
        mf_fm, centers, contexts, negs)
    delta = sp.scatter_add_sorted(pay, rows2d, first_occ, dims)
    assert (sp.gather_sorted.launches, sp.scatter_add_sorted.launches) == \
        (n0[0] + 1, n0[1] + 1)
    h_loss, h_pay, (h_rows2d, h_first, _) = gt.skipgram_grad(host[0],
                                                             *host[2:])
    torch.testing.assert_close(loss.cpu(), h_loss, rtol=1e-5, atol=0)
    assert torch.equal(rows2d.cpu(), h_rows2d)
    h_delta = sp.scatter_add_sorted_plain(h_pay, h_rows2d, h_first, dims)
    abs_sum = sp.scatter_add_sorted_plain(h_pay.abs(), h_rows2d, h_first,
                                          dims)
    err = (delta.cpu() - h_delta).abs()
    assert bool((err <= 1e-5 * (h_delta.abs() + abs_sum)).all()), \
        float(err.max())
    # the update, replayed on the CPU from the card's merged gradient
    gt.adagrad_update(host[0], host[1], delta.cpu(), 0.05)
    gt.adagrad_update(mf_fm, g2, delta, 0.05)
    torch.testing.assert_close(mf_fm.cpu(), host[0], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(g2.cpu(), host[1], rtol=1e-5, atol=1e-7)
    # the sentinel tile (rows past the working set) stays zero
    assert not mf_fm[:, mf_fm.shape[1] - sp.TILE:].any()
    # and skipgram_step is those pieces: the same bits from the same state
    mf2, g22 = gt.to_feature_major(eng.ws["mf"], eng.ws["mf_g2sum"])
    assert torch.equal(gt.skipgram_step(mf2, g22, centers, contexts, negs,
                                        0.05), loss)
    assert torch.equal(mf2, mf_fm) and torch.equal(g22, g2)


@pytest.mark.cuda
def test_train_pairs_on_card_rerun_bit_identical(cuda_device):
    """Walks, pairs and an epoch twice from one seed: the same losses and
    working set bit for bit, one launch of each kernel a step."""
    rng = np.random.default_rng(1)
    n = 20_000
    edges = np.stack([rng.integers(1, n + 1, 8 * n),
                      (rng.zipf(1.2, 8 * n) - 1) % n + 1], 1)
    weights = rng.uniform(0.1, 1.0, len(edges))
    out = []
    for _ in range(2):
        eng = _engine(cuda_device, n)
        graph = GraphTable(edges, weights=weights, num_nodes=n + 1,
                           device=cuda_device)
        tr = gt.GraphEmbeddingTrainer(eng, graph, n_negatives=K, seed=3)
        n0 = sp.gather_sorted.launches, sp.scatter_add_sorted.launches
        loss = tr.train_walks(np.arange(1, 4097), length=6, batch_size=2048)
        steps = len(tr.stats["losses"])
        assert steps > 1 and len(tr.stats["step_ms"]) == steps
        assert (sp.gather_sorted.launches - n0[0],
                sp.scatter_add_sorted.launches - n0[1]) == (steps, steps)
        out.append((loss, eng.ws["mf"].clone(), eng.ws["mf_g2sum"].clone()))
    assert np.isfinite(out[0][0]) and out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])
