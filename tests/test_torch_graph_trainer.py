"""Graph-embedding training in both packages (ports
``tests/test_graph_trainer.py``).

Both engines pull the same default rows (the host tables' key-seeded
init), so the port's trainer is held against the JAX package's on the
same pass: one step and a multi-step ``train_pairs`` epoch, the port
fed the JAX trainer's negatives (its ``draw_negatives`` replaced by the
JAX draws under the same key splits).  Tolerance: the mean loss, ``mf``
and ``mf_g2sum`` within rtol 1e-5 / atol 1e-7 (the port sums the merged
gradient by its sorted segmented sum, XLA by its scatter).  The pull
and push go through ``gather_sorted`` and ``scatter_add_sorted`` once
each a step.  The two-community test of the JAX package runs on the
port with its own generator.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import EmbeddingTableConfig as JTableConfig
from paddlebox_tpu.config import SparseSGDConfig as JSGD
from paddlebox_tpu.graph.graph_table import GraphTable as JGraph
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.trainer import graph_trainer as jgt
from paddlebox_tpu_torch.config import EmbeddingTableConfig, SparseSGDConfig
from paddlebox_tpu_torch.graph.graph_table import GraphTable
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.trainer import graph_trainer as tgt


def _two_communities(rng, size=20, p_in=0.6, p_out=0.02):
    """Dense intra-edges, sparse bridges; node ids 1..2*size (0 is the
    PS's reserved row)."""
    n = 2 * size
    edges = []
    for a in range(1, n + 1):
        for b in range(a + 1, n + 1):
            same = (a <= size) == (b <= size)
            if rng.random() < (p_in if same else p_out):
                edges.append((a, b))
                edges.append((b, a))
    return np.asarray(edges, np.int64), n


def _engines(n, seed=0):
    """A JAX and a port engine over keys 1..n with mf created."""
    kw = dict(embedding_dim=8, shard_num=4)
    jeng = JEngine(JTableConfig(**kw, sgd=JSGD(mf_create_thresholds=0.0,
                                               mf_initial_range=0.1)),
                   seed=seed)
    teng = BoxPSEngine(EmbeddingTableConfig(
        **kw, sgd=SparseSGDConfig(mf_create_thresholds=0.0,
                                  mf_initial_range=0.1)),
        seed=seed, device="cpu")
    for eng in (jeng, teng):
        eng.begin_feed_pass()
        eng.add_keys(np.arange(1, n + 1, dtype=np.uint64))
        eng.end_feed_pass()
        eng.begin_pass()
    jeng.ws["mf_size"] = jnp.full_like(jeng.ws["mf_size"], 8)
    teng.ws["mf_size"].fill_(8)
    return jeng, teng


@pytest.mark.parametrize("window", [1, 2, 3])
def test_walk_pairs_exact(window):
    rng = np.random.default_rng(window)
    walks = rng.integers(-1, 50, (7, 6)).astype(np.int32)
    want = np.asarray(jgt.walk_pairs(jnp.asarray(walks), window))
    got = tgt.walk_pairs(torch.from_numpy(walks), window).numpy()
    np.testing.assert_array_equal(got, want)
    small = tgt.walk_pairs(torch.tensor([[1, 2, 3, 4]]), 2).numpy()
    assert ({tuple(p) for p in small} ==
            {(1, 2), (2, 1), (2, 3), (3, 2), (3, 4), (4, 3),
             (1, 3), (3, 1), (2, 4), (4, 2)})


def _jax_negatives(seed, n_steps, batch, k, n_real):
    """The negatives of the JAX trainer's steps (its key split per step)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.randint(sub, (batch, k), 1,
                                               n_real + 1)))
    return out


def _count_launches(monkeypatch):
    """Count the port's calls of the two sorted-kernel wrappers."""
    calls = {"gather_sorted": 0, "scatter_add_sorted": 0}
    for name in calls:
        real = getattr(sp, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(sp, name, counted)
    return calls


@pytest.mark.parametrize("n_pairs,batch", [(300, 512), (5000, 1024)])
def test_train_pairs_matches_jax(monkeypatch, n_pairs, batch):
    """One step (the tail batch padded) and a 5-step epoch: loss, mf and
    mf_g2sum equal the JAX trainer's."""
    rng = np.random.default_rng(n_pairs)
    edges, n = _two_communities(rng)
    jeng, teng = _engines(n)
    np.testing.assert_array_equal(np.asarray(jeng.ws["mf"]),
                                  teng.ws["mf"].numpy())
    mf0 = teng.ws["mf"].clone()
    k, lr, seed = 4, 0.1, 7
    pairs = rng.integers(0, n + 1, (n_pairs, 2)).astype(np.int32)
    jtr = jgt.GraphEmbeddingTrainer(jeng, JGraph(edges, num_nodes=n + 1),
                                    n_negatives=k, learning_rate=lr,
                                    seed=seed)
    want = jtr.train_pairs(jnp.asarray(pairs), batch_size=batch)
    ttr = tgt.GraphEmbeddingTrainer(
        teng, GraphTable(edges, num_nodes=n + 1, device="cpu"),
        n_negatives=k, learning_rate=lr, seed=seed)
    n_steps = -(-n_pairs // batch)
    negs = iter(_jax_negatives(seed, n_steps, batch, k, n))
    ttr.draw_negatives = lambda b: torch.from_numpy(next(negs))
    calls = _count_launches(monkeypatch)
    got = ttr.train_pairs(pairs, batch_size=batch)
    assert calls == {"gather_sorted": n_steps, "scatter_add_sorted": n_steps}
    assert len(ttr.stats["losses"]) == n_steps
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for f in ("mf", "mf_g2sum"):
        np.testing.assert_allclose(teng.ws[f].numpy(),
                                   np.asarray(jeng.ws[f]),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    assert not torch.equal(teng.ws["mf"], mf0)      # it trained


def test_pair_rows_drop_dead_ends_and_self_pairs():
    """The port's row translation of walk pairs = the JAX trainer's
    (train_walks' filter), on JAX walks with dead ends and stuck nodes."""
    rng = np.random.default_rng(3)
    edges, n = _two_communities(rng, size=6, p_in=0.4)
    edges = edges[edges[:, 0] != 3]          # node 3 is a dead end
    jeng, teng = _engines(n)
    jgraph = JGraph(edges, num_nodes=n + 1)
    walks = jgraph.random_walk(jnp.arange(0, n + 1, dtype=jnp.int32), 5,
                               jax.random.PRNGKey(0))
    pairs = np.array(jgt.walk_pairs(walks, 2))
    flat = pairs.reshape(-1)
    rows = np.zeros_like(flat, dtype=np.int32)
    rows[flat >= 0] = jeng.mapper(flat[flat >= 0].astype(np.uint64))
    rows = rows.reshape(pairs.shape)
    want = rows[(rows > 0).all(1) & (rows[:, 0] != rows[:, 1])]
    ttr = tgt.GraphEmbeddingTrainer(
        teng, GraphTable(edges, num_nodes=n + 1, device="cpu"))
    got = ttr.pair_rows(torch.from_numpy(pairs))
    np.testing.assert_array_equal(got, want)
    assert len(got) < len(pairs)


def test_communities_separate_and_write_back():
    rng = np.random.default_rng(0)
    edges, n = _two_communities(rng)
    _, eng = _engines(n)
    graph = GraphTable(edges, num_nodes=n + 1, device="cpu")
    tr = tgt.GraphEmbeddingTrainer(eng, graph, n_negatives=4,
                                   learning_rate=0.1, window=2)
    starts = np.tile(np.arange(1, n + 1), 6)
    losses = [tr.train_walks(starts, length=6, batch_size=2048, seed=s)
              for s in range(8)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses

    rows = eng.mapper(np.arange(1, n + 1, dtype=np.uint64))
    emb = eng.ws["mf"].numpy()[rows]
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    half = n // 2
    sim = emb @ emb.T
    intra = (sim[:half, :half].mean() + sim[half:, half:].mean()) / 2
    inter = sim[:half, half:].mean()
    assert intra > inter + 0.2, (intra, inter)

    # the embedding lives in the PS: end_pass writes it back to the table
    trained = eng.ws["mf"].numpy()[rows].copy()
    eng.end_pass()
    back = eng.table.bulk_pull(np.arange(1, n + 1, dtype=np.uint64))
    np.testing.assert_array_equal(back["mf"], trained)
    assert np.any(back["mf"] != 0)


def test_rerun_bit_identical_and_device_checks():
    """Two trainers from one seed on one state leave the same bits; the
    graph must live on the engine's device."""
    rng = np.random.default_rng(1)
    edges, n = _two_communities(rng)
    states = []
    for _ in range(2):
        _, eng = _engines(n)
        tr = tgt.GraphEmbeddingTrainer(
            eng, GraphTable(edges, num_nodes=n + 1, device="cpu"),
            n_negatives=3, seed=5)
        tr.train_walks(np.arange(1, n + 1), length=4, batch_size=64)
        states.append((tr.stats["losses"], eng.ws["mf"].clone(),
                       eng.ws["mf_g2sum"].clone()))
    assert states[0][0] == states[1][0]
    assert torch.equal(states[0][1], states[1][1])
    assert torch.equal(states[0][2], states[1][2])
    assert np.isnan(tr.train_pairs(np.zeros((0, 2), np.int32)))

    class Elsewhere:
        device = torch.device("meta")
    with pytest.raises(ValueError, match="engine"):
        tgt.GraphEmbeddingTrainer(Elsewhere(), GraphTable(
            edges, num_nodes=n + 1, device="cpu"))
