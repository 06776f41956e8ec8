"""The graph table in both packages (ports ``tests/test_graph.py`` and
the sampler half of ``tests/test_graph_trainer.py``).

The JAX PRNG cannot be reproduced in torch, so the selections are held
against the JAX package under the JAX package's own draws: each test
makes ``jax.random.randint`` / ``uniform`` under the same key splits as
``GraphTable.sample_neighbors`` and feeds them to the port's
``select`` / ``walk_step`` / ``metapath_step``.  Tolerances: the CSR,
``local_cdf`` and every selection bit-equal; ``sage_aggregate`` within
rtol 1e-6 (atol 1e-7 for means that cancel to near 0: the two packages
sum the K neighbors in another order).  The JAX tests' distribution,
ring and sink cases run on the port with its own generator.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.graph import graph_table as jg
from paddlebox_tpu_torch.graph import graph_table as tg


def _random_graph(seed=0, n=40, m=200):
    """Random edges over n nodes, a few of them (and the last) with no
    out-edge, and seeded weights (one node's span all zero)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 3, m)
    dst = rng.integers(0, n, m)
    w = rng.uniform(0.0, 2.0, m)
    w[src == 5] = 0.0
    return np.stack([src, dst], 1), w, n


def _both(edges, weights=None, num_nodes=None):
    return (jg.GraphTable(edges, weights=weights, num_nodes=num_nodes),
            tg.GraphTable(edges, weights=weights, num_nodes=num_nodes,
                          device="cpu"))


def _jax_draws(jtab, nodes, k, key):
    """The draws of ``jtab.sample_neighbors(nodes, k, key)``."""
    start = jtab.indptr[nodes]
    deg = jtab.indptr[nodes + 1] - start
    k1, k2 = jax.random.split(key)
    off = jax.random.randint(k1, (nodes.shape[0], k), 0,
                             jnp.maximum(deg, 1)[:, None])
    u = jax.random.uniform(k2, (nodes.shape[0], k))
    return off, u


def _feed(ttab, off, u):
    """The draws the port's table takes: offsets for a uniform table,
    uniforms for a weighted one."""
    if ttab.local_cdf is None:
        return _t(off), None
    return None, _t(u)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_and_cdf_bit_equal(weighted):
    edges, w, n = _random_graph()
    jt, tt = _both(edges, w if weighted else None, n)
    assert (tt.num_nodes, tt.num_edges) == (jt.num_nodes, jt.num_edges)
    for name in ("indptr", "indices") + (("local_cdf",) if weighted else ()):
        a, b = np.asarray(getattr(jt, name)), getattr(tt, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (tt.local_cdf is None) == (not weighted)
    nodes = np.arange(n)
    assert np.array_equal(np.asarray(jt.degrees(jnp.asarray(nodes))),
                          tt.degrees(torch.from_numpy(nodes)).numpy())


@pytest.mark.parametrize("weighted", [False, True])
def test_select_under_jax_draws_bit_equal(weighted):
    edges, w, n = _random_graph(1)
    jt, tt = _both(edges, w if weighted else None, n)
    nodes = jnp.asarray(np.r_[np.arange(n), n - 1, 5, 5], jnp.int32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jt.sample_neighbors(nodes, 8, key))
        got = tt.select(_t(nodes), *_feed(tt, *_jax_draws(jt, nodes, 8, key)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # the last nodes have no out-edge (node n - 1 read past the CSR)
        assert (want[n - 3:n + 1] == -1).all() and (want[-2:] >= 0).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_random_walk_under_jax_draws_bit_equal(weighted):
    edges, w, n = _random_graph(2)
    jt, tt = _both(edges, w if weighted else None, n)
    starts = jnp.asarray(np.r_[np.arange(n), -1], jnp.int32)
    length = 7
    key = jax.random.PRNGKey(4)
    want = np.asarray(jt.random_walk(starts, length, key))
    cur, path = starts, [_t(starts)]
    for sk in jax.random.split(key, length):
        draws = _jax_draws(jt, jnp.maximum(cur, 0), 1, sk)
        nxt = tt.walk_step(path[-1], *_feed(tt, *draws))
        path.append(nxt)
        cur = jnp.asarray(nxt.numpy())
    np.testing.assert_array_equal(torch.stack(path, 1).numpy(), want)
    assert (want[-1] == -1).all()          # an invalid start stays put


def _bipartite(seed=2, n_u=20, n_i=30):
    rng = np.random.default_rng(seed)
    u2i = [(u, it) for u in range(1, n_u + 1)
           for it in rng.choice(np.arange(n_u + 1, n_u + n_i + 1), 4,
                                replace=False)]
    i2u = [(b, a) for a, b in u2i]
    return (np.asarray(u2i, np.int64), np.asarray(i2u, np.int64),
            n_u + n_i + 1)


def _metapath_cases():
    u2i, i2u, n_all = _bipartite()
    return {
        # alternating node types, users 1..20 / items 21..50
        "alternating": ([(u2i, n_all), (i2u, n_all)], np.arange(1, 21)),
        # user 1 has no u2i edge; the item table reuses id 1 with an edge
        "stuck": ([(np.asarray([(2, 5)]), 8),
                   (np.asarray([(1, 7), (5, 2)]), 8)], np.asarray([1, 2])),
    }


@pytest.mark.parametrize("case", ["alternating", "stuck"])
def test_metapath_under_jax_draws_bit_equal(case):
    specs, starts = _metapath_cases()[case]
    pairs = [_both(e, num_nodes=n) for e, n in specs]
    jts, tts = [p[0] for p in pairs], [p[1] for p in pairs]
    length = 6
    key = jax.random.PRNGKey(0)
    starts = jnp.asarray(starts, jnp.int32)
    want = np.asarray(jg.metapath_walk(jts, starts, length, key))
    node = _t(starts)
    stuck = torch.zeros_like(node, dtype=torch.bool)
    path = [node]
    for i, sk in enumerate(jax.random.split(key, length)):
        t = i % len(jts)
        draws = _jax_draws(jts[t], jnp.maximum(jnp.asarray(node.numpy()), 0),
                           1, sk)
        node, stuck = tg.metapath_step(tts[t], node, stuck,
                                       *_feed(tts[t], *draws))
        path.append(node)
    np.testing.assert_array_equal(torch.stack(path, 1).numpy(), want)
    if case == "stuck":
        np.testing.assert_array_equal(want[0], [1] * (length + 1))


# -- the JAX tests' cases on the port, with its own generator -------------

def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_port_csr_and_sample_valid():
    g = tg.GraphTable(np.array([(0, 1), (0, 2), (1, 2), (3, 0)]),
                      num_nodes=5, device="cpu")
    assert g.num_nodes == 5 and g.num_edges == 4
    assert g.degrees(torch.arange(5)).tolist() == [2, 1, 0, 1, 0]
    g = tg.GraphTable(np.array([(0, 1), (0, 2), (1, 3), (2, 3)]),
                      num_nodes=4, device="cpu")
    nb = g.sample_neighbors(torch.tensor([0, 1, 3]), 8, _gen(0)).numpy()
    assert set(nb[0]) <= {1, 2} and (nb[1] == 3).all() and (nb[2] == -1).all()
    empty = tg.GraphTable(np.zeros((0, 2)), num_nodes=3, device="cpu")
    assert (empty.sample_neighbors(torch.arange(3), 2, _gen(0)) == -1).all()


@pytest.mark.parametrize("weights,want", [((9.0, 1.0), (0.85, 0.95)),
                                          (None, (0.47, 0.53))])
def test_port_sampling_distribution(weights, want):
    """Weighted 9:1 draws land on node 1 ~90 % of the time; the uniform
    offsets (floor(u · deg)) split a 2-edge span evenly."""
    g = tg.GraphTable(np.array([(0, 1), (0, 2)]),
                      weights=None if weights is None else np.array(weights),
                      num_nodes=3, device="cpu")
    nb = g.sample_neighbors(torch.zeros(20000, dtype=torch.int32), 1,
                            _gen(1))[:, 0].numpy()
    assert want[0] < (nb == 1).mean() < want[1]
    assert set(np.unique(nb)) == {1, 2}


def test_port_random_walk_ring_and_sink():
    n = 10
    ring = tg.GraphTable(np.array([(i, (i + 1) % n) for i in range(n)]),
                         num_nodes=n, device="cpu")
    walks = ring.random_walk(torch.arange(n), 5, _gen(2)).numpy()
    assert walks.shape == (n, 6)
    for r in range(n):
        np.testing.assert_array_equal(walks[r], (r + np.arange(6)) % n)
    sink = tg.GraphTable(np.array([(0, 1)]), num_nodes=2, device="cpu")
    np.testing.assert_array_equal(
        sink.random_walk(torch.tensor([0]), 4, _gen(3)).numpy()[0],
        [0, 1, 1, 1, 1])
    nodes = ring.sample_nodes(_gen(4), 1000)
    assert nodes.min() >= 0 and nodes.max() < n


def test_port_metapath_alternates_and_stays_stuck():
    u2i, i2u, n_all = _bipartite()
    tabs = [tg.GraphTable(e, num_nodes=n_all, device="cpu")
            for e in (u2i, i2u)]
    walks = tg.metapath_walk(tabs, torch.arange(1, 21), 6, _gen(0)).numpy()
    assert walks.shape == (20, 7)
    is_item = walks > 20
    assert not is_item[:, 0::2].any() and is_item[:, 1::2].all()
    with pytest.raises(ValueError, match="edge table"):
        tg.metapath_walk([], torch.arange(3), 3, _gen(0))
    t_u2i = tg.GraphTable(np.asarray([(2, 5)]), num_nodes=8, device="cpu")
    t_i2u = tg.GraphTable(np.asarray([(1, 7), (5, 2)]), num_nodes=8,
                          device="cpu")
    walks = tg.metapath_walk([t_u2i, t_i2u], torch.tensor([1, 2]), 4,
                             _gen(0)).numpy()
    np.testing.assert_array_equal(walks[0], [1, 1, 1, 1, 1])
    np.testing.assert_array_equal(walks[1], [2, 5, 2, 5, 2])


@pytest.mark.parametrize("reduce", ["mean", "max"])
def test_sage_aggregate_matches_jax(reduce):
    rng = np.random.default_rng(5)
    emb = rng.normal(0, 1, (30, 8)).astype(np.float32)
    idx = rng.integers(-1, 30, (16, 6)).astype(np.int32)
    idx[3] = -1                                   # an all-invalid row
    want = np.asarray(jg.sage_aggregate(jnp.asarray(emb), jnp.asarray(idx),
                                        reduce))
    got = tg.sage_aggregate(_t(emb), _t(idx), reduce).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[3] == 0).all()
    # padded slots must not leak emb[0] into the max (all-negative rows)
    e2 = torch.tensor([[0.0, 0.0], [-3.0, -1.0], [-2.0, -5.0]])
    mixed = torch.tensor([[1, 2, -1]])
    expect = {"max": [[-2.0, -1.0]], "mean": [[-2.5, -3.0]]}[reduce]
    np.testing.assert_allclose(tg.sage_aggregate(e2, mixed, reduce).numpy(),
                               expect)
    with pytest.raises(ValueError, match="mean|max"):
        tg.sage_aggregate(e2, mixed, "sum")
