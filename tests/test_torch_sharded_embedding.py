"""The sharded embedding exchange in both packages.

The JAX package runs each function inside ``shard_map`` on the 8 virtual
CPU devices of ``tests/conftest.py`` (its sorted kernels in interpret
mode); the port runs the same function over a topology's per-shard lists
on ``device="cpu"`` (the kernels' plain versions).  The same numpy-seeded
inputs go through both.

Tolerances: the port's pull is exact (one owner per value, every other
shard adds zeros), held bit-equal to the table's columns; JAX's interpret
gather runs its one-hot matmul as a hi/lo split (~2^-17 relative, 96 % of
the values differ in the last bits), so port against JAX: rtol 1e-5 /
atol 1e-5 (measured 1.5e-5 abs at 7.4e-6 relative), and under the bf16
exchange one bf16 ulp (rtol 2^-7: the split moves a few values across a
rounding boundary).  The merged pushes sum in another order (the hi/lo
split against a plain index_add): rtol 1e-5 / atol 1e-5, plus 1e-5 of
each row's sum of |terms| where rows repeat many times (as chip_smoke
holds the card's scatter).  A slot-carry row (``first_only_col``) is one
value per row, held bit-equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh, PartitionSpec as P

from paddlebox_tpu import flags as jflags
from paddlebox_tpu.ps import sharded_embedding as jse
from paddlebox_tpu_torch.config import MeshConfig
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.parallel.topology import HybridTopology, Spec
from paddlebox_tpu_torch.ps import sharded_embedding as tse

NDEV = 8
N, D = 64, 4                      # 8 rows a shard (the JAX file's sizes)
W, ROWS_LOC, P_LOC = 16, 64, 24   # the mxu variants
PUSH_TOL = dict(rtol=1e-5, atol=1e-5)
PULL_TOL = PUSH_TOL
BF16_ULP = dict(rtol=2.0 ** -7, atol=0.0)


def assert_push_close(got, want, idx, payload):
    """|got - want| <= 1e-5 |want| + 1e-5 Σ|terms| + 1e-5 per row."""
    abs_sum = np.zeros_like(want)
    np.add.at(abs_sum.T, idx, np.abs(payload[:want.shape[0]]).T)
    err = np.abs(got - want)
    assert (err <= 1e-5 * np.abs(want) + 1e-5 * abs_sum + 1e-5).all(), \
        err.max()


def jax_map(f, mesh, in_specs, out_specs):
    # check_vma=False: pallas_call out_shapes carry no vma annotation
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


@pytest.fixture(scope="module")
def topo():
    return HybridTopology(MeshConfig(mp=NDEV), device="cpu")


@pytest.fixture(scope="module")
def flat():
    """A flat pool of 8 table shards and its JAX mesh (axis "tbl")."""
    return (HybridTopology(MeshConfig(dp=NDEV), device="cpu"),
            Mesh(np.array(jax.devices()[:NDEV]), ("tbl",)))


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# -- the gather / scatter versions (the JAX file's three tests) ---------------

def test_pull_matches_gather(topo):
    rng = np.random.default_rng(0)
    table = rng.normal(0, 1, (N, D)).astype(np.float32)
    idx = rng.integers(0, N, (32,)).astype(np.int32)
    got = topo.join(tse.pull_rows_sharded(
        topo.split(_t(table), Spec("mp")), topo.split(_t(idx), Spec("mp")),
        topo, "mp"), Spec("mp"))
    np.testing.assert_allclose(got.numpy(), table[idx], atol=1e-6)
    f = jax_map(lambda t, i: jse.pull_rows_sharded(t, i, "mp"),
                Mesh(np.array(jax.devices()[:NDEV]), ("mp",)),
                (P("mp", None), P("mp")), P("mp", None))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(f(jnp.asarray(table), jnp.asarray(idx))))


def test_push_matches_scatter_add(topo):
    rng = np.random.default_rng(1)
    table = rng.normal(0, 1, (N, D)).astype(np.float32)
    idx = rng.integers(0, N, (32,)).astype(np.int32)
    grads = rng.normal(0, 1, (32, D)).astype(np.float32)
    got = topo.join(tse.push_rows_sharded(
        topo.split(_t(table), Spec("mp")), topo.split(_t(idx), Spec("mp")),
        topo.split(_t(grads), Spec("mp")), topo, "mp"), Spec("mp"))
    want = table.copy()
    np.add.at(want, idx, grads)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    f = jax_map(lambda t, i, g: jse.push_rows_sharded(t, i, g, "mp"),
                Mesh(np.array(jax.devices()[:NDEV]), ("mp",)),
                (P("mp", None), P("mp"), P("mp", None)), P("mp", None))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(f(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(grads))), atol=1e-5)


def test_pull_push_roundtrip_train_signal(topo):
    """One sharded SGD step on a toy loss equals the one-device step."""
    rng = np.random.default_rng(2)
    table = rng.normal(0, 1, (N, D)).astype(np.float32)
    idx = rng.integers(0, N, (16,)).astype(np.int32)
    target = rng.normal(0, 1, (16, D)).astype(np.float32)
    tab = topo.split(_t(table), Spec("mp"))
    ids = topo.split(_t(idx), Spec("mp"))
    vals = tse.pull_rows_sharded(tab, ids, topo, "mp")
    g = [-0.1 * 2.0 * (v - t) for v, t in
         zip(vals, topo.split(_t(target), Spec("mp")))]
    got = topo.join(tse.push_rows_sharded(tab, ids, g, topo, "mp"),
                    Spec("mp"))
    want = table.copy()
    np.add.at(want, idx, -0.1 * 2.0 * (table[idx] - target))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# -- the mxu variants ------------------------------------------------------------

def _mxu_inputs(seed=0, n_dev=NDEV):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (W, ROWS_LOC * n_dev)).astype(np.float32)
    idx = rng.integers(0, ROWS_LOC * n_dev, (P_LOC * n_dev,)).astype(
        np.int32)
    payload = rng.normal(0, 1, (W, P_LOC * n_dev)).astype(np.float32)
    return table, idx, payload


def _torch_pull(topo, axis, table, idx, **kw):
    tspec = Spec(None, axis)
    out = tse.pull_rows_sharded_mxu(topo.split(_t(table), tspec),
                                    topo.split(_t(idx), Spec(axis)),
                                    topo, axis, **kw)
    return topo.join(out, tspec).numpy()


def _torch_push(topo, axis, idx, payload, **kw):
    tspec = Spec(None, axis)
    out = tse.push_rows_sharded_mxu(topo.split(_t(idx), Spec(axis)),
                                    topo.split(_t(payload), tspec),
                                    ROWS_LOC, topo, axis, **kw)
    return topo.join(out, tspec).numpy()


def test_pull_push_sharded_mxu_matches_dense(flat):
    """The JAX file's mxu test: a pull is the table's columns, a push
    the dense scatter-add, in both packages."""
    topo, mesh = flat
    table, idx, payload = _mxu_inputs()
    got = _torch_pull(topo, "dp", table, idx)
    np.testing.assert_array_equal(got, table[:, idx])
    acc = _torch_push(topo, "dp", idx, payload)
    ref = np.zeros_like(table)
    np.add.at(ref.T, idx, payload.T)
    np.testing.assert_allclose(acc, ref, atol=1e-5, rtol=1e-5)
    jacc = jax_map(
        lambda i, g: jse.push_rows_sharded_mxu(i, g, ROWS_LOC, "tbl",
                                               interpret=True),
        mesh, (P("tbl"), P(None, "tbl")), P(None, "tbl"))(
        jnp.asarray(idx), jnp.asarray(payload))
    np.testing.assert_allclose(np.asarray(jacc), ref, atol=1e-3, rtol=1e-4)


def test_pull_and_push_mxu_match_jax(flat):
    """n_dev 8, rows_loc 64, W 16: the pull bit-equal to the table's
    columns and within rtol/atol 1e-5 of JAX's ``pull_rows_sharded_mxu``,
    the push within rtol/atol 1e-5 of its ``push_rows_sharded_mxu``; the
    same plans from ``local_plan``."""
    topo, mesh = flat
    table, idx, payload = _mxu_inputs(seed=3)
    jpull = jax_map(
        lambda t, i: jse.pull_rows_sharded_mxu(t, i, "tbl", interpret=True),
        mesh, (P(None, "tbl"), P("tbl")), P(None, "tbl"))
    got = _torch_pull(topo, "dp", table, idx)
    np.testing.assert_array_equal(got, table[:, idx])
    np.testing.assert_allclose(
        got, np.asarray(jpull(jnp.asarray(table), jnp.asarray(idx))),
        **PULL_TOL)
    jpush = jax_map(
        lambda i, g: jse.push_rows_sharded_mxu(i, g, ROWS_LOC, "tbl",
                                               interpret=True),
        mesh, (P("tbl"), P(None, "tbl")), P(None, "tbl"))
    np.testing.assert_allclose(
        _torch_push(topo, "dp", idx, payload),
        np.asarray(jpush(jnp.asarray(idx), jnp.asarray(payload))),
        **PUSH_TOL)
    # the plans themselves: every array of every shard equal
    jplan = jax_map(lambda i: jse.local_plan(i, ROWS_LOC, "tbl")[1],
                    mesh, (P("tbl"),), (P("tbl", None, None),)
                    + (P("tbl"),) * 7)(jnp.asarray(idx))
    dims, plans = tse.local_plan(topo.split(_t(idx), Spec("dp")), ROWS_LOC,
                                 topo, "dp")
    for j, arr in enumerate(jplan):
        got = torch.cat([pl[j] for pl in plans]).numpy()
        np.testing.assert_array_equal(got, np.asarray(arr), err_msg=str(j))


def _slot_payload(seed):
    """A push payload whose last row is a slot id (100..103) per
    occurrence, with ids that repeat within and across shards."""
    table, idx, payload = _mxu_inputs(seed)
    idx = idx % 96            # repeats, rows of the first two blocks
    rng = np.random.default_rng(seed + 1)
    payload[-1] = rng.integers(100, 104, payload.shape[1]).astype(
        np.float32)
    return idx, payload


def test_first_only_col_matches_jax(flat):
    """The slot carry: the first gathered occurrence of each row keeps
    its slot id, the merge of that row returns it exactly."""
    topo, mesh = flat
    idx, payload = _slot_payload(5)
    c = W - 1
    got = _torch_push(topo, "dp", idx, payload, first_only_col=c)
    jpush = jax_map(
        lambda i, g: jse.push_rows_sharded_mxu(
            i, g, ROWS_LOC, "tbl", interpret=True, first_only_col=c),
        mesh, (P("tbl"), P(None, "tbl")), P(None, "tbl"))
    want = np.asarray(jpush(jnp.asarray(idx), jnp.asarray(payload)))
    np.testing.assert_array_equal(got[c], want[c])
    assert_push_close(got[:c], want[:c], idx, payload)
    # the first occurrence in gathered (shard) order carries the slot
    first = {}
    for pos, r in enumerate(idx):
        first.setdefault(int(r), payload[c, pos])
    for r, slot in first.items():
        assert got[c, r] == slot
    untouched = np.setdiff1d(np.arange(got.shape[1]), idx)
    assert not got[:, untouched].any()


def test_multinode_push_matches_jax():
    """dp 2 × sharding 4: each node merges its own batch into its
    sharding block, the node deltas summed over dp and the slot row the
    max over dp — against ``push_rows_sharded_mxu_multinode``."""
    topo = HybridTopology(MeshConfig(dp=2, sharding=4), device="cpu")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("dp", "sharding"))
    rng = np.random.default_rng(9)
    n_rows = ROWS_LOC * 4
    idx = rng.integers(0, n_rows, (P_LOC * 8,)).astype(np.int32)
    payload = rng.normal(0, 1, (W, P_LOC * 8)).astype(np.float32)
    payload[-1] = rng.integers(100, 104, P_LOC * 8).astype(np.float32)
    c = W - 1
    bspec = Spec(("dp", "sharding"))
    out = tse.push_rows_sharded_mxu_multinode(
        topo.split(_t(idx), bspec),
        topo.split(_t(payload), Spec(None, ("dp", "sharding"))), ROWS_LOC,
        topo, ("sharding",), "dp", first_only_col=c)
    got = topo.join(out, Spec(None, ("sharding",))).numpy()
    jf = jax_map(
        lambda i, g: jse.push_rows_sharded_mxu_multinode(
            i, g, ROWS_LOC, "sharding", "dp", interpret=True,
            first_only_col=c),
        mesh, (P(("dp", "sharding")), P(None, ("dp", "sharding"))),
        P(None, "sharding"))
    want = np.asarray(jf(jnp.asarray(idx), jnp.asarray(payload)))
    np.testing.assert_array_equal(got[c], want[c])
    np.testing.assert_allclose(got[:c], want[:c], **PUSH_TOL)
    ref = np.zeros((c, n_rows), np.float32)
    np.add.at(ref.T, idx, payload[:c].T)
    np.testing.assert_allclose(got[:c], ref, rtol=1e-5, atol=1e-5)


@pytest.fixture
def jax_bf16():
    old = jflags.get_flags("sharded_exchange_bf16")
    jflags.set_flags({"sharded_exchange_bf16": True})
    try:
        yield
    finally:
        jflags.set_flags({"sharded_exchange_bf16": old})


def test_bf16_exchange_matches_jax(flat, jax_bf16):
    """The bf16 exchange: pulls round each value once (bit-equal to
    JAX's), pushes round the payload body and keep the slot row f32
    (exact: ids above 256 would not survive bf16)."""
    topo, mesh = flat
    table, idx, _ = _mxu_inputs(seed=7)
    got = _torch_pull(topo, "dp", table, idx, exchange_bf16=True)
    jpull = jax_map(
        lambda t, i: jse.pull_rows_sharded_mxu(t, i, "tbl", interpret=True),
        mesh, (P(None, "tbl"), P("tbl")), P(None, "tbl"))
    np.testing.assert_allclose(
        got, np.asarray(jpull(jnp.asarray(table), jnp.asarray(idx))),
        **BF16_ULP)
    rounded = torch.as_tensor(table[:, idx]).to(torch.bfloat16).float()
    np.testing.assert_array_equal(got, rounded.numpy())
    idx, payload = _slot_payload(11)
    payload[-1] += 1000.0       # slot ids bf16 cannot hold
    c = W - 1
    got = _torch_push(topo, "dp", idx, payload, first_only_col=c,
                      exchange_bf16=True)
    jpush = jax_map(
        lambda i, g: jse.push_rows_sharded_mxu(
            i, g, ROWS_LOC, "tbl", interpret=True, first_only_col=c),
        mesh, (P("tbl"), P(None, "tbl")), P(None, "tbl"))
    want = np.asarray(jpush(jnp.asarray(idx), jnp.asarray(payload)))
    np.testing.assert_array_equal(got[c], want[c])
    assert_push_close(got[:c], want[:c], idx, payload)
    exact = _torch_push(topo, "dp", idx, payload, first_only_col=c,
                        exchange_bf16=False)
    np.testing.assert_array_equal(got[c], exact[c])
    assert set(np.unique(got[c][got[c] != 0])) <= set(range(1100, 1104))
    np.testing.assert_allclose(got[:c], exact[:c], rtol=2e-2, atol=2e-2)


def test_plan_dims_refuses_a_trimmed_plan(flat):
    """A trimmed plan (its sorted arrays shortened, inv_perm full) is
    refused, as JAX's ``_plan_dims`` refuses it."""
    topo, _ = flat
    table, idx, _ = _mxu_inputs(seed=1)
    dims, plans = tse.local_plan(topo.split(_t(idx), Spec("dp")), ROWS_LOC,
                                 topo, "dp")
    assert tse._plan_dims(plans[0], ROWS_LOC) == dims
    p_big = 4 * sp.CHUNK * NDEV      # room for a trim of whole chunks
    big = np.random.default_rng(2).integers(
        0, ROWS_LOC * NDEV, (p_big,)).astype(np.int32)
    dims_b = sp.spmm_dims(p_big, ROWS_LOC)
    eff = sp.with_p_pad(dims_b, dims_b.p_pad // 2)
    trimmed = sp.build_plan(torch.as_tensor(big) % ROWS_LOC, dims_b, eff)
    with pytest.raises(ValueError, match="untrimmed local_plan"):
        tse._plan_dims(trimmed, ROWS_LOC)
    jtrim = tuple(jnp.asarray(a.numpy()) for a in trimmed)
    with pytest.raises(ValueError, match="untrimmed local_plan"):
        jse._plan_dims(jtrim, ROWS_LOC)
    with pytest.raises(ValueError, match="untrimmed local_plan"):
        tse.pull_rows_sharded_mxu(
            topo.split(_t(table), Spec(None, "dp")),
            topo.split(_t(idx), Spec("dp")), topo, "dp",
            plans=[trimmed] * NDEV)
