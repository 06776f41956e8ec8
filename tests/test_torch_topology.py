"""Topology and named-axis collectives in both packages.

Ports ``tests/test_topology.py``: the JAX package runs its collectives
inside ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py``; the port runs them over a topology's per-shard
lists on the CPU.  Layouts are compared block for block (JAX's
``devices_indices_map`` against the port's ``split``), collectives value
for value: every value here is a small integer or a sum of a few
normals, exact in f32 in any order, so results are held equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from paddlebox_tpu.config import MeshConfig as JMesh
from paddlebox_tpu.parallel import collective as jcol
from paddlebox_tpu.parallel.topology import HybridTopology as JTopology
from paddlebox_tpu.parallel.topology import single_host_topology as jsingle
from paddlebox_tpu_torch.config import MeshConfig as TMesh
from paddlebox_tpu_torch.parallel import collective as tcol
from paddlebox_tpu_torch.parallel.topology import (AXES, HybridTopology,
                                                   Spec,
                                                   single_host_topology)


def jtopo(**degrees):
    n = JMesh(**degrees).world_size
    return JTopology(JMesh(**degrees), jax.devices()[:n])


def ttopo(**degrees):
    return HybridTopology(TMesh(**degrees), device="cpu")


def jmap(topo, f, in_specs, out_specs):
    return shard_map(f, mesh=topo.mesh, in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


def test_mesh_degrees():
    for topo in (jtopo(dp=2, mp=4), ttopo(dp=2, mp=4)):
        assert topo.world_size == 8
        assert topo.axis_size("dp") == 2
        assert topo.axis_size("mp") == 4
        assert topo.axis_size("pp") == 1
    t, j = ttopo(dp=2, sharding=2, mp=2), jtopo(dp=2, sharding=2, mp=2)
    for k in range(8):
        dev = j.mesh.devices.flat[k]
        assert t.coord(k) == j.coord(dev)


def test_bad_degrees_raises():
    """A device list the degrees do not fill raises the JAX message."""
    with pytest.raises(ValueError) as je:
        JTopology(JMesh(dp=3))
    with pytest.raises(ValueError) as te:
        HybridTopology(TMesh(dp=3), devices=["cpu"] * len(jax.devices()))
    assert str(te.value) == str(je.value)


def test_distinct_devices_raise():
    """Shards on distinct devices are placed, each block on its shard's
    device (``cpu:0`` and ``cpu:1`` are two devices in host memory: a
    copy, never a view, crosses between them).  A device the machine does
    not have raises; one device keeps views."""
    topo = HybridTopology(TMesh(dp=2), devices=["cpu:0", "cpu:1"])
    assert topo.multi_device and topo.device == torch.device("cpu", 0)
    assert topo.groups == [(torch.device("cpu", 0), [0]),
                           (torch.device("cpu", 1), [1])]
    x = torch.arange(8.0).reshape(4, 2)
    parts = topo.split(x, topo.batch_spec())
    assert [topo.device_of(k) for k in range(2)] == topo.devices
    assert all(p.data_ptr() != x.data_ptr() for p in parts)
    np.testing.assert_array_equal(topo.join(parts, topo.batch_spec()), x)
    placed = topo.place(x, topo.table_spec())
    assert placed.shape == x.shape and placed.rows(1) == slice(2, 4)
    np.testing.assert_array_equal(np.asarray(placed), x)
    with pytest.raises(RuntimeError):
        HybridTopology(TMesh(dp=2), devices=["cpu", "cuda:7"])
    topo = HybridTopology(TMesh(dp=2), devices=["cpu", "cpu"])
    assert topo.device == torch.device("cpu") and not topo.multi_device
    assert topo.split(x, topo.batch_spec())[1].data_ptr() == x[2:].data_ptr()


def _blocks_match(t, j, spec, shape):
    """The port's block of every shard = JAX's index of the same device
    under the same spec."""
    jmap_ = j.sharding(*spec).devices_indices_map(shape)
    for k in range(t.world_size):
        want = jmap_[j.mesh.devices.flat[k]]
        got = t._slices(Spec(*spec), shape, k)
        want = tuple(slice(s.start or 0, shape[d] if s.stop is None
                           else s.stop) for d, s in enumerate(want))
        assert got == want, (k, spec)


@pytest.mark.parametrize("degrees", [dict(dp=8), dict(dp=2, sharding=4),
                                     dict(dp=2, mp=4)])
def test_layouts_match_jax(degrees):
    t, j = ttopo(**degrees), jtopo(**degrees)
    assert tuple(t.batch_spec()) == tuple(j.batch_spec())
    assert tuple(t.table_spec()) == tuple(j.table_spec())
    assert tuple(t.mp_spec(1, 2)) == tuple(j.mp_spec(1, 2))
    assert t.multinode_table() == j.multinode_table()
    assert t.num_table_shards() == j.num_table_shards()
    _blocks_match(t, j, tuple(t.batch_spec()), (16, 3))
    _blocks_match(t, j, tuple(t.table_spec()), (64, 2))
    _blocks_match(t, j, (None, ("dp", "sharding")), (3, 16))


def test_batch_sharding_places_data():
    topo = single_host_topology(dp=8, device="cpu")
    assert topo.world_size == 8
    x = torch.arange(16.0).reshape(16, 1)
    parts = topo.split(x, topo.batch_spec())
    assert len(parts) == 8 and all(p.shape == (2, 1) for p in parts)
    assert all(p.data_ptr() == x[2 * k:].data_ptr()
               for k, p in enumerate(parts))          # views, no copy
    np.testing.assert_array_equal(topo.join(parts, topo.batch_spec()), x)
    xs = jax.device_put(jnp.arange(16.0).reshape(16, 1),
                        jsingle(dp=8).batch_sharding())
    assert len(xs.sharding.device_set) == 8


def test_axis_groups():
    t = ttopo(dp=2, sharding=4)
    assert t.axis_groups(("dp", "sharding")) == [list(range(8))]
    assert t.axis_groups("sharding") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert t.axis_groups("dp") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert [t.axis_index(k, "sharding") for k in range(8)] == \
        [0, 1, 2, 3] * 2
    assert tcol.axis_index(t, "dp") == [0] * 4 + [1] * 4
    assert AXES == ("dp", "sharding", "pp", "mp", "sp", "ep")


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean"])
def test_all_reduce_matches_jax(op):
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 8, (8, 4)).astype(np.float32)
    topo = single_host_topology(dp=8, device="cpu")
    got = tcol.all_reduce(topo.split(torch.as_tensor(x), Spec("dp")),
                          topo, "dp", op)
    # one value for the group, a tensor of its own for every member
    assert len({g.data_ptr() for g in got}) == len(got)
    assert all(torch.equal(g, got[0]) for g in got)
    want = jmap(jsingle(dp=8),
                lambda xs: jcol.all_reduce(xs, "dp", op),
                P("dp"), P())(jnp.asarray(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="unsupported all_reduce op"):
        tcol.all_reduce(got, topo, "dp", "prod")


def test_all_reduce_inside_shard_map():
    """The JAX file's case: the sum over dp of each shard's sum."""
    topo = single_host_topology(dp=8, device="cpu")
    f = tcol.shard_mapped(topo, (Spec("dp"),), Spec())(
        lambda xs: tcol.all_reduce([x.sum() for x in xs], topo, "dp"))
    assert float(f(torch.ones((8, 4)))) == 32.0


def test_all_to_all_roundtrip():
    n = 8
    x = np.arange(n * n, dtype=np.float32).reshape(n, n)
    topo = single_host_topology(dp=8, device="cpu")
    xs = topo.split(torch.as_tensor(x), Spec("dp", None))
    y = tcol.all_to_all(xs, topo, "dp", split_dim=1, concat_dim=0)
    z = tcol.all_to_all(y, topo, "dp", split_dim=0, concat_dim=1)
    np.testing.assert_array_equal(topo.join(z, Spec("dp", None)), x)
    jy = jmap(jsingle(dp=8),
              lambda v: jcol.all_to_all(v, "dp", split_dim=1, concat_dim=0),
              P("dp", None), P("dp", None))(jnp.asarray(x))
    np.testing.assert_array_equal(topo.join(y, Spec("dp", None)),
                                  np.asarray(jy))
    with pytest.raises(ValueError, match="tiled"):
        tcol.all_to_all(xs, topo, "dp", tiled=False)


def test_ring_shift():
    x = np.arange(8.0, dtype=np.float32).reshape(8, 1)
    topo = single_host_topology(dp=8, device="cpu")
    out = topo.join(tcol.shift_right(topo.split(torch.as_tensor(x),
                                                Spec("dp")), topo, "dp", 8),
                    Spec("dp")).numpy().ravel()
    np.testing.assert_array_equal(out, np.roll(np.arange(8.0), 1))
    want = jmap(jsingle(dp=8), lambda v: jcol.shift_right(v, "dp", 8),
                P("dp"), P("dp"))(jnp.asarray(x))
    np.testing.assert_array_equal(out, np.asarray(want).ravel())


def test_all_gather_reduce_scatter_ppermute_match_jax():
    """On the sharding axis of a dp 2 × sharding 4 mesh: each dp group
    gathers / reduce-scatters its own shards; a ppermute with a
    receiver-less member gives it zeros."""
    rng = np.random.default_rng(4)
    x = rng.integers(-4, 4, (8, 8)).astype(np.float32)
    t, j = ttopo(dp=2, sharding=4), jtopo(dp=2, sharding=4)
    spec = (("dp", "sharding"), None)
    xs = t.split(torch.as_tensor(x), Spec(*spec))
    perm = [(0, 1), (1, 2), (2, 0)]
    cases = {
        "gather": (lambda v: tcol.all_gather(v, t, "sharding",
                                             concat_dim=1),
                   lambda v: jcol.all_gather(v, "sharding", concat_dim=1),
                   ("dp", None)),
        "gather_stacked": (
            lambda v: tcol.all_gather(v, t, "sharding", concat_dim=0,
                                      tiled=False),
            lambda v: jcol.all_gather(v, "sharding", concat_dim=0,
                                      tiled=False),
            (None, "dp", None)),
        "reduce_scatter": (
            lambda v: tcol.reduce_scatter(v, t, "sharding", scatter_dim=1),
            lambda v: jcol.reduce_scatter(v, "sharding", scatter_dim=1),
            ("dp", "sharding")),
        "ppermute": (lambda v: tcol.ppermute(v, t, "sharding", perm),
                     lambda v: jcol.ppermute(v, "sharding", perm),
                     (("dp", "sharding"), None)),
    }
    for name, (tf, jf, out_spec) in cases.items():
        got = t.join(tf(xs), Spec(*out_spec)).numpy()
        want = np.asarray(jmap(j, jf, P(*spec), P(*out_spec))(
            jnp.asarray(x)))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_package_exports_topology_lazily():
    import paddlebox_tpu_torch.parallel as par
    assert par.HybridTopology is HybridTopology
    with pytest.raises(AttributeError):
        par.NoSuchThing
