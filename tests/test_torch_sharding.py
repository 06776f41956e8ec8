"""ZeRO sharding in both packages (ports ``tests/test_sharding.py``).

The JAX package places with NamedShardings and runs its stage-2 update
inside ``shard_map`` on the 8 virtual CPU devices; the port places by
Spec over a topology's shards and runs the stage-2 update with one
``torch.optim.Adam`` a shard.  Tolerance of the stage-2 update: rtol
1e-6 against the port's unsharded Adam on the summed grads (the same
update; the grads summed in shard order instead of ``sum(0)``), and
atol 1e-6 against the JAX package's stage-2 update (optax's Adam, the
JAX test's own bound).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import optax
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from paddlebox_tpu.config import MeshConfig as JMesh
from paddlebox_tpu.parallel.sharding import GroupShardedOptimizer as JGSO
from paddlebox_tpu.parallel.sharding import zero_sharding as jzero_sharding
from paddlebox_tpu.parallel.sharding import zero_spec as jzero_spec
from paddlebox_tpu.parallel.topology import HybridTopology as JTopology
from paddlebox_tpu_torch.config import MeshConfig as TMesh
from paddlebox_tpu_torch.parallel.sharding import (GroupShardedOptimizer,
                                                   gather_params, place_like,
                                                   scatter_grads,
                                                   zero_sharding, zero_spec)
from paddlebox_tpu_torch.parallel.topology import HybridTopology, Spec


@pytest.fixture(scope="module")
def topo():
    return HybridTopology(TMesh(sharding=8), device="cpu")


@pytest.fixture(scope="module")
def jtopo():
    return JTopology(JMesh(sharding=8))


def test_zero_spec_picks_first_divisible_dim():
    for shape, want in (((3, 16), Spec(None, "sharding")), ((5,), Spec()),
                        ((16, 3), Spec("sharding", None))):
        got = zero_spec(torch.zeros(shape), "sharding", 8)
        assert got == want
        assert tuple(got) == tuple(jzero_spec(jnp.zeros(shape),
                                              "sharding", 8))


def test_zero_sharding_places_opt_state(topo, jtopo):
    """Adam's state sliced over the 8 shards where a dim divides, else
    replicated — the JAX package's placement of optax's state."""
    params = {"w": torch.ones((16, 4), requires_grad=True),
              "b": torch.ones((3,), requires_grad=True)}
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    state = {n: dict(opt.state[p]) for n, p in params.items()}
    specs = zero_sharding(state, topo)
    placed = place_like(state, specs, topo)
    mu_w, mu_b = placed["w"]["exp_avg"], placed["b"]["exp_avg"]
    assert len(mu_w) == 8 and all(m.shape == (2, 4) for m in mu_w)
    assert len({m.data_ptr() for m in mu_w}) == 8         # 8 slices
    assert all(m.shape == (3,) for m in mu_b)
    assert len({m.data_ptr() for m in mu_b}) == 1         # replicated
    assert specs["w"]["step"] == Spec()                   # a 0-d count
    jstate = optax.adam(1e-2).init({"w": jnp.ones((16, 4)),
                                    "b": jnp.ones((3,))})
    jsh = jzero_sharding(jstate, jtopo)
    assert tuple(specs["w"]["exp_avg"]) == tuple(jsh[0].mu["w"].spec)
    assert tuple(specs["b"]["exp_avg_sq"]) == tuple(jsh[0].nu["b"].spec)


def _inputs():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(0, 1, (16, 8)).astype(np.float32),
              "b": rng.normal(0, 1, (8,)).astype(np.float32)}
    # per-shard grads — their sum over the axis is the global grad
    grads = {"w": rng.normal(0, 1, (8, 16, 8)).astype(np.float32),
             "b": rng.normal(0, 1, (8, 8)).astype(np.float32)}
    return params, grads


def test_stage2_update_matches_unsharded(topo, jtopo):
    params, grads = _inputs()
    gso = GroupShardedOptimizer(lambda ps: torch.optim.Adam(ps, lr=1e-2),
                                topo)
    full = {k: torch.as_tensor(v) for k, v in params.items()}
    gso.init(full)
    got = gso.update({k: list(torch.as_tensor(v)) for k, v in grads.items()},
                     full)
    for k in params:
        assert len(got[k]) == 8
        assert all(torch.equal(g, got[k][0]) for g in got[k])

    # golden: one unsharded Adam on the summed grads
    ref = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = torch.optim.Adam(ref.values(), lr=1e-2)
    for k, p in ref.items():
        p.grad = torch.as_tensor(grads[k].sum(0))
    opt.step()
    for k in params:
        np.testing.assert_allclose(got[k][0].numpy(),
                                   ref[k].detach().numpy(), rtol=1e-6)

    # the JAX package's stage-2 update on the same inputs
    tx = optax.adam(1e-2)
    jgs = JGSO(tx, axis="sharding")

    def run(p, gw, gb):
        st = jgs.init(p, 8)
        new_p, _ = jgs.update({"w": gw[0], "b": gb[0]}, st, p)
        return new_p

    want = shard_map(run, mesh=jtopo.mesh,
                     in_specs=(P(), P("sharding"), P("sharding")),
                     out_specs=P(), check_vma=False)(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(grads["w"]), jnp.asarray(grads["b"]))
    for k in params:
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]),
                                   atol=1e-6)


def test_scatter_and_gather_round_trip(topo):
    """scatter_grads leaves each shard the summed block it owns (a leaf
    that does not split is summed whole); gather_params reassembles."""
    params, grads = _inputs()
    odd = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    tree = {k: list(torch.as_tensor(v)) for k, v in grads.items()}
    tree["odd"] = list(torch.as_tensor(odd))
    sc = scatter_grads(tree, topo)
    for k in grads:
        whole = torch.cat(sc[k], dim=0).numpy()
        np.testing.assert_allclose(whole, grads[k].sum(0), rtol=1e-6)
    assert all(torch.equal(s, torch.as_tensor(odd.sum(0)))
               for s in sc["odd"])
    shapes = {k: torch.zeros(v.shape[1:]) for k, v in grads.items()}
    shapes["odd"] = torch.zeros((3,))
    back = gather_params(sc, shapes, topo)
    for k in grads:
        np.testing.assert_allclose(back[k][3].numpy(), grads[k].sum(0),
                                   rtol=1e-6)
    assert back["odd"] is sc["odd"]
