"""The parallel layer library in both packages (ports
``tests/test_parallel_layers.py``).

Each case runs the JAX function inside ``shard_map`` on the 8 virtual
CPU devices and the port's counterpart over a topology of the same
shape on the CPU, from the same numpy inputs and the JAX-initialised
params carried across (``load_jax_params``).  Tolerance: rtol 1e-5
(plus atol 1e-6 where a value cancels towards 0) against the JAX
package's sharded result, and the port's sharded result against its
own dense one as the JAX tests hold theirs.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from paddlebox_tpu.config import MeshConfig as JMesh
from paddlebox_tpu.parallel import moe as jmoe
from paddlebox_tpu.parallel import ring_attention as jring
from paddlebox_tpu.parallel import tp_layers as jtp
from paddlebox_tpu.parallel import ulysses as july
from paddlebox_tpu.parallel.topology import HybridTopology as JTopology
from paddlebox_tpu_torch.config import MeshConfig
from paddlebox_tpu_torch.parallel import moe, ring_attention, tp_layers
from paddlebox_tpu_torch.parallel import ulysses
from paddlebox_tpu_torch.parallel.topology import (HybridTopology, Spec,
                                                   split_tree)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def topos():
    return (JTopology(JMesh(mp=4, sp=2)),
            HybridTopology(MeshConfig(mp=4, sp=2), device="cpu"))


def _np(x):
    return np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _jspecs(specs):
    return {k: P(*s) for k, s in specs.items()}


@pytest.mark.parametrize("kind", ["column", "column_local", "row",
                                  "row_parallel_input"])
def test_linear_layers_match_jax(topos, kind):
    jtopo, topo = topos
    if kind.startswith("column"):
        gather = kind == "column"
        jl = jtp.ColumnParallelLinear(16, 32, gather_output=gather)
        tl = tp_layers.ColumnParallelLinear(16, 32, gather_output=gather)
        x_shape, x_spec = (8, 16), Spec()
        out_spec = Spec() if gather else Spec(None, "mp")
    else:
        par = kind == "row_parallel_input"
        jl = jtp.RowParallelLinear(32, 8, input_is_parallel=par)
        tl = tp_layers.RowParallelLinear(32, 8, input_is_parallel=par)
        x_shape = (4, 32)
        x_spec = Spec(None, "mp") if par else Spec()
        out_spec = Spec()
    params = jl.init(jax.random.PRNGKey(0))
    params["b"] = jax.random.normal(jax.random.PRNGKey(2), params["b"].shape)
    x = jax.random.normal(jax.random.PRNGKey(1), x_shape)
    want = shard_map(jl.apply_sharded, mesh=jtopo.mesh,
                     in_specs=(_jspecs(jl.param_specs()), P(*x_spec)),
                     out_specs=P(*out_spec), check_vma=False)(params, x)
    tparams = tp_layers.load_jax_params(params, "cpu")
    tx = torch.from_numpy(_np(x).copy())
    assert tl.param_specs() == jl.param_specs()
    ys = tl.apply_sharded(split_tree(tparams, tl.param_specs(), topo),
                          topo.split(tx, x_spec), topo)
    got = topo.join(ys, out_spec)
    _close(got, want)
    _close(got, tl.apply(tparams, tx))


def test_vocab_parallel_embedding_and_init(topos):
    jtopo, topo = topos
    jl, tl = jtp.VocabParallelEmbedding(64, 8), \
        tp_layers.VocabParallelEmbedding(64, 8)
    params = jl.init(jax.random.PRNGKey(0))
    ids = np.random.default_rng(0).integers(0, 64, (4, 6))
    want = shard_map(jl.apply_sharded, mesh=jtopo.mesh,
                     in_specs=({"w": P("mp", None)}, P()), out_specs=P(),
                     check_vma=False)(params, jnp.asarray(ids))
    tparams = tp_layers.load_jax_params(params, "cpu")
    tids = torch.from_numpy(ids)
    got = topo.join(tl.apply_sharded(split_tree(tparams, tl.param_specs(),
                                                topo),
                                     topo.split(tids, Spec()), topo), Spec())
    _close(got, want, rtol=0, atol=0)
    assert torch.equal(got, tl.apply(tparams, tids))
    # the port's own init draws from a torch generator, at the JAX
    # init's shapes and scales
    gen = torch.Generator().manual_seed(0)
    w = tl.init(gen)["w"]
    assert w.shape == (64, 8) and 0.01 < float(w.std()) < 0.03
    col = tp_layers.ColumnParallelLinear(16, 32).init(gen)
    assert float(col["w"].abs().max()) <= (6.0 / 48) ** 0.5
    assert col["w"].shape == (16, 32) and not col["b"].any()
    with pytest.raises(ValueError):
        tp_layers.VocabParallelEmbedding(0, 8)


def test_parallel_cross_entropy(topos):
    jtopo, topo = topos
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (8, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (8,))
    want = shard_map(lambda lg, lb: jtp.parallel_cross_entropy(lg, lb),
                     mesh=jtopo.mesh, in_specs=(P(None, "mp"), P()),
                     out_specs=P(), check_vma=False)(jnp.asarray(logits),
                                                     jnp.asarray(labels))
    tl, tb = torch.from_numpy(logits), torch.from_numpy(labels)
    got = topo.join(tp_layers.parallel_cross_entropy(
        topo.split(tl, Spec(None, "mp")), topo.split(tb, Spec()), topo),
        Spec())
    _close(got, want)
    dense = -torch.log_softmax(tl, -1)[torch.arange(8), tb]
    _close(got, dense)


def _moe_case(gate, cf, tokens, seed=0):
    cfg = dict(d_model=16, d_hidden=32, num_experts=8, capacity_factor=cf,
               gate=gate)
    jl, tl = jmoe.MoELayer(jmoe.MoEConfig(**cfg)), \
        moe.MoELayer(moe.MoEConfig(**cfg))
    params = jl.init(jax.random.PRNGKey(seed))
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (tokens, 16))
    return jl, tl, params, x


@pytest.mark.parametrize("gate", ["switch", "gshard"])
@pytest.mark.parametrize("x_spec", [(), ("ep",)])
def test_moe_sharded_matches_jax_and_dense(gate, x_spec):
    """ep 8, high capacity (no drops): the port's sharded output = the
    JAX package's sharded output = the port's dense output; tokens
    replicated (the JAX test's layout) or split over ep."""
    jl, tl, params, x = _moe_case(gate, 8.0, 64)
    jtopo = JTopology(JMesh(ep=8))
    topo = HybridTopology(MeshConfig(ep=8), device="cpu")
    specs = {k: P(*s) for k, s in jl.param_specs().items()}
    want, jaux = shard_map(lambda p, xx: jl.apply_sharded(p, xx, ep=8),
                           mesh=jtopo.mesh, in_specs=(specs, P(*x_spec)),
                           out_specs=(P(*x_spec), P()),
                           check_vma=False)(params, x)
    tparams = tp_layers.load_jax_params(params, "cpu")
    tx = torch.from_numpy(_np(x).copy())
    ys, aux = tl.apply_sharded(split_tree(tparams, tl.param_specs(), topo),
                               topo.split(tx, Spec(*x_spec)), topo, ep=8)
    got = topo.join(ys, Spec(*x_spec))
    _close(got, want, rtol=1e-5, atol=1e-6)
    if not x_spec:
        _close(aux[0], jaux)
    dense, daux = tl.apply_dense(tparams, tx)
    _close(got, dense, rtol=1e-5, atol=1e-6)
    jdense, jdaux = jl.apply_dense(params, x)
    _close(dense, jdense, rtol=1e-5, atol=1e-6)
    _close(daux, jdaux)


@pytest.mark.parametrize("gate", ["switch", "gshard"])
def test_moe_capacity_drops_like_jax(gate):
    jl, tl, params, x = _moe_case(gate, 0.25, 32)
    want, jaux = jl.apply_dense(params, x)
    got, aux = tl.apply_dense(tp_layers.load_jax_params(params, "cpu"),
                              torch.from_numpy(_np(x).copy()))
    _close(got, want, rtol=1e-5, atol=1e-6)
    _close(aux, jaux)
    zero_rows = np.isclose(np.abs(got.numpy()).sum(-1), 0.0)
    assert zero_rows.any() and float(aux) > 0


@pytest.mark.parametrize("gate", ["top1", "top2"])
def test_gate_ties_go_to_the_lowest_expert(gate):
    """Equal logits (and, for top 2, equal runners-up): both packages
    route to the lowest expert index first."""
    logits = np.zeros((6, 4), np.float32)
    logits[1, [1, 3]] = 2.0
    logits[2, [0, 2, 3]] = 1.0
    fj, ft = getattr(jmoe, f"{gate}_gate"), getattr(moe, f"{gate}_gate")
    jd, jc, ja = fj(jnp.asarray(logits), 6)
    td, tc, ta = ft(torch.from_numpy(logits), 6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tc, jc, rtol=1e-6, atol=0)
    _close(ta, ja, rtol=1e-6, atol=0)
    first = td.sum(-1).argmax(-1)          # the expert of the first choice
    assert first[0] == 0 and first[1] == 1 and first[2] == 0


def _qkv(seed, shape=(2, 16, 4, 8)):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_jax(topos, kind, causal):
    jtopo, topo = topos
    q, k, v = _qkv(0 if kind == "ring" else 1)
    spec = P(None, "sp")
    if kind == "ring":
        jfn = lambda a, b, c: jring.ring_attention(a, b, c, "sp", 2,  # noqa
                                                   causal=causal)
    else:
        jfn = lambda a, b, c: july.ulysses_attention(a, b, c, "sp",  # noqa
                                                     causal=causal)
    want = shard_map(jfn, mesh=jtopo.mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, check_vma=False)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (topo.split(torch.from_numpy(a), Spec(None, "sp"))
                  for a in (q, k, v))
    if kind == "ring":
        outs = ring_attention.ring_attention(tq, tk, tv, topo, "sp", 2,
                                             causal=causal)
    else:
        outs = ulysses.ulysses_attention(tq, tk, tv, topo, "sp",
                                         causal=causal)
    got = topo.join(outs, Spec(None, "sp"))
    _close(got, want, rtol=1e-5, atol=2e-6)
    dense = ring_attention.reference_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    _close(got, dense, rtol=1e-4, atol=2e-5)      # the JAX test's bound
    _close(dense, jring.reference_attention(*map(jnp.asarray, (q, k, v)),
                                            causal=causal))
