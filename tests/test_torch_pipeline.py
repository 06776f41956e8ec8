"""Pipelines in both packages (ports ``tests/test_pipeline.py``).

The JAX runners run inside ``shard_map`` on the 8 virtual CPU devices;
the port's run the same schedules tick by tick over a topology of the
same shape on the CPU, from the same numpy params and microbatches.
Tolerance: outputs, losses and grads within rtol 1e-5 / atol 1e-6 of
the JAX package's, and within the JAX tests' bounds of the port's own
sequential run.  The 1F1B runners keep at most 2·pp microbatch inputs
in their stash (``stash_slots``), fewer than the microbatches.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from paddlebox_tpu.config import MeshConfig as JMesh
from paddlebox_tpu.parallel import pipeline as jpipe
from paddlebox_tpu.parallel.topology import HybridTopology as JTopology
from paddlebox_tpu_torch.config import MeshConfig
from paddlebox_tpu_torch.parallel import pipeline as tpipe
from paddlebox_tpu_torch.parallel.topology import (HybridTopology, Spec,
                                                   join_tree, split_tree)

PP, D = 4, 8


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _stage_params(seed, d=D, scale=0.5, bias=0.0):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, scale, (d, d)).astype(np.float32),
             "b": rng.normal(0, bias, (d,)).astype(np.float32)}
            for _ in range(PP)]


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _tstage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _torch_tree(tree, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def _sequential(per_stage, micro):
    out = []
    for m in range(micro.shape[0]):
        x = micro[m]
        for p in per_stage:
            x = _tstage(p, x)
        out.append(x)
    return torch.stack(out)


@pytest.mark.parametrize("mesh", [{"pp": PP}, {"pp": PP, "mp": 2}])
def test_gpipe_forward_and_backward_match_jax(mesh):
    """GPipe (mp 2 runs two pipelines side by side): the forward, and the
    grads of sum(out²) through torch's autograd of the tick loop."""
    per_stage = _stage_params(2, bias=0.1)
    stacked = {k: np.stack([p[k] for p in per_stage]) for k in ("w", "b")}
    micro = np.random.default_rng(3).normal(0, 1, (6, 4, D)).astype(
        np.float32)
    jmesh = (JTopology(JMesh(**mesh)).mesh if "mp" in mesh else
             Mesh(np.array(jax.devices()[:PP]), ("pp",)))
    jrun = jpipe.PipelineRunner(_jstage, PP)
    specs = {"w": P("pp"), "b": P("pp")}

    def piped_loss(params, mb):
        f = shard_map(jrun, mesh=jmesh, in_specs=(specs, P()),
                      out_specs=P(), check_vma=False)
        return jnp.sum(f(params, mb) ** 2)

    jstacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    want = shard_map(jrun, mesh=jmesh, in_specs=(specs, P()),
                     out_specs=P(), check_vma=False)(jstacked,
                                                     jnp.asarray(micro))
    jgrad = jax.grad(piped_loss)(jstacked, jnp.asarray(micro))

    topo = HybridTopology(MeshConfig(**mesh), device="cpu")
    params = _torch_tree(stacked, grad=True)
    outs = tpipe.PipelineRunner(_tstage, PP)(
        split_tree(params, Spec("pp"), topo),
        topo.split(torch.from_numpy(micro), Spec()), topo)
    got = topo.join(outs, Spec())
    _close(got.detach(), want)
    (got ** 2).sum().backward()
    for k in ("w", "b"):
        _close(params[k].grad, jgrad[k], rtol=1e-5, atol=1e-5)
    seq_params = [_torch_tree(p, grad=True) for p in per_stage]
    seq = _sequential(seq_params, torch.from_numpy(micro))
    _close(got.detach(), seq.detach(), rtol=1e-5, atol=1e-5)
    (seq ** 2).sum().backward()
    for i, p in enumerate(seq_params):
        for k in ("w", "b"):
            _close(params[k].grad[i], p[k].grad, rtol=1e-4, atol=1e-4)


def _mse(y, t):
    return ((y - t) ** 2).mean()


def test_1f1b_matches_jax_and_sequential():
    pp, n_mb, bm = PP, 10, 8
    rng = np.random.default_rng(0)
    per_stage = [{"w": rng.normal(0, 0.3, (16, 16)).astype(np.float32),
                  "b": rng.normal(0, 0.1, (16,)).astype(np.float32)}
                 for _ in range(pp)]
    stacked = {k: np.stack([p[k] for p in per_stage]) for k in ("w", "b")}
    mbs = rng.normal(0, 1, (n_mb, bm, 16)).astype(np.float32)
    tgt = rng.normal(0, 1, (n_mb, bm, 16)).astype(np.float32)

    mesh = Mesh(np.array(jax.devices()[:pp]), ("pp",))
    jrun = jpipe.PipelineRunner1F1B(
        _jstage, lambda y, t: jnp.mean((y - t) ** 2), pp)
    jloss, jgrads = jax.jit(shard_map(
        jrun, mesh=mesh, in_specs=(P("pp"), P(), P()),
        out_specs=(P(), P("pp")), check_vma=False))(
        {k: jnp.asarray(v) for k, v in stacked.items()},
        jnp.asarray(mbs), jnp.asarray(tgt))

    topo = HybridTopology(MeshConfig(pp=pp), device="cpu")
    run = tpipe.PipelineRunner1F1B(_tstage, _mse, pp)
    losses, grads = run(split_tree(_torch_tree(stacked), Spec("pp"), topo),
                        topo.split(torch.from_numpy(mbs), Spec()),
                        topo.split(torch.from_numpy(tgt), Spec()), topo)
    got = join_tree(grads, Spec("pp"), topo)
    _close(losses[0], jloss)
    assert all(float(x) == float(losses[0]) for x in losses)
    for k in ("w", "b"):
        _close(got[k], jgrads[k])
    assert run.stash_slots == 2 * pp < n_mb
    assert 0 < run.peak_stash <= run.stash_slots

    seq_params = [_torch_tree(p, grad=True) for p in per_stage]
    seq = _sequential(seq_params, torch.from_numpy(mbs))
    ref = sum(_mse(seq[m], torch.from_numpy(tgt[m]))
              for m in range(n_mb)) / n_mb
    ref.backward()
    _close(losses[0], ref.detach(), rtol=1e-5, atol=0)
    for i, p in enumerate(seq_params):
        for k in ("w", "b"):
            _close(got[k][i], p[k].grad, rtol=1e-4, atol=1e-5)


def test_hetero_1f1b_matches_jax_and_serial():
    """4 UNEQUAL stages (widths and bodies) under 1F1B: the loss and the
    full grad tuple equal the JAX package's and the serial autograd's;
    the stash stays within 2·pp inputs with M > 2·pp."""
    pp, n_mb, bm = 4, 10, 4
    widths = [4, 8, 6, 5, 2]
    rng = np.random.default_rng(0)
    params = tuple({"w": rng.normal(0, 0.5, (widths[i], widths[i + 1]))
                    .astype(np.float32),
                    "b": rng.normal(0, 0.1, (widths[i + 1],))
                    .astype(np.float32)} for i in range(pp))
    mbs = rng.normal(0, 1, (n_mb, bm, widths[0])).astype(np.float32)
    tgts = rng.normal(0, 1, (n_mb, bm, widths[-1])).astype(np.float32)
    io_shapes = [(bm, w) for w in widths]

    def jfn(i):
        def fn(p, x):
            y = x @ p["w"] + p["b"]
            return jnp.tanh(y) if i % 2 == 0 else jax.nn.relu(y)
        return fn

    def tfn(i):
        def fn(p, x):
            y = x @ p["w"] + p["b"]
            return torch.tanh(y) if i % 2 == 0 else torch.relu(y)
        return fn

    jrun = jpipe.HeteroPipeline1F1B([jfn(i) for i in range(pp)], io_shapes,
                                    lambda y, t: jnp.sum((y - t) ** 2))
    mesh = Mesh(np.array(jax.devices()[:pp]), ("pp",))
    jparams = tuple({k: jnp.asarray(v) for k, v in p.items()}
                    for p in params)
    jloss, jgrads = jax.jit(shard_map(
        jrun, mesh=mesh, in_specs=(P(), P(), P()), out_specs=(P(), P()),
        check_vma=False))(jparams, jnp.asarray(mbs), jnp.asarray(tgts))

    topo = HybridTopology(MeshConfig(pp=pp), device="cpu")
    run = tpipe.HeteroPipeline1F1B([tfn(i) for i in range(pp)], io_shapes,
                                   lambda y, t: ((y - t) ** 2).sum())
    tparams = tuple(_torch_tree(p) for p in params)
    losses, grads = run(tparams, topo.split(torch.from_numpy(mbs), Spec()),
                        topo.split(torch.from_numpy(tgts), Spec()), topo)
    _close(losses[0], jloss)
    for i in range(pp):
        for k in ("w", "b"):
            _close(grads[0][i][k], jgrads[i][k])
    assert run.stash_slots == 2 * pp < n_mb
    assert 0 < run.peak_stash <= run.stash_slots

    serial = tuple(_torch_tree(p, grad=True) for p in params)
    tot = 0.0
    for m in range(n_mb):
        x = torch.from_numpy(mbs[m])
        for i in range(pp):
            x = tfn(i)(serial[i], x)
        tot = tot + ((x - torch.from_numpy(tgts[m])) ** 2).sum()
    (tot / n_mb).backward()
    _close(losses[0], (tot / n_mb).detach(), rtol=1e-5, atol=0)
    for i in range(pp):
        for k in ("w", "b"):
            _close(grads[0][i][k], serial[i][k].grad, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="io_shapes"):
        tpipe.HeteroPipeline1F1B([tfn(0)], io_shapes, lambda y, t: y.sum())


def test_segment_layers_and_stack():
    for n in [(10, 4), (8, 4), (3, 4), (7, 3)]:
        assert tpipe.segment_layers(*n) == jpipe.segment_layers(*n)
    assert tpipe.segment_layers(10, 4) == [3, 3, 2, 2]
    per_stage = _stage_params(0)
    want = jpipe.stack_stage_params([{k: jnp.asarray(v) for k, v in
                                      p.items()} for p in per_stage])
    got = tpipe.stack_stage_params([_torch_tree(p) for p in per_stage])
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    topo = HybridTopology(MeshConfig(pp=2), device="cpu")
    with pytest.raises(ValueError, match="stages"):
        tpipe.PipelineRunner(_tstage, PP)(
            split_tree(got, Spec("pp"), topo)[:2],
            [torch.zeros(1, 2, D)] * 2, topo)
