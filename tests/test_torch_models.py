"""The port's CtrDnn, WideDeep and MMoE against the JAX package's.

* The forward of each model (``apply`` / ``apply_multi``) on seeded
  inputs, with the JAX init carried across by ``load_jax_params``;
  ``jax_params`` gives it back as a snapshot.
* One small pass per model (4 slots, mf_dim 4, batch 64, 3 batches) on
  the reference lowering in both packages.
* ``MultiTaskSparseTrainer`` with MMoE over two label slots: per-batch
  losses, per-task AUCs, working set and dense params against the JAX
  package's multi-task trainer; the port's packed entry point against
  its streaming one.

Tolerance rtol 1e-5 / atol 1e-6: the same f32 arithmetic in another
order of adds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.models.ctr_dnn import CtrDnn as JCtrDnn
from paddlebox_tpu.models.mmoe import MMoE as JMMoE
from paddlebox_tpu.models.widedeep import WideDeep as JWideDeep
from paddlebox_tpu.trainer.multitask import (
    MultiTaskSparseTrainer as JMultiTask)
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn as TCtrDnn
from paddlebox_tpu_torch.models.mmoe import MMoE as TMMoE
from paddlebox_tpu_torch.models.widedeep import WideDeep as TWideDeep
from paddlebox_tpu_torch.trainer.multitask import (
    MultiTaskSparseTrainer as TMultiTask)

import torch_parity_helpers as h

TOL = dict(rtol=1e-5, atol=1e-6)
E = 3 + h.MF

MODELS = {
    "ctr_dnn": (JCtrDnn, TCtrDnn, dict(hidden=(16, 8, 8))),
    "widedeep": (JWideDeep, TWideDeep, dict(hidden=(16, 8))),
    "mmoe": (JMMoE, TMMoE, dict(num_experts=3, num_tasks=2,
                                expert_hidden=(16, 8), tower_hidden=(8,))),
}


def _models(name, seed=0):
    jcls, tcls, kw = MODELS[name]
    jm, tm = jcls(h.S, E, h.DENSE, **kw), tcls(h.S, E, h.DENSE, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm.load_jax_params(params)
    return jm, tm, params


def _inputs(seed=1, b=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h.S * E)).astype(np.float32),
            rng.normal(0, 1, (b, h.DENSE)).astype(np.float32))


@pytest.mark.parametrize("name,method", [
    ("ctr_dnn", "apply"), ("widedeep", "apply"), ("mmoe", "apply"),
    ("mmoe", "apply_multi")])
def test_forward_matches_jax(name, method):
    jm, tm, params = _models(name)
    pooled, dense = _inputs()
    want = np.asarray(getattr(jm, method)(params, jnp.asarray(pooled),
                                          jnp.asarray(dense)))
    fwd = tm.forward if method == "apply" else tm.forward_multi
    with torch.no_grad():
        got = fwd(torch.as_tensor(pooled), torch.as_tensor(dense)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_params_round_trip_is_a_snapshot(name):
    _, tm, params = _models(name)
    got = tm.jax_params()
    h.assert_tree_close(got, params, rtol=0, atol=0)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    h.assert_tree_close(got, params, rtol=0, atol=0)
    # reset_parameters draws from the generator alone
    a, b = (MODELS[name][1](h.S, E, h.DENSE, **MODELS[name][2])
            for _ in range(2))
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    h.assert_tree_close(a.jax_params(), b.jax_params(), rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_pass_matches_jax(name):
    jcls, tcls, kw = MODELS[name]
    out = {}
    for key, pkg, cls in (("jax", h.JAX, jcls), ("torch", h.TORCH, tcls)):
        cfg, data = h.datasets(pkg)
        eng = h.engine(pkg, data)
        tr = pkg.Trainer(eng, cls(h.S, E, h.DENSE, **kw), cfg,
                         batch_size=h.B, seed=3, sparse_path="reference",
                         **pkg.kw)
        if key == "torch":
            tr.model.load_jax_params(params0)
        else:
            params0 = jax.tree.map(np.asarray, tr.params)
        stats = h.train_batches(tr, data)
        params = (tr.model.jax_params() if key == "torch"
                  else jax.tree.map(np.asarray, tr.params))
        out[key] = ([s["loss"] for s in stats], stats[-1]["auc"],
                    h.ws_numpy(eng), params)
    for got, want in zip(out["torch"], out["jax"]):
        if isinstance(want, dict) and "show" in want:
            h.assert_ws_close(got, want, **TOL)
        else:
            h.assert_tree_close(got, want, **TOL)


def _multitask(pkg, cls):
    cfg, data = h.datasets(pkg, n_labels=2)
    eng = h.engine(pkg, data)
    tr = cls(eng, MODELS["mmoe"][0 if pkg is h.JAX else 1](
        h.S, E, h.DENSE, **MODELS["mmoe"][2]), cfg, batch_size=h.B,
        label_slots=h.label_names(2), seed=3, **pkg.kw)
    return eng, tr, data


@pytest.mark.parametrize("packed", [False, True], ids=["stream", "packed"])
def test_multitask_trainer_matches_jax(packed):
    """The port on either entry point against the JAX package's streaming
    multi-task step (its packed step is the single-task one)."""
    jeng, jtr, jdata = _multitask(h.JAX, JMultiTask)
    teng, ttr, tdata = _multitask(h.TORCH, TMultiTask)
    assert ttr._resolve_path() == "reference"
    ttr.model.load_jax_params(jax.tree.map(np.asarray, jtr.params))
    js = h.train_batches(jtr, jdata)
    ts = h.train_batches(ttr, tdata, packed)
    np.testing.assert_allclose([s["loss"] for s in ts],
                               [s["loss"] for s in js], **TOL)
    for t in range(2):
        np.testing.assert_allclose(ts[-1][f"task{t}_auc"],
                                   js[-1][f"task{t}_auc"], **TOL)
    for got, want in zip(ttr.task_metrics(), jtr.task_metrics()):
        for k in ("auc", "mae", "actual_ctr", "predicted_ctr"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    h.assert_ws_close(h.ws_numpy(teng), h.ws_numpy(jeng), **TOL)
    h.assert_tree_close(ttr.model.jax_params(),
                        jax.tree.map(np.asarray, jtr.params), **TOL)


def test_multitask_trainer_refuses_what_it_does_not_run():
    cfg, data = h.datasets(h.TORCH, n_labels=2)
    eng = h.engine(h.TORCH, data)
    model = TMMoE(h.S, E, h.DENSE, **MODELS["mmoe"][2])
    for kw in (dict(amp=True), dict(sparse_path="mxu")):
        with pytest.raises(ValueError, match="MultiTaskSparseTrainer"):
            TMultiTask(eng, model, cfg, batch_size=h.B,
                       label_slots=h.label_names(2), device="cpu", **kw)
