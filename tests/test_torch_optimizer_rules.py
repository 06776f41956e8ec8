"""The port's sparse optimizer rules against the JAX package's.

Each rule of ``OPTIMIZERS`` (adagrad, shared_adam, adam, std_adagrad,
naive) runs ``apply_push`` on one seeded random state and merged push:
rows touched and untouched, rows whose mf is created by this push (their
beta powers restart), and, with ``slot_mf_dims``, per-row dynamic dims.
Then one small DeepFM pass per rule on the port's packed mxu and ragged
lowerings against the JAX package's reference pass (the exact step;
every slot draws its own keys, so the lowerings' per-row slot agrees).

Tolerance rtol 1e-5 / atol 1e-6: the same f32 updates; in the passes the
merged pushes are summed in another order.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu.ps import optimizer as jopt
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import optimizer as topt

import torch_parity_helpers as h

TOL = dict(rtol=1e-5, atol=1e-6)
RULES = ("adagrad", "shared_adam", "adam", "std_adagrad", "naive")
N, D = 200, 4
DYM = ((100, 2), (102, 3))


def _state(rule, seed=0):
    """(host rows, accumulators) of one random push; row 0 reserved."""
    rng = np.random.default_rng(seed)
    host = jfv.default_rows(N - 1, D, rng, 1e-2, optimizer=rule)
    host["show"][:] = rng.integers(0, 20, N - 1)
    host["click"][:] = np.minimum(host["show"], rng.integers(0, 4, N - 1))
    host["mf_size"][:] = np.where(rng.random(N - 1) < 0.5, D, 0)
    host["slot"][:] = rng.integers(100, 104, N - 1)
    for f, v in host.items():
        if "g2sum" in f or "gsum" in f:
            v[...] = rng.random(v.shape) * (0.5 if "g2" in f else 0.1)
        elif f.endswith(("b1p", "b2p")):
            v[...] = rng.uniform(0.3, 0.99, v.shape)
    g_show = np.where(rng.random(N) < 0.6, rng.integers(1, 6, N), 0)
    g_show[0] = 3                          # the reserved row never updates
    acc = {"g_show": g_show.astype(np.float32),
           "g_click": np.minimum(g_show, rng.integers(0, 3, N))
           .astype(np.float32),
           "g_embed": rng.normal(0, 1, N).astype(np.float32),
           "g_embedx": rng.normal(0, 1, (N, D)).astype(np.float32),
           "slot": rng.integers(100, 104, N).astype(np.int32)}
    return host, acc


@pytest.mark.parametrize("dym", [False, True], ids=["fixed", "slot_mf_dims"])
@pytest.mark.parametrize("rule", RULES)
def test_rule_matches_jax(rule, dym):
    host, acc = _state(rule)
    kw = dict(optimizer=rule, mf_create_thresholds=2.0,
              slot_mf_dims=DYM if dym else ())
    jws = jemb.build_working_set(host, D, pad_to=N)
    tws = temb.build_working_set(host, torch.device("cpu"), pad_to=N)
    before = {f: v.clone() for f, v in tws.items()}
    want = jopt.apply_push(jws, {k: jnp.asarray(v) for k, v in acc.items()},
                           JSgd(**kw))
    got = topt.apply_push(tws, {k: torch.as_tensor(v)
                                for k, v in acc.items()}, TSgd(**kw))
    assert got is tws                      # updated in place
    created = (host["mf_size"] == 0) & (np.asarray(want["mf_size"])[1:] > 0)
    assert created.any()                   # the case covers creation
    for f in tws:
        w = np.asarray(want[f]) if f in want else before[f].numpy()
        if w.dtype == np.int32:
            np.testing.assert_array_equal(got[f].numpy(), w, err_msg=f)
        else:
            np.testing.assert_allclose(got[f].numpy(), w, err_msg=f, **TOL)


@functools.lru_cache(maxsize=None)
def _jax_reference_pass(rule):
    """(per-batch losses, working set, dense params) of the JAX
    package's reference pass under ``rule``."""
    cfg, data = h.datasets(h.JAX, disjoint=True)
    eng = h.engine(h.JAX, data, optimizer=rule)
    tr = h.JAX.Trainer(eng, JDeepFM(h.S, 3 + h.MF, h.DENSE, hidden=(16, 16)),
                       cfg, batch_size=h.B, seed=3, sparse_path="reference")
    params0 = jax.tree.map(np.asarray, tr.params)
    losses = [s["loss"] for s in h.train_batches(tr, data)]
    return params0, losses, h.ws_numpy(eng), jax.tree.map(np.asarray,
                                                          tr.params)


@pytest.mark.parametrize("path", ["mxu", "ragged"])
@pytest.mark.parametrize("rule", RULES)
def test_rule_pass_matches_jax(rule, path):
    params0, losses, ws, params = _jax_reference_pass(rule)
    cfg, data = h.datasets(h.TORCH, disjoint=True)
    eng = h.engine(h.TORCH, data, optimizer=rule)
    tr = h.TORCH.Trainer(eng, TDeepFM(h.S, 3 + h.MF, h.DENSE,
                                      hidden=(16, 16)),
                         cfg, batch_size=h.B, seed=3, sparse_path=path,
                         device="cpu")
    tr.model.load_jax_params(params0)
    got = [s["loss"] for s in h.train_batches(tr, data, packed=True)]
    np.testing.assert_allclose(got, losses, **TOL)
    h.assert_ws_close(h.ws_numpy(eng), ws, **TOL)
    h.assert_tree_close(tr.model.jax_params(), params, **TOL)


def test_fast_path_still_rejects_other_rules():
    cfg, data = h.datasets(h.TORCH)
    eng = h.engine(h.TORCH, data, optimizer="adam")
    tr = h.TORCH.Trainer(eng, TDeepFM(h.S, 3 + h.MF, h.DENSE,
                                      hidden=(16, 16)),
                         cfg, batch_size=h.B, sparse_path="fast",
                         device="cpu")
    with pytest.raises(ValueError, match="adagrad rule only"):
        tr.train_pass(data[0])
    assert set(topt.OPTIMIZERS) == set(RULES)
