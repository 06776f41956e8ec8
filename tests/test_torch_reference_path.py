"""The port's reference lowering against the JAX package's.

``embedding.pull_sparse`` / ``push_sparse_grads`` on one seeded working
set and batch; then a whole small DeepFM pass (4 slots, mf_dim 4,
hidden (16, 16), batch 64, 3 batches) on the ``reference`` lowering in
both packages, on the streaming and the pass-resident entry points, with
and without the CVM columns and per-slot mf dims.  The port starts from
the JAX dense init (``load_jax_params``); host rows come from the same
seeded defaults.

Tolerance rtol 1e-5 / atol 1e-6: the same f32 step, with the merged
push summed in another order (XLA's scatter-add against the port's
sorted segmented sum) and the MLP in another order of adds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ps import embedding as temb

import torch_parity_helpers as h

TOL = dict(rtol=1e-5, atol=1e-6)
N, D, S, L, B = 300, 4, 5, 3, 16


def _ws(seed=0):
    rng = np.random.default_rng(seed)
    host = jfv.default_rows(N - 1, D, rng, 1e-2)
    host["show"][:] = rng.integers(1, 50, N - 1).astype(np.float32)
    host["mf_size"][:] = np.where(rng.random(N - 1) < 0.7, D, 0)
    j = jemb.build_working_set(host, D, pad_to=N)
    t = temb.build_working_set(host, torch.device("cpu"), pad_to=N)
    return j, t


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (S, B, L)).astype(np.int32)
    idx[:, :4, 0] = 7                      # a row shared by every slot
    grads = rng.normal(0, 1, (S, B, L, 3 + D)).astype(np.float32)
    live = rng.random((S, B, L)) < 0.8
    grads[..., 0] = live                   # the seqpool key mask
    grads[..., 1] = live * rng.integers(0, 2, (S, B, L))
    grads[~live] = 0.0
    return idx, grads


def test_pull_sparse_matches_jax():
    jws, tws = _ws()
    idx, _ = _batch()
    want = np.asarray(jemb.pull_sparse(jws, jnp.asarray(idx)))
    got = temb.pull_sparse(tws, torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_push_sparse_grads_matches_jax():
    jws, tws = _ws()
    idx, grads = _batch()
    slot_ids = (100 + np.arange(S)).astype(np.int32)
    want = jemb.push_sparse_grads(jws, jnp.asarray(idx), jnp.asarray(grads),
                                  jnp.asarray(slot_ids))
    got = temb.push_sparse_grads(tws, torch.as_tensor(idx),
                                 torch.as_tensor(grads),
                                 torch.as_tensor(slot_ids))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(got["slot"].numpy(),
                                  np.asarray(want["slot"]))


def _trainers(data_j, data_t, path="reference", use_cvm=True, sgd_kw=None,
              fast_path=True):
    sgd_kw = sgd_kw or {}
    jcfg, jdata = data_j
    tcfg, tdata = data_t
    jeng = h.engine(h.JAX, jdata, **sgd_kw)
    teng = h.engine(h.TORCH, tdata, **sgd_kw)
    width = 3 + h.MF if use_cvm else 1 + h.MF
    jtr = h.JAX.Trainer(jeng, JDeepFM(h.S, width, h.DENSE, hidden=(16, 16)),
                        jcfg, batch_size=h.B, seed=3, use_cvm=use_cvm,
                        sparse_path=path, fast_path=fast_path)
    ttr = h.TORCH.Trainer(teng, TDeepFM(h.S, width, h.DENSE,
                                        hidden=(16, 16)),
                          tcfg, batch_size=h.B, seed=3, use_cvm=use_cvm,
                          sparse_path=path, fast_path=fast_path,
                          device="cpu")
    ttr.model.load_jax_params(jax.tree.map(np.asarray, jtr.params))
    return jeng, jtr, teng, ttr


CONFIGS = {
    "cvm": dict(use_cvm=True),
    "no_cvm_dym": dict(use_cvm=False,
                       sgd_kw=dict(slot_mf_dims=((100, 2), (102, 3)))),
}


@pytest.mark.parametrize("packed", [False, True], ids=["stream", "packed"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_reference_pass_matches_jax(config, packed):
    jeng, jtr, teng, ttr = _trainers(h.datasets(h.JAX), h.datasets(h.TORCH),
                                     **CONFIGS[config])
    assert jtr._resolve_path() == ttr._resolve_path() == "reference"
    _, jdata = h.datasets(h.JAX)
    _, tdata = h.datasets(h.TORCH)
    js = h.train_batches(jtr, jdata, packed)
    ts = h.train_batches(ttr, tdata, packed)
    np.testing.assert_allclose([s["loss"] for s in ts],
                               [s["loss"] for s in js], **TOL)
    np.testing.assert_allclose(ts[-1]["auc"], js[-1]["auc"], **TOL)
    h.assert_ws_close(h.ws_numpy(teng), h.ws_numpy(jeng), **TOL)
    h.assert_tree_close(ttr.model.jax_params(),
                        jax.tree.map(np.asarray, jtr.params), **TOL)


def test_reference_equals_the_ports_mxu():
    """The same step on two lowerings of the port: f32 sums in another
    order.  The one field apart is ``slot`` of a key pushed under several
    slots: mxu keeps its first occurrence's slot, reference the largest
    (as in the JAX package); no rule here reads it."""
    _, tdata = h.datasets(h.TORCH)
    out = {}
    for path in ("reference", "mxu"):
        cfg, data = h.datasets(h.TORCH)
        eng = h.engine(h.TORCH, data)
        tr = h.TORCH.Trainer(eng, TDeepFM(h.S, 3 + h.MF, h.DENSE,
                                          hidden=(16, 16)),
                             cfg, batch_size=h.B, seed=3, sparse_path=path,
                             device="cpu")
        stats = h.train_batches(tr, data)
        out[path] = ([s["loss"] for s in stats], h.ws_numpy(eng))
    np.testing.assert_allclose(out["mxu"][0], out["reference"][0], **TOL)
    for ws in (out["mxu"][1], out["reference"][1]):
        del ws["slot"]
    h.assert_ws_close(out["mxu"][1], out["reference"][1], **TOL)


def test_fast_path_false_resolves_to_reference():
    jeng, jtr, teng, ttr = _trainers(h.datasets(h.JAX), h.datasets(h.TORCH),
                                     path="auto", fast_path=False)
    assert jtr._resolve_path() == ttr._resolve_path() == "reference"
    cfg, data = h.datasets(h.TORCH)
    tr = h.TORCH.Trainer(teng, TDeepFM(h.S, 3 + h.MF, h.DENSE,
                                       hidden=(16, 16)),
                         cfg, batch_size=h.B, device="cpu")
    assert tr._resolve_path() == "mxu"
