"""AMP (``amp=True``) in the port against the JAX package's.

Both packages run the whole model in bfloat16 over f32 master weights:
every parameter and input cast to bf16, the logits cast back to f32, the
loss, sigmoid and dense Adam in f32.  The same small DeepFM (4 slots,
mf_dim 4, hidden (16, 16), batch 64) and data go through both:

* the first step's loss on the mxu and reference lowerings, rtol 1e-2;
* the grad of the pooled features from the dense half (mxu), and from
  the reference step's seqpool backward, within 5e-2 of its largest
  magnitude.

bf16 keeps 8 mantissa bits, and XLA's CPU dot and torch's CPU matmul
may round their bf16 products and partial sums at other points, hence
the loose tolerances.  Measured on the CPU at these inputs: first-step
loss 2.6e-7 relative on mxu and reference; pooled grads and seqpool
grads 0.0 of their max-abs (bit-equal).  Against its own f32 first
step, amp moves the loss by 3.3e-4 relative on the fast and ragged
lowerings (held within 1e-2 there).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.ops.seqpool_cvm import fused_seqpool_cvm as jax_seqpool
from paddlebox_tpu.ps import embedding as jemb
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ps import embedding as temb

import torch_parity_helpers as h

LOSS_RTOL, GRAD_FRAC = 1e-2, 5e-2


def _pair(path, amp=True):
    out = {}
    for name, pkg, model in (("jax", h.JAX, JDeepFM), ("torch", h.TORCH,
                                                        TDeepFM)):
        cfg, data = h.datasets(pkg)
        eng = h.engine(pkg, data)
        tr = pkg.Trainer(eng, model(h.S, 3 + h.MF, h.DENSE, hidden=(16, 16)),
                         cfg, batch_size=h.B, seed=3, sparse_path=path,
                         amp=amp, **pkg.kw)
        out[name] = (eng, tr, data)
    out["torch"][1].model.load_jax_params(
        jax.tree.map(np.asarray, out["jax"][1].params))
    return out


def _gap(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("path", ["mxu", "reference"])
def test_amp_first_step_loss_matches_jax(path):
    p = _pair(path)
    j = p["jax"][1].train_pass(p["jax"][2][0])["loss"]
    t = p["torch"][1].train_pass(p["torch"][2][0])["loss"]
    assert abs(t - j) <= LOSS_RTOL * abs(j), (t, j)


def _batch(p):
    """The first batch, packed once (both packers give the same arrays),
    as device tensors of the port and the same arrays for JAX."""
    eng, tr, data = p["torch"]
    pb = tr.packer.pack(data[0].get_blocks()[0], key_mapper=eng.mapper)
    return pb, tuple(torch.as_tensor(a) for a in (
        pb.indices, pb.lengths, pb.dense, pb.labels, pb.valid))


@pytest.mark.parametrize("path", ["mxu", "reference"])
def test_amp_pooled_grads_match_jax(path, monkeypatch):
    p = _pair(path)
    jeng, jtr, _ = p["jax"]
    teng, ttr, _ = p["torch"]
    pb, (idx, lengths, dense, labels, valid) = _batch(p)
    # the JAX grad of the pooled features: its dense half on the pooled
    # output of the reference pull + fused_seqpool_cvm
    ins_cvm = jnp.stack([jnp.ones_like(pb.labels), pb.labels], axis=1)
    emb = jemb.pull_sparse(jeng.ws, jnp.asarray(pb.indices))
    pooled = jax_seqpool(emb, jnp.asarray(pb.lengths), ins_cvm, True)
    pooled = pooled.reshape(h.B, h.S, 3 + h.MF)
    want = np.asarray(jtr._pooled_dense_half()(
        jtr.params, jtr.opt_state, jtr.auc_state, pooled,
        jnp.asarray(pb.dense), jnp.asarray(pb.labels),
        jnp.asarray(pb.valid))[5])                           # [B, S, E]
    if path == "mxu":
        got = ttr._pooled_dense_half(torch.tensor(np.asarray(pooled)),
                                     dense, labels, valid)[2].numpy()
        assert _gap(got, want) <= GRAD_FRAC
        return
    seen = {}
    push = temb.push_sparse_grads

    def capture(ws, indices, grads, slot_ids):
        seen["d_emb"] = grads.clone()
        return push(ws, indices, grads, slot_ids)

    monkeypatch.setattr(temb, "push_sparse_grads", capture)
    ttr._core("reference", idx.permute(0, 2, 1), lengths, dense, labels,
              valid)
    d_emb = seen["d_emb"].numpy()                            # [S, B, L, E]
    keep = (np.arange(h.CAP)[None, None, :]
            < pb.lengths[..., None])[..., None]
    want_emb = want.transpose(1, 0, 2)[:, :, None, :] * keep
    # columns 0-1 carry the instance cvm, exactly
    np.testing.assert_array_equal(
        d_emb[..., :2], np.broadcast_to(np.stack(
            [np.ones(h.B), pb.labels], 1)[None, :, None], d_emb[..., :2]
            .shape) * keep)
    assert _gap(d_emb[..., 2:], want_emb[..., 2:]) <= GRAD_FRAC


@pytest.mark.parametrize("path", ["fast", "ragged"])
def test_amp_stays_near_f32_on_the_other_lowerings(path):
    first = {}
    for amp in (False, True):
        cfg, data = h.datasets(h.TORCH)
        eng = h.engine(h.TORCH, data)
        tr = h.TORCH.Trainer(eng, TDeepFM(h.S, 3 + h.MF, h.DENSE,
                                          hidden=(16, 16)),
                             cfg, batch_size=h.B, seed=3, sparse_path=path,
                             amp=amp, device="cpu")
        first[amp] = tr.train_pass(tr.build_pass_feed(data[0]))["losses"][0]
    assert abs(first[True] - first[False]) <= LOSS_RTOL * abs(first[False])
    assert first[True] != first[False]          # bf16 really ran


def test_amp_keeps_f32_master_weights():
    p = _pair("mxu")
    ttr, data = p["torch"][1], p["torch"][2]
    w0 = ttr.model.jax_params()["mlp"][0]["w"]
    ttr.train_pass(data[0])
    assert all(q.dtype == torch.float32 for q in ttr.model.parameters())
    assert not np.array_equal(ttr.model.jax_params()["mlp"][0]["w"], w0)
