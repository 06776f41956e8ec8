"""The port's fused_seqpool_cvm variants against the JAX package's.

Each of the five ops (ops/seqpool_cvm_variants.py) takes the same numpy
inputs (emb [S, B, L, E], lengths with an empty sequence, ins_cvm,
q_values) in both packages, over the parameter grids of
tests/test_seqpool_variants.py.  Forward outputs, and the backward of a
seeded random cotangent (``jax.vjp`` through the JAX op's custom_vjp;
``torch.autograd.grad`` through the port's Function), must agree within
rtol 1e-6 / atol 1e-6: the same f32 expressions, summed over L in
possibly another order (L = 4 terms).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.ops import seqpool_cvm_variants as jv
from paddlebox_tpu_torch.ops import seqpool_cvm_variants as tv

S, B, L = 3, 5, 4
TOL = dict(rtol=1e-6, atol=1e-6)


def make(E, seed, low=0.0, high=2.0):
    rng = np.random.default_rng(seed)
    emb = rng.uniform(low, high, (S, B, L, E)).astype(np.float32)
    lengths = rng.integers(0, L + 1, (S, B)).astype(np.int32)
    lengths[0, 0] = 0  # an empty sequence
    return rng, emb, lengths


def both(jfn, tfn, emb, lengths, arrays, attrs, seed):
    """Forward and the vjp of one cotangent in both packages; compares
    them and returns the port's forward output."""
    jargs = [jnp.asarray(a) for a in arrays]
    want, vjp = jax.vjp(lambda e: jfn(e, jnp.asarray(lengths), *jargs,
                                      *attrs), jnp.asarray(emb))
    dy = np.random.default_rng(seed).normal(
        0, 1, np.asarray(want).shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(dy))

    e = torch.tensor(emb, requires_grad=True)
    got = tfn(e, torch.as_tensor(lengths),
              *[torch.as_tensor(a) for a in arrays], *attrs)
    (got_g,) = torch.autograd.grad(got, e, torch.as_tensor(dy))
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    return got


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("trade_id", [-1, 0, 1])
@pytest.mark.parametrize("cvm_offset", [2, 3])
def test_tradew_matches_jax(use_cvm, trade_id, cvm_offset):
    T, E = 3, 7
    rng, emb, lengths = make(E + T, 1)
    ins_cvm = rng.uniform(0, 3, (B, 2)).astype(np.float32)
    both(jv.fused_seqpool_cvm_tradew, tv.fused_seqpool_cvm_tradew, emb,
         lengths, [ins_cvm], (use_cvm, 0.0, cvm_offset, trade_id, T), 2)


@pytest.mark.parametrize("use_cvm,show_filter",
                         [(True, False), (True, True), (False, False)])
@pytest.mark.parametrize("need_filter", [False, True])
@pytest.mark.parametrize("concate", [1, 2, 6])
def test_with_conv_matches_jax(use_cvm, show_filter, need_filter, concate):
    E = 6
    rng, emb, lengths = make(E, 3)
    ins_cvm = rng.uniform(0, 2, (B, 3)).astype(np.float32)
    both(jv.fused_seqpool_cvm_with_conv, tv.fused_seqpool_cvm_with_conv,
         emb, lengths, [ins_cvm],
         (use_cvm, 0.5, need_filter, 0.2, 1.0, 0.96, show_filter, concate),
         4)


@pytest.mark.parametrize("use_cvm,show_filter",
                         [(True, False), (True, True), (False, False)])
@pytest.mark.parametrize("pad_value", [0.0, 0.25])
def test_with_credit_matches_jax(use_cvm, show_filter, pad_value):
    E = 7
    rng, emb, lengths = make(E, 5)
    ins_cvm = rng.uniform(0, 2, (B, 4)).astype(np.float32)
    both(jv.fused_seqpool_cvm_with_credit, tv.fused_seqpool_cvm_with_credit,
         emb, lengths, [ins_cvm], (use_cvm, pad_value, show_filter), 6)


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("clk_filter", [False, True])
@pytest.mark.parametrize("filt", ["none", "scalar", "per_slot"])
@pytest.mark.parametrize("quant_ratio", [0, 128])
def test_with_diff_thres_matches_jax(use_cvm, clk_filter, filt,
                                     quant_ratio):
    E = 5
    rng, emb, lengths = make(E, 7, low=-1.0)
    ins_cvm = rng.uniform(0, 2, (B, 2)).astype(np.float32)
    out = both(jv.fused_seqpool_cvm_with_diff_thres,
               tv.fused_seqpool_cvm_with_diff_thres, emb, lengths,
               [ins_cvm],
               (use_cvm, 0.0, filt != "none", 0.2, 1.0, 0.96,
                (0.5, 100.0, 0.0), quant_ratio, clk_filter,
                filt == "per_slot"), 8)
    if filt == "per_slot" and use_cvm and not clk_filter:
        # slot 1's threshold drops every key: its pooled outputs are 0
        np.testing.assert_allclose(
            out.detach().numpy().reshape(B, S, E)[:, 1], 0.0, atol=1e-6)


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("cvm_offset,max_cvm_offset", [(7, 7), (6, 6),
                                                       (6, 8)])
@pytest.mark.parametrize("need_filter,quant_ratio", [(False, 0), (True, 64)])
def test_with_pcoc_matches_jax(use_cvm, cvm_offset, max_cvm_offset,
                               need_filter, quant_ratio):
    pclk_num = cvm_offset - 4
    E = max_cvm_offset + 4
    rng, emb, lengths = make(E, 9)
    ins_cvm = rng.uniform(0, 2, (B, cvm_offset)).astype(np.float32)
    q = rng.uniform(0, 1, (B, pclk_num)).astype(np.float32)
    both(jv.fused_seqpool_cvm_with_pcoc, tv.fused_seqpool_cvm_with_pcoc,
         emb, lengths, [ins_cvm, q],
         (use_cvm, 0.0, need_filter, 0.2, 1.0, 0.96, cvm_offset,
          max_cvm_offset, quant_ratio), 10)


def test_grads_reach_emb_only():
    """The reference backward: ins_cvm and q_values get no grad, and the
    padding keys get exactly 0."""
    E = 9
    rng, emb, lengths = make(E, 11)
    ins = torch.tensor(rng.uniform(0, 2, (B, 6)).astype(np.float32),
                       requires_grad=True)
    q = torch.tensor(rng.uniform(0, 1, (B, 2)).astype(np.float32),
                     requires_grad=True)
    e = torch.tensor(emb, requires_grad=True)
    out = tv.fused_seqpool_cvm_with_pcoc(e, torch.as_tensor(lengths), ins, q,
                                         True, 0.0, False, 0.2, 1.0, 0.96,
                                         6, 6, 0)
    out.sum().backward()
    assert ins.grad is None and q.grad is None
    pad = np.arange(L)[None, None, :] >= lengths[:, :, None]
    assert np.all(e.grad.numpy()[pad] == 0.0)
