"""The port's ``cvm`` and ``fused_seqpool_cvm`` against the JAX package's.

The same numpy-seeded inputs (show/click counts, embedx values, lengths
0..L, one instance cvm per record) go through both packages; the
backward of the port's autograd Functions is held against ``jax.vjp`` of
the JAX custom-vjp ops for one seeded output grad.  Every attribute is
covered: use_cvm off, pad_value, quant, filter and embed_threshold.

Tolerance rtol 1e-6 / atol 1e-6: the same f32 arithmetic, sums over at
most L = 4 keys.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.ops.cvm import cvm as jax_cvm
from paddlebox_tpu.ops import seqpool_cvm as jsp
from paddlebox_tpu_torch.ops.cvm import cvm as torch_cvm
from paddlebox_tpu_torch.ops import seqpool_cvm as tsp

S, B, L, D = 3, 6, 4, 4
E = 3 + D
TOL = dict(rtol=1e-6, atol=1e-6)

ATTRS = {
    "default": {},
    "no_cvm": dict(use_cvm=False),
    "pad_value": dict(pad_value=0.25),
    "quant": dict(quant_ratio=64),
    "filter": dict(need_filter=True, show_coeff=0.2, clk_coeff=1.0,
                   threshold=0.96),
    "embed_threshold": dict(need_filter=True, threshold=0.5,
                            embed_threshold=0.3, embed_thres_size=3),
    "all_no_cvm": dict(use_cvm=False, quant_ratio=32, need_filter=True,
                       threshold=0.5, embed_threshold=0.2,
                       embed_thres_size=D),
}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 0.5, (S, B, L, E)).astype(np.float32)
    emb[..., 0] = rng.integers(0, 8, (S, B, L))           # show counts
    emb[..., 1] = np.minimum(emb[..., 0], rng.integers(0, 3, (S, B, L)))
    lengths = rng.integers(0, L + 1, (S, B)).astype(np.int32)
    lengths[0, 0], lengths[-1, -1] = 0, L
    ins_cvm = np.stack([np.ones(B), rng.integers(0, 2, B)],
                       axis=1).astype(np.float32)
    return emb, lengths, ins_cvm


def _seqpool_both(attrs, seed=0):
    emb, lengths, ins_cvm = _inputs(seed)
    use_cvm = attrs.get("use_cvm", True)
    kw = {k: v for k, v in attrs.items() if k != "use_cvm"}
    width = E if use_cvm else E - 2
    dy = np.random.default_rng(seed + 1).normal(
        0, 1, (B, S * width)).astype(np.float32)

    def jf(e):
        return jsp.fused_seqpool_cvm(e, jnp.asarray(lengths),
                                     jnp.asarray(ins_cvm), use_cvm, **kw)

    j_out, vjp = jax.vjp(jf, jnp.asarray(emb))
    (j_demb,) = vjp(jnp.asarray(dy))
    t_emb = torch.tensor(emb, requires_grad=True)
    t_out = tsp.fused_seqpool_cvm(t_emb, torch.as_tensor(lengths),
                                  torch.as_tensor(ins_cvm), use_cvm, **kw)
    t_out.backward(torch.as_tensor(dy))
    return (np.asarray(j_out), np.asarray(j_demb),
            t_out.detach().numpy(), t_emb.grad.numpy())


@pytest.mark.parametrize("name", sorted(ATTRS))
def test_fused_seqpool_cvm_forward_matches_jax(name):
    j_out, _, t_out, _ = _seqpool_both(ATTRS[name])
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out, j_out, **TOL)


@pytest.mark.parametrize("name", sorted(ATTRS))
def test_fused_seqpool_cvm_backward_matches_jax_vjp(name):
    """The reference backward: ins_cvm in columns 0-1, the pooled grads
    broadcast over the kept keys, exact zeros elsewhere."""
    _, j_d, _, t_d = _seqpool_both(ATTRS[name])
    np.testing.assert_allclose(t_d, j_d, **TOL)


def test_filters_drop_keys():
    """The filter attributes change the pooled values at these inputs (a
    guard that the parametrised cases exercise them)."""
    base = _seqpool_both(ATTRS["default"])[2]
    for name in ("filter", "embed_threshold", "quant"):
        assert not np.allclose(_seqpool_both(ATTRS[name])[2], base), name


@pytest.mark.parametrize("use_cvm", [True, False])
def test_cvm_forward_and_backward_match_jax(use_cvm):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, E)).astype(np.float32)
    x[:, :2] = np.abs(x[:, :2]) * 5
    ins = np.stack([np.ones(B), rng.integers(0, 2, B)],
                   axis=1).astype(np.float32)
    dy = rng.normal(0, 1, (B, E if use_cvm else E - 2)).astype(np.float32)
    j_out, vjp = jax.vjp(lambda a: jax_cvm(a, jnp.asarray(ins), use_cvm),
                         jnp.asarray(x))
    (j_dx,) = vjp(jnp.asarray(dy))
    tx = torch.tensor(x, requires_grad=True)
    t_out = torch_cvm(tx, torch.as_tensor(ins), use_cvm)
    t_out.backward(torch.as_tensor(dy))
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_dx), **TOL)
    # not the analytic derivative: columns 0-1 are the instance counts
    np.testing.assert_array_equal(tx.grad.numpy()[:, :2], ins)
