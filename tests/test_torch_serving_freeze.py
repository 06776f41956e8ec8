"""The port's serving freeze against the JAX package's.

``embedding.quantize_working_set`` must give the JAX package's int16
grid bit for bit, ``.5`` grid points included (both round half to even);
``BoxPSEngine.freeze_for_serving`` of two engines built from the same
keys, rows and seed must leave equal working sets; and every pull over
the frozen set — ``embedding.pull_sparse`` and the mxu, fast and ragged
``pull_pool_cvm`` — must match the JAX function over the JAX frozen set:

* ``pull_sparse``: bit-equal (a gather and one f32 multiply a value);
* mxu, fast, ragged: rtol 1e-5 / atol 1e-5, the tolerance of the f32
  parity tests of those paths (the JAX mxu kernels run in interpret mode
  and sum a hi/lo bf16 split; the poolings sum in another order);
* each pooled value within ``L * scale / 2 + 1e-6`` of the same pull over
  the f32 set (each of the at most L pooled rows is off by at most half
  a grid step).

``end_pass`` and the trainer refuse a frozen set in both packages, the
device row cache is invalidated at the freeze, and the working-set loops
that meet the 0-d ``mf_scale`` (the write-back dump, the cache's
scatter, the ragged row fields) skip it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.data import pass_feed as jpf
from paddlebox_tpu.ps import embedding as jemb
from paddlebox_tpu.ps import fast_path as jfast
from paddlebox_tpu.ps import mxu_path as jmxu
from paddlebox_tpu.ps import ragged_path as jrag
from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.data import pass_feed as tpf
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import fast_path as tfast
from paddlebox_tpu_torch.ps import mxu_path as tmxu
from paddlebox_tpu_torch.ps import ragged_path as trag

import torch_parity_helpers as h

MF, S, L, B = 4, 5, 3, 16
TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 1.0 / 32767.0


# -- quantize_working_set ----------------------------------------------------

def _mf_with_grid_points(scale, seed=0):
    """Random mf, plus exact (k + 0.5) grid points (half-to-even decides
    them), their negatives and values past the ±32767 clip."""
    rng = np.random.default_rng(seed)
    mf = rng.normal(0, 0.3, (2000, 8)).astype(np.float32)
    half = (np.arange(-400, 400, dtype=np.float32) + np.float32(0.5))
    mf[:100] = (half * np.float32(scale)).reshape(100, 8)
    mf[100, :] = [2.0, -2.0, 1e3, -1e3, 32767.5 * scale, -32767.5 * scale,
                  0.0, -0.0]
    return mf


@pytest.mark.parametrize("scale", [SCALE, 2.0 ** -10, 0.37])
def test_quantize_matches_jax_bit_for_bit(scale):
    mf = _mf_with_grid_points(scale)
    want = jemb.quantize_working_set({"mf": jnp.asarray(mf)}, 16, scale)
    got = temb.quantize_working_set({"mf": torch.as_tensor(mf)}, 16, scale)
    assert got["mf"].dtype == torch.int16
    np.testing.assert_array_equal(got["mf"].numpy(), np.asarray(want["mf"]))
    assert got["mf_scale"].dim() == 0
    assert got["mf_scale"].dtype == torch.float32
    assert got["mf_scale"].item() == float(want["mf_scale"])
    assert int(got["mf"].abs().max()) == 32767            # the clip


def test_grid_points_round_half_to_even():
    """At a power-of-two scale (k + 0.5) * scale / scale is exact, so
    the rounding alone decides: the even neighbour wins in both."""
    scale = 2.0 ** -10
    k = np.arange(-8, 8)
    mf = ((k + 0.5) * scale).astype(np.float32)[None, :]
    got = temb.quantize_working_set({"mf": torch.as_tensor(mf)}, 16, scale)
    even = np.where(k % 2 == 0, k, k + 1)
    np.testing.assert_array_equal(got["mf"].numpy()[0], even)
    want = jemb.quantize_working_set({"mf": jnp.asarray(mf)}, 16, scale)
    np.testing.assert_array_equal(np.asarray(want["mf"])[0], even)


def test_only_16_bits():
    mf = {"mf": torch.zeros(2, 2)}
    with pytest.raises(ValueError, match="quant_bits=16"):
        temb.quantize_working_set(mf, 8)
    with pytest.raises(ValueError, match="quant_bits=16"):
        jemb.quantize_working_set({"mf": jnp.zeros((2, 2))}, 8)


# -- engines frozen from the same keys ---------------------------------------

def _rows(table, keys, seed=1):
    rng = np.random.default_rng(seed)
    rows = table.bulk_pull(keys)
    n = len(keys)
    rows["show"] = rng.integers(1, 50, n).astype(rows["show"].dtype)
    rows["click"] = rng.integers(0, 5, n).astype(rows["click"].dtype)
    rows["mf_size"] = np.where(rng.random(n) < 0.7, MF, 0).astype(
        rows["mf_size"].dtype)
    rows["mf"] = rng.normal(0, 0.2, (n, MF)).astype(np.float32)
    return rows


def _frozen_engines():
    """A JAX and a port engine over the same 299 keys and rows, each
    through the pass lifecycle and frozen; → (jax engine, port engine,
    the port's f32 working set before the freeze)."""
    keys = np.arange(1, 300, dtype=np.uint64) * np.uint64(7919)
    engines = []
    for pkg in (h.JAX, h.TORCH):
        eng = pkg.Engine(pkg.Table(embedding_dim=MF, shard_num=4),
                         seed=7, **pkg.kw)
        eng.table.bulk_write(keys, _rows(eng.table, keys))
        eng.begin_feed_pass()
        eng.add_keys(keys)
        eng.end_feed_pass()
        eng.begin_pass()
        engines.append(eng)
    jeng, teng = engines
    f32 = dict(teng.ws)
    jeng.freeze_for_serving()
    teng.freeze_for_serving()
    return jeng, teng, f32


def test_frozen_working_sets_equal():
    jeng, teng, f32 = _frozen_engines()
    assert set(teng.ws) == set(jeng.ws)
    assert temb.is_quantized(teng.ws) and jemb.is_quantized(jeng.ws)
    for f in jeng.ws:
        np.testing.assert_array_equal(teng.ws[f].numpy(),
                                      np.asarray(jeng.ws[f]), err_msg=f)
    assert teng.ws["mf"].dtype == torch.int16
    for f in f32:                       # only mf changed
        if f != "mf":
            assert teng.ws[f] is f32[f], f


def _batch(n, seed=2):
    """idx [S, L, B] of rows 1..n, zero past each length, with empty and
    full lengths and a row shared by slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, n + 1, (S, L, B)).astype(np.int32)
    idx[:, 0, :4] = 7
    lengths = rng.integers(0, L + 1, (S, B)).astype(np.int32)
    lengths[:, 0], lengths[:, 1] = 0, L
    idx[np.arange(L)[None, :, None] >= lengths[:, None, :]] = 0
    return idx, lengths


def _assert_pooled(got, want, f32_got):
    np.testing.assert_allclose(got, want, **TOL)
    # the frozen pull stays within L half-steps of the f32 pull
    assert np.abs(got - f32_got).max() <= L * SCALE / 2 + 1e-6


def test_pull_sparse_over_the_frozen_set():
    jeng, teng, f32 = _frozen_engines()
    idx = _batch(teng.num_keys)[0]
    want = np.asarray(jemb.pull_sparse(jeng.ws, jnp.asarray(idx)))
    got = temb.pull_sparse(teng.ws, torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = temb.pull_sparse(f32, torch.as_tensor(idx)).numpy()
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    assert np.abs(got[..., 3:] - ref[..., 3:]).max() <= SCALE / 2 + 1e-9


@pytest.mark.parametrize("use_cvm", [True, False])
def test_mxu_pull_over_the_frozen_set(use_cvm):
    jeng, teng, f32 = _frozen_engines()
    idx = _batch(teng.num_keys)[0]
    n = teng.ws["show"].shape[0]
    jd, td = jmxu.make_dims(S * L * B, n), tmxu.make_dims(S * L * B, n)
    want = jmxu.pull_pool_cvm(jeng.ws, jmxu.build_plan(jnp.asarray(idx), jd),
                              jd, (S, L, B), use_cvm, interpret=True)
    plan = tmxu.build_plan(torch.as_tensor(idx), td)
    got = tmxu.pull_pool_cvm(teng.ws, plan, td, (S, L, B), use_cvm)
    ref = tmxu.pull_pool_cvm(f32, plan, td, (S, L, B), use_cvm)
    _assert_pooled(got.numpy(), np.asarray(want), ref.numpy())


@pytest.mark.parametrize("use_cvm", [True, False])
def test_fast_pull_over_the_frozen_set(use_cvm):
    jeng, teng, f32 = _frozen_engines()
    idx, lengths = _batch(teng.num_keys)
    want = jfast.pull_pool_cvm(jeng.ws, jnp.asarray(idx),
                               jnp.asarray(lengths), use_cvm)
    ti, tl = torch.as_tensor(idx), torch.as_tensor(lengths)
    got = tfast.pull_pool_cvm(teng.ws, ti, tl, use_cvm)
    ref = tfast.pull_pool_cvm(f32, ti, tl, use_cvm)
    _assert_pooled(got.numpy(), np.asarray(want), ref.numpy())


@pytest.mark.parametrize("use_cvm", [True, False])
def test_ragged_pull_over_the_frozen_set(use_cvm):
    jeng, teng, f32 = _frozen_engines()
    idx, _ = _batch(teng.num_keys)
    sbl = np.ascontiguousarray(idx.transpose(0, 2, 1))      # [S, B, L]
    slot_ids = 100 + np.arange(S)
    jp = jpf.build_csr_plans(sbl, slot_ids, 1, B)
    tp = tpf.build_csr_plans(sbl, slot_ids, 1, B)
    names = ("seg", "inv", "occ_w", "u_rows", "u_slot")
    jplan = tuple(jnp.asarray(jp[k][0]) for k in names)
    tplan = trag.CsrPlan(*(torch.as_tensor(tp[k][0]) for k in names))
    want = jrag.pull_pool_cvm(jeng.ws, jplan, (S, L, B), use_cvm)
    got = trag.pull_pool_cvm(teng.ws, tplan, (S, L, B), use_cvm)
    ref = trag.pull_pool_cvm(f32, tplan, (S, L, B), use_cvm)
    _assert_pooled(got.numpy(), np.asarray(want), ref.numpy())


# -- refusals, the cache, the 0-d scale --------------------------------------

def test_end_pass_and_trainer_refuse_a_frozen_set_in_both_packages():
    jeng, teng, _ = _frozen_engines()
    for eng in (jeng, teng):
        with pytest.raises(RuntimeError, match="serving-frozen"):
            eng.end_pass()
        assert eng.ws is not None           # nothing was written back
    cfg, _ = h.datasets(h.TORCH)
    tr = h.TORCH.Trainer(teng, TDeepFM(h.S, 3 + MF, h.DENSE, hidden=(8,)),
                         cfg, batch_size=h.B, device="cpu")
    with pytest.raises(ValueError, match="serving-frozen"):
        tr._resolve_path()
    from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
    jcfg, _ = h.datasets(h.JAX)
    jtr = h.JAX.Trainer(jeng, JDeepFM(h.S, 3 + MF, h.DENSE, hidden=(8,)),
                        jcfg, batch_size=h.B)
    with pytest.raises(ValueError, match="serving-frozen"):
        jtr._resolve_path()


def test_freeze_invalidates_the_device_cache():
    from paddlebox_tpu_torch.utils import flight
    before = len(flight.events(kind="cache_invalidate"))
    prev = {k: flags.get_flags(k)
            for k in ("ps_device_cache", "ps_device_cache_rows")}
    flags.set_flags({"ps_device_cache": True, "ps_device_cache_rows": 64})
    try:
        _, teng, _ = _frozen_engines()
    finally:
        flags.set_flags(prev)
    assert teng.cache is not None
    # the ring is process-wide and newest-first: earlier tests in this
    # process may have left invalidations of their own behind these
    reasons = [e.get("reason") for e in flight.events(
        kind="cache_invalidate")]
    assert len(reasons) > before and reasons[0] == "freeze"


def test_working_set_loops_skip_the_0d_scale():
    """The write-back dump, the cache's device scatter and the ragged
    row fields meet the 0-d ``mf_scale`` and skip it."""
    _, teng, _ = _frozen_engines()
    ws, n = teng.ws, teng.num_keys
    dumped = temb.dump_working_set(ws, n)
    assert "mf_scale" not in dumped and dumped["mf"].dtype == np.int16
    assert len(dumped["mf"]) == n
    assert "mf_scale" not in trag._row_fields(ws)
    before = ws["mf_scale"].clone()
    vals = {"show": torch.full((2,), 5.0),
            "mf": torch.ones((2, MF), dtype=torch.int16),
            "mf_scale": torch.tensor(9.0)}
    temb.scatter_device_rows(ws, np.array([3, 4]), {
        f: v for f, v in vals.items() if f != "mf_scale"})
    assert ws["show"][3].item() == 5.0 and ws["mf"][4].tolist() == [1] * MF
    assert ws["mf_scale"].item() == before.item()
