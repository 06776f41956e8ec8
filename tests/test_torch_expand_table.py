"""Expand ("NNCross", ``mf_ex``) tables in the PyTorch port against the
JAX package.

* ``mxu_path`` with an expand table (3 slots, capacity 2, D 4, Dex 3,
  batch 64, as tests/test_mxu_path.py's expand cases): the pull
  ([B, S, 3 + D + Dex]), and the merged push with the adagrad rule,
  untrimmed and trimmed plans, against the JAX package's under both of
  its crossings (its Pallas kernels in interpret mode).  The JAX kernels sum a hi/lo
  bf16 split of their f32 inputs (ps/mxu_path.py: ~1e-5 relative), so
  values are held within rtol 1e-5 / atol 1e-5, as in
  tests/test_torch_mxu_path.py; the port's pull is also held to an f32
  pooling of ``pull_sparse_extended`` within rtol 1e-6 / atol 1e-6;
* ``pull_sparse_extended`` / ``push_sparse_grads_extended`` (the JAX
  package's tests/test_ops_extended.py case): gathers exact, merged sums
  rtol 1e-6;
* each of the five sparse rules with ``g_embedx_ex`` in the push: adagrad
  trains ``mf_ex`` and the others carry it through untouched, every field
  within rtol 1e-6 / atol 1e-7 of the JAX package's;
* a 4-batch pass of ``SparseTrainer`` with ``CtrDnn(emb_width=3+D+Dex)``
  on streaming and packed mxu (auto), the port's weights loaded from the
  JAX model: losses within rtol 1e-5, and ``mf`` and ``mf_ex`` after the
  pass within rtol 1e-5 / atol 1e-6 of the JAX package's;
* the routing: ``auto`` → mxu; refused exactly where the JAX package
  refuses (auto and explicit mxu under per-slot dynamic dims, explicit
  ragged); explicit fast and reference train the base columns and leave
  ``mf_ex`` as it is, in both packages;
* device row cache on = off bit for bit with an expand table.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.models.ctr_dnn import CtrDnn as JCtrDnn
from paddlebox_tpu.ops import sorted_spmm as jsp
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu.ps import mxu_path as jmxu
from paddlebox_tpu.ps import optimizer as jopt
from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn as TCtrDnn
from paddlebox_tpu_torch.ops import sorted_spmm as tsp
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ps import mxu_path as tmxu
from paddlebox_tpu_torch.ps import optimizer as topt
from paddlebox_tpu_torch.utils.monitor import StatRegistry

import torch_parity_helpers as h
from torch_day_loop import assert_same_bits, cache_off, cache_on, run

N, D, DX, S, L, B = 200, 4, 3, 3, 2, 64
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
RULES = ("adagrad", "shared_adam", "adam", "std_adagrad", "naive")


def _host(seed=5, optimizer=""):
    rng = np.random.default_rng(seed)
    host = jfv.default_rows(N - 1, D, rng, 1e-2, expand_dim=DX,
                            optimizer=optimizer)
    host["show"][:] = rng.integers(1, 50, N - 1).astype(np.float32)
    host["click"][:] = rng.integers(0, 5, N - 1).astype(np.float32)
    host["mf_size"][:] = np.where(rng.random(N - 1) < 0.7, D, 0)
    host["mf_ex"][:] = rng.normal(0, 0.3, (N - 1, DX)).astype(np.float32)
    host["mf_ex_g2sum"][:] = rng.random(N - 1).astype(np.float32)
    return host


def _both_ws(optimizer=""):
    host = _host(optimizer=optimizer)
    return (jemb.build_working_set(host, D, pad_to=N),
            temb.build_working_set(host, torch.device("cpu"), pad_to=N))


def _batch(seed=6, b=B):
    rng = np.random.default_rng(seed)
    per = (N - 1) // S
    idx = np.zeros((S, L, b), np.int32)
    for s in range(S):
        idx[s] = 1 + s * per + rng.integers(0, per, (L, b))
    lengths = rng.integers(0, L + 1, (S, b)).astype(np.int32)
    for s in range(S):
        for i in range(b):
            idx[s, lengths[s, i]:, i] = 0
    d_pooled = rng.normal(0, 1, (b, S, 3 + D + DX)).astype(np.float32)
    ins_cvm = np.stack([np.ones(b), rng.integers(0, 2, b)], 1).astype(
        np.float32)
    return idx, lengths, d_pooled, ins_cvm, (100 + np.arange(S)).astype(
        np.int32)


def _plans(idx, trimmed):
    b = idx.shape[2]
    jd, td = jmxu.make_dims(S * L * b, N), tmxu.make_dims(S * L * b, N)
    jeff = teff = None
    if trimmed:
        real = int((idx != 0).sum())
        jeff, teff = jsp.trimmed_dims(jd, real), tsp.trimmed_dims(td, real)
        assert teff.p_pad == jeff.p_pad < td.p_pad
    return (jd, jmxu.build_plan(jnp.asarray(idx), jd, jeff),
            td, tmxu.build_plan(torch.as_tensor(idx), td, teff))


def _assert_fields(got, want, **tol):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype, k
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **tol)


@pytest.mark.parametrize("trimmed", [False, True])
@pytest.mark.parametrize("crossing", ["take", "sort"])
def test_mxu_pull_with_expand_matches_jax(crossing, trimmed):
    b = 256 if trimmed else B      # wide enough for the trim to bite
    jws, tws = _both_ws()
    idx = _batch(b=b)[0]
    jd, jplan, td, tplan = _plans(idx, trimmed)
    want = jmxu.pull_pool_cvm(jws, jplan, jd, (S, L, b), True,
                              interpret=True, crossing=crossing)
    got = tmxu.pull_pool_cvm(tws, tplan, td, (S, L, b), True)
    assert tuple(got.shape) == (b, S, 3 + D + DX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    # the port's own pull against an f32 pooling of the gathered values
    idx_sbl = torch.as_tensor(np.transpose(idx, (0, 2, 1)).copy())
    base, ex = temb.pull_sparse_extended(tws, idx_sbl)
    pooled = torch.cat([base, ex], dim=-1).sum(dim=2)         # [S, B, E]
    show, click = torch.log(pooled[..., 0] + 1), torch.log(pooled[..., 1] + 1)
    ref = torch.cat([torch.stack([show, click - show], -1), pooled[..., 2:]],
                    -1).permute(1, 0, 2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    # the pull table carries the ex columns between mf and mf_size
    tab = tmxu._pull_table(tws, td)
    assert tab.shape[0] == 3 + D + DX + 1
    np.testing.assert_array_equal(tab[3 + D:3 + D + DX, :N].numpy(),
                                  tws["mf_ex"].numpy().T)


@pytest.mark.parametrize("trimmed", [False, True])
@pytest.mark.parametrize("crossing", ["take", "sort"])
@pytest.mark.parametrize("thresh", [0.0, 1e9])
def test_mxu_push_with_expand_matches_jax(crossing, trimmed, thresh):
    jws, tws = _both_ws()
    idx, _, d_pooled, ins_cvm, slot_ids = _batch(b=256 if trimmed else B)
    jd, jplan, td, tplan = _plans(idx, trimmed)
    ex_before = tws["mf_ex"].clone()
    want = jmxu.push_and_update(
        jws, jplan, jd, jnp.asarray(idx), jnp.asarray(d_pooled),
        jnp.asarray(ins_cvm), jnp.asarray(slot_ids),
        JSgd(mf_create_thresholds=thresh), interpret=True, crossing=crossing)
    got = tmxu.push_and_update(
        tws, tplan, td, torch.as_tensor(idx), torch.as_tensor(d_pooled),
        torch.as_tensor(ins_cvm), torch.as_tensor(slot_ids),
        TSgd(mf_create_thresholds=thresh))
    _assert_fields(got, want, **KERNEL_TOL)
    assert not torch.equal(got["mf_ex"], ex_before)     # mf_ex trained


def test_acc_from_delta_splits_the_ex_columns():
    delta = torch.arange(4 * (D + DX + 4), dtype=torch.float32).reshape(
        D + DX + 4, 4)
    acc = tmxu.acc_from_delta(delta, 3, d_main=D)
    want = jmxu.acc_from_delta(jnp.asarray(delta.numpy()), 3, d_main=D)
    _assert_fields(acc, want, rtol=0, atol=0)
    assert tuple(acc["g_embedx_ex"].shape) == (3, DX)
    assert "g_embedx_ex" not in tmxu.acc_from_delta(delta, 3)


def test_extended_pull_push_ops_match_jax():
    """pull_sparse_extended / push_sparse_grads_extended at [S, B, L]
    indices, then adagrad: the JAX package's test_ops_extended case at
    this file's sizes."""
    jws, tws = _both_ws()
    idx, lengths, _, _, slot_ids = _batch()
    idx_sbl = np.transpose(idx, (0, 2, 1)).copy()
    jbase, jex = jemb.pull_sparse_extended(jws, jnp.asarray(idx_sbl))
    tbase, tex = temb.pull_sparse_extended(tws, torch.as_tensor(idx_sbl))
    np.testing.assert_array_equal(tbase.numpy(), np.asarray(jbase))
    np.testing.assert_array_equal(tex.numpy(), np.asarray(jex))
    assert tuple(tex.shape) == (S, B, L, DX)

    rng = np.random.default_rng(9)
    live = (np.arange(L)[None, None, :] < lengths[:, :, None])
    grads = rng.normal(0, 1, (S, B, L, 3 + D)).astype(np.float32)
    grads[..., 0] = 1.0
    grads *= live[..., None]
    grads_ex = rng.normal(0, 1, (S, B, L, DX)).astype(np.float32)
    grads_ex *= live[..., None]
    want = jemb.push_sparse_grads_extended(
        jws, jnp.asarray(idx_sbl), jnp.asarray(grads), jnp.asarray(grads_ex),
        jnp.asarray(slot_ids))
    got = temb.push_sparse_grads_extended(
        tws, torch.as_tensor(idx_sbl), torch.as_tensor(grads),
        torch.as_tensor(grads_ex), torch.as_tensor(slot_ids))
    _assert_fields(got, want, rtol=1e-6, atol=1e-6)

    cfg = dict(mf_create_thresholds=5.0)
    wout = jopt.sparse_adagrad_apply(jws, want, JSgd(**cfg))
    ex_before = tws["mf_ex"].clone()
    gout = topt.apply_push(tws, got, TSgd(**cfg))
    _assert_fields({k: gout[k] for k in wout}, wout, rtol=1e-6, atol=1e-6)
    assert not torch.equal(gout["mf_ex"], ex_before)


@pytest.mark.parametrize("rule", RULES)
def test_rules_train_or_carry_mf_ex_as_jax(rule):
    jws, tws = _both_ws(optimizer=rule)
    rng = np.random.default_rng(11)
    g_show = np.where(rng.random(N) < 0.6, rng.integers(1, 6, N), 0)
    acc = {"g_show": g_show.astype(np.float32),
           "g_click": np.minimum(g_show, rng.integers(0, 3, N))
           .astype(np.float32),
           "g_embed": rng.normal(0, 1, N).astype(np.float32),
           "g_embedx": rng.normal(0, 1, (N, D)).astype(np.float32),
           "g_embedx_ex": rng.normal(0, 1, (N, DX)).astype(np.float32),
           "slot": rng.integers(100, 104, N).astype(np.int32)}
    cfg = dict(mf_create_thresholds=5.0, optimizer=rule)
    want = jopt.OPTIMIZERS[rule](jws, {k: jnp.asarray(v)
                                       for k, v in acc.items()},
                                 JSgd(**cfg))
    ex_before = tws["mf_ex"].clone()
    g2_before = tws["mf_ex_g2sum"].clone()
    got = topt.apply_push(tws, {k: torch.as_tensor(v)
                                for k, v in acc.items()}, TSgd(**cfg))
    _assert_fields({k: got[k] for k in want}, want, rtol=1e-6, atol=1e-7)
    moved = not torch.equal(got["mf_ex"], ex_before)
    assert moved == (rule == "adagrad")
    assert torch.equal(got["mf_ex_g2sum"], g2_before) == (rule != "adagrad")


def _pass_pair(sparse_path="auto", model_ex=True, **sgd_kw):
    """Both packages' engines over a 4-batch pass with an expand table,
    and trainers with the same CtrDnn weights."""
    jcfg, jdata = h.datasets(h.JAX, seed=21, nb=4)
    tcfg, tdata = h.datasets(h.TORCH, seed=21, nb=4)
    sgd = {"mf_create_thresholds": 0.0, **sgd_kw}
    jeng = h.engine(h.JAX, jdata, table_kw={"expand_dim": DX}, **sgd)
    teng = h.engine(h.TORCH, tdata, table_kw={"expand_dim": DX}, **sgd)
    width = 3 + h.MF + (DX if model_ex else 0)
    jtr = h.JAX.Trainer(jeng, JCtrDnn(h.S, width, h.DENSE, hidden=(16,)),
                        jcfg, batch_size=h.B, seed=3,
                        sparse_path=sparse_path)
    ttr = h.TORCH.Trainer(teng, TCtrDnn(h.S, width, h.DENSE, hidden=(16,)),
                          tcfg, batch_size=h.B, seed=3, device="cpu",
                          sparse_path=sparse_path)
    ttr.model.load_jax_params(jax.tree.map(np.asarray, jtr.params))
    return (jeng, jtr, jdata), (teng, ttr, tdata)


@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
def test_trainer_pass_with_expand_matches_jax(packed):
    (jeng, jtr, jdata), (teng, ttr, tdata) = _pass_pair()
    assert "mf_ex" in teng.ws and ttr._resolve_path() == "mxu"
    assert jtr._resolve_path() == "mxu"
    ex0 = teng.ws["mf_ex"].clone()
    jl = [s["loss"] for s in h.train_batches(jtr, jdata, packed)]
    tl = [s["loss"] for s in h.train_batches(ttr, tdata, packed)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for f in ("mf", "mf_ex"):
        np.testing.assert_allclose(teng.ws[f].numpy(), np.asarray(jeng.ws[f]),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert not torch.equal(teng.ws["mf_ex"], ex0)


@pytest.mark.parametrize("path", ["fast", "reference"])
def test_explicit_fast_and_reference_carry_mf_ex(path):
    """Not refused (as in the JAX package): a model of the base width
    trains, and mf_ex stays as it was in both packages."""
    (jeng, jtr, jdata), (teng, ttr, tdata) = _pass_pair(path, model_ex=False)
    ex0 = teng.ws["mf_ex"].clone()
    jl = [s["loss"] for s in h.train_batches(jtr, jdata, True)]
    tl = [s["loss"] for s in h.train_batches(ttr, tdata, True)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-6)
    assert torch.equal(teng.ws["mf_ex"], ex0)
    np.testing.assert_array_equal(np.asarray(jeng.ws["mf_ex"]), ex0.numpy())
    np.testing.assert_allclose(teng.ws["mf"].numpy(),
                               np.asarray(jeng.ws["mf"]), rtol=1e-4,
                               atol=1e-6)


def _routing_trainer(pkg, sparse_path, dym, fast_path=True):
    cfg, data = h.datasets(pkg, seed=22, nb=1)
    sgd = {"slot_mf_dims": ((100, 2),)} if dym else {}
    eng = h.engine(pkg, data, table_kw={"expand_dim": DX}, **sgd)
    model = (JCtrDnn if pkg is h.JAX else TCtrDnn)(
        h.S, 3 + h.MF + DX, h.DENSE, hidden=(8,))
    return pkg.Trainer(eng, model, cfg, batch_size=h.B, seed=0,
                       sparse_path=sparse_path, fast_path=fast_path,
                       **pkg.kw)


ROUTES = [  # (sparse_path, dynamic dims, fast_path)
    ("auto", False, True), ("auto", True, True), ("auto", True, False),
    ("mxu", False, True), ("mxu", True, True), ("ragged", False, True),
    ("fast", False, True), ("fast", True, True), ("reference", False, True),
    ("reference", True, True)]


@pytest.mark.parametrize("route", ROUTES, ids=["-".join(map(str, r))
                                               for r in ROUTES])
def test_routing_refuses_as_jax(route):
    """_resolve_path / _validate_path with an expand table, one for one
    against the JAX package's: the same resolved path, or a ValueError
    in both."""
    out = {}
    for name, pkg in (("jax", h.JAX), ("torch", h.TORCH)):
        tr = _routing_trainer(pkg, *route)
        try:
            path = tr._resolve_path()
            tr._validate_path(path)
            out[name] = path
        except ValueError:
            out[name] = "refused"
    assert out["torch"] == out["jax"], out
    want = {("auto", False, True): "mxu", ("auto", True, True): "refused",
            ("auto", True, False): "reference",
            ("mxu", True, True): "refused", ("ragged", False, True):
            "refused"}
    if route in want:
        assert out["torch"] == want[route]


def test_cache_on_equals_off_with_expand():
    """The device row cache's store is per field, so mf_ex rides along:
    a 2-day × 3-pass day loop with an expand table gives the same
    losses, table rows (every field) and dense state with the cache on as
    off."""
    prev = {k: flags.get_flags(k)
            for k in ("ps_device_cache", "ps_device_cache_rows")}
    StatRegistry.instance().reset()
    try:
        cache_off()
        off = run("mxu", "serial", expand=DX)[0]
        cache_on()
        on, rec = run("mxu", "serial", expand=DX)
    finally:
        flags.set_flags(prev)
    assert "mf_ex" in off[1].table.bulk_pull(off[1].table.export_keys()[:1])
    assert sum(p["ps.cache.hits"] for p in rec.passes) > 0
    assert_same_bits(on, off)
