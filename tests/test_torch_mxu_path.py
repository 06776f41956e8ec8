"""The port's mxu pull/push against the JAX package's.

One working set (host rows from a numpy seed) and one batch (planned
untrimmed, and trimmed as the packed feed plans it) go through
``mxu_path.pull_pool_cvm`` and ``mxu_path.push_and_update`` (adagrad) of
both packages.  The JAX side runs its Pallas kernels in interpret mode;
the port runs on the CPU (the kernels' plain versions).  Every plan
record the port builds reads back by name, and the trainer hands each
step the record its lowering takes.

Tolerance rtol 1e-5 / atol 1e-5: the Pallas kernels sum a hi/lo bf16
split of their f32 inputs (~1e-5 relative, mxu_path.py:11-12), while the
port's plain versions copy and add in f32; everything else is the same
elementwise f32 math.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddlebox_tpu.config import SparseSGDConfig as JSgd
from paddlebox_tpu.ps import embedding as jemb, feature_value as jfv
from paddlebox_tpu.ops import sorted_spmm as jsp
from paddlebox_tpu.ps import mxu_path as jmxu
from paddlebox_tpu_torch.config import SparseSGDConfig as TSgd
from paddlebox_tpu_torch.data import pass_feed as tpf
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.ps import embedding as temb
from paddlebox_tpu_torch.ops import sorted_spmm as tsp
from paddlebox_tpu_torch.ps import mxu_path as tmxu
from paddlebox_tpu_torch.ps import ragged_path as trag

import torch_parity_helpers as h

N, D, S, L, B = 300, 4, 5, 3, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _host(seed=0):
    rng = np.random.default_rng(seed)
    host = jfv.default_rows(N - 1, D, rng, 1e-2)
    host["show"][:] = rng.integers(1, 50, N - 1).astype(np.float32)
    host["click"][:] = rng.integers(0, 5, N - 1).astype(np.float32)
    host["mf_size"][:] = np.where(rng.random(N - 1) < 0.7, D, 0)
    host["embed_g2sum"][:] = rng.random(N - 1).astype(np.float32)
    host["mf_g2sum"][:] = rng.random(N - 1).astype(np.float32)
    return host


def _batch(seed=1, B=B):
    rng = np.random.default_rng(seed)
    per = (N - 1) // S
    idx = np.zeros((S, L, B), np.int32)
    for s in range(S):      # slot-disjoint key ranges, like real feasigns
        idx[s] = 1 + s * per + rng.integers(0, per, (L, B))
    idx[rng.random((S, L, B)) < 0.1] = 0
    lengths = rng.integers(0, L + 1, (S, B)).astype(np.int32)
    for s in range(S):
        for b in range(B):
            idx[s, lengths[s, b]:, b] = 0
    d_pooled = rng.normal(0, 1, (B, S, 3 + D)).astype(np.float32)
    ins_cvm = np.stack([np.ones(B), rng.integers(0, 2, B)], 1).astype(
        np.float32)
    slot_ids = (100 + np.arange(S)).astype(np.int32)
    return idx, d_pooled, ins_cvm, slot_ids


def _both_ws():
    host = _host()
    jws = jemb.build_working_set(host, D, pad_to=N)
    tws = temb.build_working_set(host, torch.device("cpu"), pad_to=N)
    return jws, tws


@pytest.mark.parametrize("use_cvm", [True, False])
def test_pull_pool_cvm_matches_jax(use_cvm):
    jws, tws = _both_ws()
    idx = _batch()[0]
    jd, td = jmxu.make_dims(S * L * B, N), tmxu.make_dims(S * L * B, N)
    want = jmxu.pull_pool_cvm(jws, jmxu.build_plan(jnp.asarray(idx), jd),
                              jd, (S, L, B), use_cvm, interpret=True)
    got = tmxu.pull_pool_cvm(tws, tmxu.build_plan(torch.as_tensor(idx), td),
                             td, (S, L, B), use_cvm)
    assert tuple(got.shape) == (B, S, 3 + D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("thresh", [0.0, 5.0, 1e9])
def test_push_and_update_matches_jax(thresh):
    """Adagrad push over the merged scatter: every working-set field,
    including mf creation at several thresholds, and the in-place update
    of the port's working set."""
    jws, tws = _both_ws()
    idx, d_pooled, ins_cvm, slot_ids = _batch()
    jd, td = jmxu.make_dims(S * L * B, N), tmxu.make_dims(S * L * B, N)
    want = jmxu.push_and_update(
        jws, jmxu.build_plan(jnp.asarray(idx), jd), jd, jnp.asarray(idx),
        jnp.asarray(d_pooled), jnp.asarray(ins_cvm), jnp.asarray(slot_ids),
        JSgd(mf_create_thresholds=thresh), interpret=True)
    show_before = tws["show"]
    got = tmxu.push_and_update(
        tws, tmxu.build_plan(torch.as_tensor(idx), td), td,
        torch.as_tensor(idx), torch.as_tensor(d_pooled),
        torch.as_tensor(ins_cvm), torch.as_tensor(slot_ids),
        TSgd(mf_create_thresholds=thresh))
    assert got is tws and got["show"] is show_before      # in place
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.dtype == w.dtype, k
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)


@pytest.mark.parametrize("thresh", [0.0, 1e9])
def test_trimmed_plan_matches_jax(thresh):
    """Plans trimmed to the real occurrences (the packed feed's form,
    8-tuple): the pull clamps and masks the dropped row-0 positions, the
    push scatters the kept suffix of the bijection."""
    b = 128                      # wide enough for the trim to bite
    jws, tws = _both_ws()
    idx, d_pooled, ins_cvm, slot_ids = _batch(2, b)
    jd, td = jmxu.make_dims(S * L * b, N), tmxu.make_dims(S * L * b, N)
    real = int((idx != 0).sum())
    jeff = jsp.trimmed_dims(jd, real)
    teff = tsp.trimmed_dims(td, real)
    assert teff.p_pad == jeff.p_pad < td.p_pad
    jplan = jmxu.build_plan(jnp.asarray(idx), jd, jeff)
    tplan = tmxu.build_plan(torch.as_tensor(idx), td, teff)
    assert tmxu.plan_eff_dims(tplan, td) == teff
    want = jmxu.pull_pool_cvm(jws, jplan, jd, (S, L, b), interpret=True)
    got = tmxu.pull_pool_cvm(tws, tplan, td, (S, L, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jmxu.push_and_update(
        jws, jplan, jd, jnp.asarray(idx), jnp.asarray(d_pooled),
        jnp.asarray(ins_cvm), jnp.asarray(slot_ids),
        JSgd(mf_create_thresholds=thresh), interpret=True)
    got = tmxu.push_and_update(
        tws, tplan, td, torch.as_tensor(idx), torch.as_tensor(d_pooled),
        torch.as_tensor(ins_cvm), torch.as_tensor(slot_ids),
        TSgd(mf_create_thresholds=thresh))
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)


def _plan_vs_jax(trimmed):
    """build_plan's Plan: the JAX package's 8-tuple, field by field."""
    idx = _batch(3, 128)[0]
    jd, td = jmxu.make_dims(S * L * 128, N), tmxu.make_dims(S * L * 128, N)
    jeff = teff = None
    if trimmed:
        real = int((idx != 0).sum())
        jeff, teff = jsp.trimmed_dims(jd, real), tsp.trimmed_dims(td, real)
    jplan = jmxu.build_plan(jnp.asarray(idx), jd, jeff)
    tplan = tmxu.build_plan(torch.as_tensor(idx), td, teff)
    assert isinstance(tplan, tsp.Plan) and len(jplan) == len(tplan)
    assert tpf.PLAN_KEYS == tsp.Plan._fields
    for name, want in zip(tsp.Plan._fields, jplan):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(want), err_msg=name)
    assert (tmxu.plan_eff_dims(tplan, td) is None) == (not trimmed)


def _steps(monkeypatch, module, path, packed):
    """One batch of a trainer pass on ``path``, with ``module``'s
    ``push_and_update`` recording the plan and keywords it is handed;
    returns (the records, the pass's feed or None)."""
    seen = []
    push = module.push_and_update

    def spy(ws, plan, *a, **k):
        seen.append((plan, k))
        return push(ws, plan, *a, **k)

    monkeypatch.setattr(module, "push_and_update", spy)
    cfg, data = h.datasets(h.TORCH, nb=1)
    eng = h.engine(h.TORCH, data)
    tr = h.TORCH.Trainer(eng, TDeepFM(h.S, 3 + h.MF, h.DENSE,
                                      hidden=(16, 16)),
                         cfg, batch_size=h.B, seed=3, sparse_path=path,
                         device="cpu")
    feed = tr.build_pass_feed(data[0]) if packed else None
    tr.train_pass(feed if packed else data[0])
    assert len(seen) == 1
    return seen[0], feed


def _assert_batch0(record, feed, keys):
    """Each named field of ``record`` is the feed's batch-0 plane."""
    for name, key in keys:
        assert torch.equal(getattr(record, name), feed.plans[key][0]), key


def _in_step(monkeypatch):
    (plan, kw), _ = _steps(monkeypatch, tmxu, "mxu", packed=False)
    assert isinstance(plan, tsp.Plan)
    assert kw.get("payload") is None and kw.get("rule") is None


def _packed(monkeypatch):
    (plan, kw), feed = _steps(monkeypatch, tmxu, "mxu", packed=True)
    assert isinstance(plan, tsp.Plan)
    _assert_batch0(plan, feed, zip(tsp.Plan._fields, tpf.PLAN_KEYS))
    assert isinstance(kw["payload"], tmxu.PayloadPlanes)
    _assert_batch0(kw["payload"], feed, [(k, k) for k in
                                         ("bs", "labelcol", "slotcol")])
    assert isinstance(kw["rule"], tmxu.RuleRows)
    _assert_batch0(kw["rule"], feed, [("rows", "rule_rows"),
                                      ("keep", "rule_keep")])


def _packed_no_payload(monkeypatch):
    """Without slot ids the feed builds no payload planes (as for labels
    of several columns): the record has the plan and the rule rows."""
    idx = torch.as_tensor(np.stack([_batch(4)[0], _batch(5)[0]]))
    feed = types.SimpleNamespace(
        data={"indices": idx, "labels": torch.zeros((2, B))}, plans=None)
    dims = tmxu.make_dims(S * L * B, N)
    tpf.precompute_plans(feed, dims)
    step = tpf.mxu_step_plan(tpf.slice_batch(feed.plans, 0))
    assert step.payload is None and isinstance(step.rule, tmxu.RuleRows)
    _assert_batch0(step.plan, feed, zip(tsp.Plan._fields, tpf.PLAN_KEYS))
    _assert_batch0(step.rule, feed, [("rows", "rule_rows"),
                                     ("keep", "rule_keep")])
    assert torch.equal(step.plan.rows2d,
                       tmxu.build_plan(idx[0], dims).rows2d)


def _ragged(monkeypatch):
    (plan, kw), feed = _steps(monkeypatch, trag, "ragged", packed=True)
    assert isinstance(plan, trag.CsrPlan) and not kw
    _assert_batch0(plan, feed, [(k, k) for k in trag.CsrPlan._fields])


PLAN_KINDS = {
    "jax_untrimmed": lambda mp: _plan_vs_jax(False),
    "jax_trimmed": lambda mp: _plan_vs_jax(True),
    "in_step": _in_step,
    "packed_no_payload": _packed_no_payload,
    "packed": _packed,
    "ragged": _ragged,
}


@pytest.mark.parametrize("kind", list(PLAN_KINDS))
def test_plans_read_back_by_name(kind, monkeypatch):
    PLAN_KINDS[kind](monkeypatch)


# (S, L, B, D, Dex, trimmed) of the pooling cases: the two widths the
# benchmark's cells pull at (36 at L = 1, 132 at L = 16), an expand table
# (W = 3 + 8 + 8 + 1), each planned untrimmed and trimmed
POOL_CASES = {
    "w36_l1": (4, 1, 1024, 32, 0, False),
    "w36_l1_trimmed": (4, 1, 1024, 32, 0, True),
    "w132_l16": (3, 16, 40, 128, 0, False),
    "w132_l16_trimmed": (3, 16, 40, 128, 0, True),
    "expand_w20_l4_trimmed": (5, 4, 64, 8, 8, True),
}


def _pool_inputs(case):
    """A pull table from a working set (some rows not yet created) and a
    plan over padded [S, L, B] ids: (g as the sorted gather writes it,
    the plan, (S, L, B))."""
    s, l, b, d, dx, trimmed = POOL_CASES[case]
    n = 300
    rng = np.random.default_rng(11)
    ws = {"show": rng.integers(1, 50, n), "click": rng.integers(0, 5, n),
          "embed_w": rng.normal(0, 1, n), "mf": rng.normal(0, 1, (n, d)),
          "mf_size": np.where(rng.random(n) < 0.6, d, 0)}
    if dx:
        ws["mf_ex"] = rng.normal(0, 1, (n, dx))
    for f in ws.values():
        f[0] = 0                                       # the reserved row
    ws = {k: torch.as_tensor(v, dtype=torch.int32 if k == "mf_size"
                             else torch.float32) for k, v in ws.items()}
    idx = rng.integers(1, n, (s, l, b)).astype(np.int32)
    lengths = rng.integers(0, l + 1, (s, b))
    idx[np.arange(l)[None, :, None] >= lengths[:, None, :]] = 0
    dims = tmxu.make_dims(s * l * b, n)
    eff = tsp.trimmed_dims(dims, int((idx != 0).sum())) if trimmed else None
    plan = tmxu.build_plan(torch.as_tensor(idx), dims, eff)
    g = tsp.gather_sorted(tmxu._pull_table(ws, dims), plan.rows2d,
                          eff or dims)
    # a dropped occurrence read by mistake would alias kept position 0:
    # give that position head values that show
    g[:3, 0] += 1.0
    return g, plan, (s, l, b)


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool_sorted_cvm_plain_matches_the_chain(case, use_cvm):
    """The pool's plain version against the chain of PyTorch ops it
    replaces on the mxu pull: take by inv_perm (clamped and zeroed at a
    trimmed plan's dropped positions), then ``pool_cvm_values``, which
    masks the embedding columns by created, sums over L and applies the
    CVM."""
    g, plan, slb = _pool_inputs(case)
    w = g.shape[0]
    inv = plan.inv_perm
    v = g.T[torch.clamp(inv, min=0).long()] * (inv >= 0).to(g.dtype)[:, None]
    want = tmxu.pool_cvm_values(v.reshape(*slb, w), use_cvm)
    got = tsp.pool_sorted_cvm(g, inv, slb, use_cvm)
    assert got.shape == (slb[2], slb[0], w - 1) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    # the cases reach what the mask and the skip are for: live
    # occurrences of rows not yet created, and (trimmed) dropped ones
    live = inv >= 0
    assert bool((live & (g[w - 1, torch.clamp(inv, min=0).long()] == 0)
                 & (g[2, torch.clamp(inv, min=0).long()] != 0)).any())
    assert bool((~live).any()) == POOL_CASES[case][5]
    assert tsp.pool_sorted_cvm.launches == 0        # card launches only
