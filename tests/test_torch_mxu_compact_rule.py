"""The packed mxu step's sparse rule over the batch's own rows.

``pass_feed.precompute_plans`` gives every batch the rows its push
reaches (``rule_rows``, row 0 first, padded with row 0, and
``rule_keep``; ``pass_feed.mxu_step_plan`` hands them on as the step
plan's ``rule``), and ``mxu_path.push_and_update(rule=)`` then steps
those rows alone (``apply_push(rows=)``) instead of every working-set
row.  Each
rule of ``OPTIMIZERS``, on plans trimmed and untrimmed, with and without
the static payload planes, and with per-row dynamic mf dims, is held to
the whole-set rule on the same plan: untouched rows and row 0 keep
their bits, touched rows are bit-equal but for the row sums of the
embedx group (``mf_g2sum``, ``mf_gsum``), which the compact rule adds
over a contiguous [U, D] gradient, not a column-major [N, D] view
(rtol 1e-6).  The batches carry padding occurrences, so row 0's merged
column holds pushes the rule must ignore.
"""

import types

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.config import SparseSGDConfig
from paddlebox_tpu_torch.data import pass_feed as pf
from paddlebox_tpu_torch.ops import sorted_spmm as sp
from paddlebox_tpu_torch.ps import embedding as emb
from paddlebox_tpu_torch.ps import feature_value as fv
from paddlebox_tpu_torch.ps import mxu_path
from paddlebox_tpu_torch.ps import optimizer as sparse_opt
from paddlebox_tpu_torch.ps import ragged_path
from paddlebox_tpu_torch.utils import trace

RULES = tuple(sparse_opt.OPTIMIZERS)
N, D, S, L, B, NB = 300, 4, 5, 3, 16, 3
DYM = ((100, 2), (102, 3))
ROW_SUMS = ("mf_g2sum", "mf_gsum")
CPU = torch.device("cpu")
SLOTS = torch.arange(100, 100 + S, dtype=torch.int32)


def _ws(rule, seed=0):
    rng = np.random.default_rng(seed)
    host = fv.default_rows(N - 1, D, rng, 1e-2, optimizer=rule)
    host["show"][:] = rng.integers(0, 20, N - 1)
    host["click"][:] = np.minimum(host["show"], rng.integers(0, 4, N - 1))
    host["mf_size"][:] = np.where(rng.random(N - 1) < 0.5, D, 0)
    host["slot"][:] = rng.integers(100, 100 + S, N - 1)
    for f, v in host.items():
        if "g2sum" in f or "gsum" in f:
            v[...] = rng.random(v.shape) * (0.5 if "g2" in f else 0.1)
        elif f.endswith(("b1p", "b2p")):
            v[...] = rng.uniform(0.3, 0.99, v.shape)
    return emb.build_working_set(host, CPU, pad_to=N)


def _feed(seed=1):
    """NB batches [S, L, B] over slot-disjoint key ranges, with ragged
    lengths and holes: padding occurrences (row 0) in every batch."""
    rng = np.random.default_rng(seed)
    per = (N - 1) // S
    idx = np.zeros((NB, S, L, B), np.int32)
    for s in range(S):
        idx[:, s] = 1 + s * per + rng.integers(0, per, (NB, L, B))
    idx[rng.random(idx.shape) < 0.1] = 0
    lengths = rng.integers(0, L + 1, (NB, S, B))
    for i, s, b in np.ndindex(NB, S, B):
        idx[i, s, lengths[i, s, b]:, b] = 0
    labels = rng.integers(0, 2, (NB, B)).astype(np.float32)
    return types.SimpleNamespace(
        data={"indices": torch.as_tensor(idx),
              "labels": torch.as_tensor(labels)}, plans=None)


def _dims():
    """Small chunks and tiles, so a trimmed plan really drops padding."""
    return sp.spmm_dims(S * L * B, N, chunk=32, tile=64)


def _plans(trimmed, payload):
    feed = _feed()
    dims = _dims()
    eff = None
    if trimmed:
        real = int((feed.data["indices"] != 0).sum(dim=(1, 2, 3)).max())
        eff = sp.trimmed_dims(dims, real)
        assert eff.p_pad < dims.p_pad
    pf.precompute_plans(feed, dims, eff,
                        slot_ids=SLOTS.numpy() if payload else None)
    return feed, dims


def _grads(i, seed=2):
    rng = np.random.default_rng(seed + i)
    d_pooled = torch.as_tensor(
        rng.normal(0, 1, (B, S, 3 + D)).astype(np.float32))
    ins_cvm = torch.as_tensor(np.stack(
        [np.ones(B), rng.integers(0, 2, B)], 1).astype(np.float32))
    return d_pooled, ins_cvm


def _push(ws, step, dims, idx, i, cfg):
    """``step``: a ``mxu_path.StepPlan``."""
    d_pooled, ins_cvm = _grads(i)
    mxu_path.push_and_update(ws, step.plan, dims, idx, d_pooled, ins_cvm,
                             SLOTS, cfg, payload=step.payload,
                             rule=step.rule)


def _clone(ws):
    return {f: v.clone() for f, v in ws.items()}


def _bits(t):
    return t.numpy().view(np.int32)


@pytest.mark.parametrize("payload", [True, False],
                         ids=["payload_planes", "legacy_payload"])
@pytest.mark.parametrize("trimmed", [True, False],
                         ids=["trimmed", "untrimmed"])
@pytest.mark.parametrize("rule", RULES)
def test_compact_rule_equals_whole_set_rule(rule, trimmed, payload):
    _check_compact(rule, trimmed, payload, ())


@pytest.mark.parametrize("rule", RULES)
def test_compact_rule_with_dynamic_mf_dims(rule):
    _check_compact(rule, True, True, DYM)


def _check_compact(rule, trimmed, payload, dym):
    cfg = SparseSGDConfig(optimizer=rule, mf_create_thresholds=2.0,
                          slot_mf_dims=dym)
    feed, dims = _plans(trimmed, payload)
    padded = False
    ws_c, ws_w = _ws(rule), _ws(rule)
    for i in range(NB):
        step = pf.mxu_step_plan(pf.slice_batch(feed.plans, i))
        assert (step.payload is not None) == payload
        rule_rows, keep = step.rule
        assert bool((step.plan.rows2d == 0).any())  # row 0's run is planned
        padded |= bool((rule_rows[1:] == 0).any())
        idx = feed.data["indices"][i]
        before = _clone(ws_c)
        _push(ws_c, step, dims, idx, i, cfg)
        _push(ws_w, step._replace(rule=None), dims, idx, i, cfg)
        pushed = np.zeros(N, bool)
        pushed[rule_rows[keep > 0].numpy()] = True
        assert not pushed[0]
        assert bool((ws_c["show"][1:] != before["show"][1:]).any())
        for f in ws_c:
            c, w, b = ws_c[f].numpy(), ws_w[f].numpy(), before[f].numpy()
            # untouched rows and row 0: their bits, on both sides
            np.testing.assert_array_equal(_bits(ws_c[f])[~pushed],
                                          _bits(before[f])[~pushed],
                                          err_msg=f)
            np.testing.assert_array_equal(w[~pushed], b[~pushed], err_msg=f)
            if f in ROW_SUMS:
                np.testing.assert_allclose(c[pushed], w[pushed], rtol=1e-6,
                                           atol=0, err_msg=f)
            else:
                np.testing.assert_array_equal(_bits(ws_c[f])[pushed],
                                              _bits(ws_w[f])[pushed],
                                              err_msg=f)
        # the sides start every batch from the same state
        for f in ROW_SUMS:
            if f in ws_w:
                ws_w[f].copy_(ws_c[f])
    assert padded                              # some batch pads its rows


def test_rule_rows_are_each_batchs_pushed_rows():
    """rule_rows: row 0, then the sorted distinct non-zero rows of the
    batch's ids, then row 0 up to one length for the pass, a multiple of
    8; rule_keep marks the pushed rows."""
    for trimmed in (True, False):
        feed, _ = _plans(trimmed, True)
        rows, keep = feed.plans["rule_rows"], feed.plans["rule_keep"]
        assert rows.dtype == torch.int32 and keep.dtype == torch.float32
        u_pad = rows.shape[1]
        assert rows.shape == keep.shape == (NB, u_pad) and u_pad % 8 == 0
        uniq = [np.setdiff1d(np.unique(feed.data["indices"][i].numpy()), 0)
                for i in range(NB)]
        assert u_pad == -(-(1 + max(map(len, uniq))) // 8) * 8
        for i, u in enumerate(uniq):
            want = np.zeros(u_pad, np.int32)
            want[1:1 + len(u)] = u
            np.testing.assert_array_equal(rows[i].numpy(), want)
            np.testing.assert_array_equal(keep[i].numpy(),
                                          (want > 0).astype(np.float32))


def test_plan_tuple_tells_the_plan_kinds_apart():
    """The feed's two plan builders: the mxu step plan names its plan,
    its payload planes where the pass built them and its rule rows; the
    ragged builder names the CSR plan; a plan wider than the step's
    geometry is refused."""
    feed, _ = _plans(True, True)
    mxu = pf.slice_batch(feed.plans, 0)
    step = pf.mxu_step_plan(mxu)
    assert all(getattr(step.plan, k) is mxu[k] for k in pf.PLAN_KEYS)
    assert all(getattr(step.payload, k) is mxu[k]
               for k in mxu_path.PayloadPlanes._fields)
    assert step.rule.rows is mxu["rule_rows"]
    assert step.rule.keep is mxu["rule_keep"]
    no_payload = {k: v for k, v in mxu.items()
                  if k not in mxu_path.PayloadPlanes._fields}
    step = pf.mxu_step_plan(no_payload)
    assert step.payload is None and step.rule.rows is mxu["rule_rows"]
    csr = pf.build_csr_plans(feed.data["indices"].numpy()
                             .transpose(1, 0, 3, 2).reshape(S, NB * B, L),
                             SLOTS.tolist(), NB, B)
    ragged = pf.csr_plan({k: torch.as_tensor(v[0]) for k, v in csr.items()})
    assert isinstance(ragged, ragged_path.CsrPlan)
    np.testing.assert_array_equal(ragged.u_rows.numpy(), csr["u_rows"][0])
    narrow = sp.spmm_dims(S * L * B // 2, N, chunk=32, tile=64)
    with pytest.raises(ValueError, match="chunks"):
        mxu_path.push_and_update(_ws("adagrad"), step.plan, narrow,
                                 feed.data["indices"][0], *_grads(0), SLOTS,
                                 SparseSGDConfig())


@pytest.mark.parametrize("rule", RULES)
def test_in_step_plan_keeps_the_whole_set_rule(rule, monkeypatch):
    """The streaming step's in-step plan (no rule rows) steps every row,
    through the rule on the whole working set, as before the row
    lists."""
    cfg = SparseSGDConfig(optimizer=rule, mf_create_thresholds=2.0)
    feed = _feed()
    dims = _dims()
    idx = feed.data["indices"][0]
    step = mxu_path.StepPlan(mxu_path.build_plan(idx, dims))
    assert step.payload is None and step.rule is None
    calls = []
    apply = sparse_opt.apply_push

    def spy(ws, acc, cfg, *a, **k):
        calls.append(({key: v.clone() for key, v in acc.items()}, a, k))
        return apply(ws, acc, cfg, *a, **k)

    monkeypatch.setattr(sparse_opt, "apply_push", spy)
    ws, before = _ws(rule), _ws(rule)
    trace.disable()
    tracer = trace.enable()
    try:
        _push(ws, step, dims, idx, 0, cfg)
    finally:
        trace.disable()
    (acc, a, k), = calls
    assert not a and not k
    spans = [s for s in tracer.spans() if s["name"] ==
             "ps.optimizer.apply_push"]
    assert [s["attrs"]["rows"] for s in spans] == [N]
    want = sparse_opt.OPTIMIZERS[rule](before, acc, cfg, None, 0)
    for f in ws:
        np.testing.assert_array_equal(
            _bits(ws[f]), _bits(want[f] if f in want else before[f]),
            err_msg=f)


def test_packed_plan_span_counts_the_row_list():
    feed, dims = _plans(True, True)
    step = pf.mxu_step_plan(pf.slice_batch(feed.plans, 0))
    ws = _ws("adagrad")
    trace.disable()
    tracer = trace.enable()
    try:
        _push(ws, step, dims, feed.data["indices"][0], 0, SparseSGDConfig())
    finally:
        trace.disable()
    rows = [s["attrs"]["rows"] for s in tracer.spans()
            if s["name"] == "ps.optimizer.apply_push"]
    assert rows == [feed.plans["rule_rows"].shape[1]]
