"""The reference against a tiny run of the port on the CPU, and the
check catching the faults a training cell can have, planted in the
program underneath a whole run."""

import math

import pytest
import torch

from portbench import harness, traffic, weights
from portbench.reference import compare, steps

from tiny import CONFIGS, run_tiny, tiny_bench, tiny_files


@pytest.mark.parametrize("config", CONFIGS)
def test_port_agrees_with_the_reference(config):
    line, code = run_tiny(config)
    assert code == 0
    assert line["correct"] is True, line["checks"]
    checks = line["checks"]
    assert checks["count_mismatch"]["value"] == 0
    assert checks["writeback_mismatch"]["value"] == 0
    assert checks["grad_gap"]["value"] < 1e-5
    assert checks["change_gap"]["value"] < 1e-5
    assert checks["sparse_gap"]["value"] < 1e-3
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert set(line["metrics"]) == {
        m["name"] for m in harness.metrics_of(tiny_bench(), False)}
    assert line["notes"]["lowering"] == "mxu"


def test_state_left_unchanged_is_caught(monkeypatch):
    from paddlebox_tpu_torch.ps import optimizer as sparse_opt
    monkeypatch.setattr(sparse_opt, "apply_push", lambda ws, *a, **k: ws)
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    line, code = run_tiny("widedeep-criteo")
    assert code == 0 and line["correct"] is False
    # every leaf reads its whole change; the median leaf about 1
    assert line["checks"]["change_gap"]["value"] > 0.9
    assert line["checks"]["sparse_gap"]["value"] > 0.1
    assert line["notes"]["sparse_max"] == 1.0
    assert line["checks"]["count_mismatch"]["value"] > 0


@pytest.mark.parametrize("field", ["g_embed", "g_embedx"])
def test_a_lost_sparse_push_is_caught(monkeypatch, field):
    """The push of the lr weight's or the embedx gradient lost before the
    program's sparse rule: only the rows' gap can see it."""
    from paddlebox_tpu_torch.ps import optimizer as sparse_opt
    apply = sparse_opt.apply_push

    def lossy(ws, acc, *a, **k):
        acc = dict(acc)
        acc[field] = torch.zeros_like(acc[field])
        return apply(ws, acc, *a, **k)

    monkeypatch.setattr(sparse_opt, "apply_push", lossy)
    line, code = run_tiny("widedeep-criteo")
    assert code == 0 and line["correct"] is False
    checks = line["checks"]
    assert checks["sparse_gap"]["value"] > 0.1
    assert line["notes"]["sparse_field"] == (
        "embed_w" if field == "g_embed" else "mf")
    assert checks["count_mismatch"]["value"] == 0


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from paddlebox_tpu_torch.trainer.trainer import SparseTrainer
    core = SparseTrainer._core

    def half(self, path, idx, lengths, dense, labels, valid, **kw):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = 0
        return core(self, path, idx, lengths, dense, labels, valid, **kw)

    monkeypatch.setattr(SparseTrainer, "_core", half)
    line, code = run_tiny("widedeep-criteo")
    assert code == 0 and line["correct"] is False
    assert line["checks"]["loss_gap"]["value"] > 1e-3


def test_a_write_back_that_drops_a_field_is_caught(monkeypatch):
    from paddlebox_tpu_torch.ps import embedding
    dump = embedding.dump_working_set

    def lossy(ws, n):
        out = dump(ws, n)
        out["embed_w"] = out["embed_w"] * 0
        return out

    monkeypatch.setattr(embedding, "dump_working_set", lossy)
    line, code = run_tiny("widedeep-criteo")
    assert code == 0 and line["correct"] is False
    assert line["checks"]["writeback_mismatch"]["value"] > 0


def _reference_pair(config, **kw):
    _, _, cfg, tr = tiny_files(config)
    records = traffic.make_pass(tr, cfg["batch_size"], 9, "cpu")
    init = weights.draw(steps.model_module(cfg["model"]).param_specs(cfg),
                        3, "cpu")
    ref = steps.follow(records, cfg, init, 5, 3, "cpu")
    return ref, steps.follow(records, cfg, init, 5, 3, "cpu", **kw), init


def test_reference_faults_read_as_stated():
    ref, half, init = _reference_pair("widedeep-criteo", half_batch=True)
    assert compare.readings(half, ref, init)["grad_gap"] > 1e-2
    same = compare.readings(ref, ref, init)
    assert same["loss_gap"] == same["grad_gap"] == same["change_gap"] == 0
    assert same["sparse_gap"] == 0
    still = compare.readings(compare.unchanged(ref, init), ref, init)
    assert still["change_gap"] > 0.9 and still["_change_worst"] == 1.0
    assert still["sparse_gap"] > 0.1 and still["_sparse_max"] == 1.0
    assert still["count_mismatch"] > 0
    for field, leaf in (("g_embed", "embed_w"), ("g_embedx", "mf")):
        _, lost, _ = _reference_pair("widedeep-criteo", lost_push=field)
        got = compare.readings(lost, ref, init)
        assert got["sparse_gap"] > 0.1 and got["_sparse_max"] == 1.0
        assert got["_sparse_field"] == leaf
        assert got["count_mismatch"] == 0


def test_row_gaps():
    fresh = torch.zeros(200)
    ref = torch.ones(200)
    assert compare.row_gaps(ref, ref, fresh) == {"q99": 0.0, "max": 0.0}
    # one row in 200 off by 0.5 of the largest change: the widest row
    # reads it, the 99th percentile row does not
    prog = ref.clone()
    prog[7] = 1.5
    got = compare.row_gaps(prog, ref, fresh)
    assert got["max"] == pytest.approx(0.5) and got["q99"] == 0.0
    # every row unmoved: both read 1
    assert compare.row_gaps(fresh, ref, fresh) == {"q99": 1.0, "max": 1.0}
    # the reference unmoved and the program moved: infinite
    assert compare.row_gaps(ref, fresh, fresh)["q99"] == math.inf
    assert compare.row_gaps(fresh, fresh, fresh)["q99"] == 0.0
