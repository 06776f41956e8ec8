"""On the card: the control (the reference in TF32, one precision below
the configuration's) fails each cell's limits, and a tiny run of the
port through the whole harness is correct.  Skipped without a card.

    python -m pytest -q portbench/tests -m cuda
"""

import pytest
import torch

from portbench import harness, traffic, weights
from portbench.reference import compare, steps

from tiny import CONFIGS, run_tiny

CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(card, cell):
    """At the cell's widths and batch, over its three checked batches
    (the pass cut to them), on three seeds."""
    bench = harness.load_benchmark()
    _, cfg, tr = harness.cell_files(bench, cell)
    tr = dict(tr, batches_per_pass=3)
    limits = {k: v for k, v in cfg["correct_limits"].items()
              if k != "writeback_mismatch"}
    for seed in (101, 102, 103):
        records = traffic.make_pass(tr, cfg["batch_size"], seed, card)
        init = weights.draw(steps.model_module(cfg["model"]).param_specs(cfg),
                            seed + 1, card)
        ref = steps.follow(records, cfg, init, seed + 2, 3, card)
        ctl = steps.follow(records, cfg, init, seed + 2, 3, card, tf32=True)
        ok, checks = compare.judge(compare.readings(ctl, ref, init), limits)
        assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("config", CONFIGS)
def test_tiny_run_on_the_card(card, config):
    line, code = run_tiny(config, 2**31 + 3, 0.5, True, card)
    assert code == 0 and line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert "breakdown" in line
