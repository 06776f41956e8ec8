"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.load_benchmark()
LIMITS = {"loss_gap", "grad_gap", "change_gap", "sparse_gap",
          "count_mismatch", "writeback_mismatch"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    assert len(names) == len(set(names))
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline_pct") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c, cfg, tr = harness.cell_files(BENCH, cell)
    assert c["chips"] in (1, 4) and len(c["why"]) <= 200
    entry = {e["name"]: e for e in BENCH["configs"]}[c["config"]]
    assert entry["file"].startswith("portbench/")
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert tr["name"] == c["traffic"]
    assert harness.load_module("drivers", tr["driver"]).run
    for m in harness.metrics_of(BENCH, False) \
            + harness.metrics_of(BENCH, True):
        assert harness.load_module("metrics", m["name"]).read
    assert set(cfg["correct_limits"]) == LIMITS


def test_every_config_is_used_and_cuts_no_width():
    used = {c["config"] for c in BENCH["workloads"]}
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                        r"projection|head|expansion|experts_per_token")
    for e in BENCH["configs"]:
        assert e["name"] in used
        assert len(e["reduced"]) <= 16
        assert not [k for k in e["reduced"] if widths.search(k)]
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_missing_files_are_refused():
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")
    with pytest.raises(KeyError):
        harness.cell_files(BENCH, "no.such.cell")


@pytest.mark.parametrize(
    "path", sorted((ROOT / "portbench" / "configs").glob("*.json")),
    ids=lambda p: p.stem)
def test_every_config_file_is_complete(path):
    cfg = json.loads(path.read_text())
    assert cfg["name"] == path.stem and cfg["source"].startswith("https://")
    assert cfg["assumed"] and cfg["published"]
    # reduced holds cuts of scale only; departures from the paper's model
    # are listed apart
    assert not set(cfg["departures"]) & set(cfg["reduced"])
    assert set(cfg["correct_limits"]) == LIMITS
    assert harness.load_module("drivers", "steady_pass").run
    from portbench.reference import steps
    assert steps.model_module(cfg["model"]).param_specs(cfg)
