"""Tiny sizes of the benchmark's configurations for the CPU tests: every
width and count cut so that a whole run takes seconds.  Each
configuration file under ``configs/`` gets a tiny cell, whether or not
BENCHMARK.json runs it yet."""

import copy

from portbench import harness

TINY_CARDS = [50, 300, 2000, 7]
CONFIGS = sorted(p.stem for p in (harness.HERE / "configs").glob("*.json"))


def tiny_bench():
    """BENCHMARK.json's metrics over one tiny cell a configuration,
    named ``<config>.tiny``."""
    bench = copy.deepcopy(harness.load_benchmark())
    bench["configs"] = [{"name": n, "file": f"portbench/configs/{n}.json"}
                        for n in CONFIGS]
    bench["workloads"] = [{"name": f"{n}.tiny", "config": n,
                           "traffic": "criteo_zipf", "chips": 1}
                          for n in CONFIGS]
    return bench


def tiny_files(config: str):
    bench = tiny_bench()
    cell, cfg, tr = harness.cell_files(bench, f"{config}.tiny")
    tr = dict(tr, cardinalities=list(TINY_CARDS), batches_per_pass=4,
              dense_features=5)
    cfg = copy.deepcopy(cfg)
    cfg.update(num_slots=len(TINY_CARDS), dense_dim=5, batch_size=64,
               embedding_dim=4, hidden=[16, 8])
    # hot keys reach the embedx threshold within the three checked steps
    cfg["sparse_sgd"]["mf_create_thresholds"] = 2.0
    return bench, cell["name"], cfg, tr


def run_tiny(config: str, seed: int = 2**31 + 11, seconds: float = 0.2,
             trace: bool = False, device: str = "cpu"):
    bench, cell, cfg, tr = tiny_files(config)
    return harness.run_cell(bench, cell, seed, seconds, trace, device,
                            config=cfg, traffic=tr)
