"""The PyTorch port's 2-day × 3-pass DeepFM day loop of the device-cache
and heat tests (4 slots, mf_dim 4, hidden (16, 16), batch 64, 2 batches a
pass, on the CPU), run serially, through ``PassPrefetcher``, or pipelined
by hand, with per-pass readings of the counters the main thread moves."""

import numpy as np
import torch

from paddlebox_tpu_torch import flags
from paddlebox_tpu_torch.config import AccessorConfig
from paddlebox_tpu_torch.data.prefetch import PassPrefetcher
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.utils.monitor import stat_get

import torch_parity_helpers as h

S, MF, DENSE, B = h.S, h.MF, h.DENSE, h.B
N_DAYS, N_PASSES, NB = 2, 3, 2
DAYS = [f"2026080{d + 1}" for d in range(N_DAYS)]
SMALL = 96      # rows: a pass holds ~330 keys, so every fold-back evicts


def cache_on(rows: int = 4096):
    flags.set_flags({"ps_device_cache": True, "ps_device_cache_rows": rows})


def cache_off():
    flags.set_flags({"ps_device_cache": False})


def pass_data(day, p):
    cfg, data = h.datasets(h.TORCH, seed=100 * day + 10 * p + 1, nb=NB)
    ds = h.TORCH.Dataset(cfg)
    ds._blocks = [d.get_blocks()[0] for d in data]
    return cfg, ds


def make_pair(path, double=False, expand=0):
    """Engine and trainer of one run; ``expand``: the table's expand
    (mf_ex) width, the model's input widened to match."""
    t = h.TORCH
    eng = t.Engine(t.Table(embedding_dim=MF, shard_num=4, expand_dim=expand,
                           sgd=t.Sgd(mf_create_thresholds=0.0),
                           accessor=AccessorConfig(
                               accessor_type="ctr_double" if double
                               else "ctr")),
                   seed=7, device="cpu")
    cfg, _ = pass_data(0, 0)
    tr = t.Trainer(eng, DeepFM(S, 3 + MF + expand, DENSE, hidden=(16, 16)),
                   cfg, batch_size=B, seed=3, sparse_path=path, device="cpu")
    return eng, tr


class Recorder:
    """Per-pass readings of the counters the main thread moves."""

    KEYS = ("ps.cache.hits", "ps.cache.evictions",
            "ps.cache.gather_fallback_rows", "ps.engine.stale_refresh_rows")

    def __init__(self):
        self.prev = {k: stat_get(k) for k in self.KEYS}
        self.passes = []

    def pass_ended(self):
        cur = {k: stat_get(k) for k in self.KEYS}
        self.passes.append({k: cur[k] - self.prev[k] for k in self.KEYS})
        self.prev = cur


def feed_sync(eng, ds):
    eng.begin_feed_pass()
    for blk in ds.get_blocks():
        eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()


def run_serial(eng, tr, rec):
    out = []
    for day in range(N_DAYS):
        eng.set_date(DAYS[day])
        for p in range(N_PASSES):
            _, ds = pass_data(day, p)
            feed_sync(eng, ds)
            out.append(tr.train_pass(tr.build_pass_feed(ds)))
            eng.end_pass()
            rec.pass_ended()
    return out


def run_prefetch(eng, tr, rec):
    out = []
    with PassPrefetcher(eng, tr) as pre:
        for day in range(N_DAYS):
            for p in range(N_PASSES):
                def load(day=day, p=p):
                    _, ds = pass_data(day, p)
                    for blk in ds.get_blocks():
                        eng.add_keys(blk.all_keys())
                    return ds
                pre.submit(load, tag=f"d{day}p{p}", date=DAYS[day])
        for _ in range(N_DAYS * N_PASSES):
            out.append(tr.train_pass(pre.next_pass()))
            pre.end_pass()
            rec.pass_ended()
    return out


def run_pipelined(eng, tr, rec):
    """The prefetcher's order in one thread: within a day, pass N+1's
    feed (snapshot, dedup, pull) finishes before pass N's write-back and
    fold-back, and begin_pass adopts it after."""
    out = []
    for day in range(N_DAYS):
        eng.set_date(DAYS[day])
        _, ds = pass_data(day, 0)
        feed_sync(eng, ds)
        for p in range(N_PASSES):
            out.append(tr.train_pass(tr.build_pass_feed(ds)))
            if p + 1 < N_PASSES:
                _, ds = pass_data(day, p + 1)
                eng.begin_feed_pass()
                for blk in ds.get_blocks():
                    eng.add_keys(blk.all_keys())
                eng.end_feed_pass(async_build=True)
                eng.wait_feed_pass_done()
            eng.end_pass()
            rec.pass_ended()
            if p + 1 < N_PASSES:
                eng.begin_pass()
    return out


RUNS = {"serial": run_serial, "prefetch": run_prefetch,
        "pipelined": run_pipelined}


def run(path, mode, double=False, expand=0):
    eng, tr = make_pair(path, double, expand)
    rec = Recorder()
    out = RUNS[mode](eng, tr, rec)
    return (out, eng, tr), rec


def table_state(table):
    keys = np.sort(table.export_keys())
    return keys, table.bulk_pull(keys)


def assert_same_bits(a, b):
    (out_a, eng_a, tr_a), (out_b, eng_b, tr_b) = a, b
    assert [m["losses"] for m in out_a] == [m["losses"] for m in out_b]
    ka, sa = table_state(eng_a.table)
    kb, sb = table_state(eng_b.table)
    np.testing.assert_array_equal(ka, kb)
    assert set(sa) == set(sb)
    for f in sa:
        np.testing.assert_array_equal(sa[f], sb[f], err_msg=f)
    for k, v in tr_a.model.state_dict().items():
        assert torch.equal(v, tr_b.model.state_dict()[k]), k
    st_a = tr_a.dense_opt.state_dict()["state"]
    st_b = tr_b.dense_opt.state_dict()["state"]
    for i in st_a:
        for k in st_a[i]:
            assert torch.equal(st_a[i][k], st_b[i][k]), (i, k)
