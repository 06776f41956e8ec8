"""The instance dump (``TrainerConfig(dump_path=...)``) of the PyTorch
port against the JAX package's.

The same small DeepFM pass (4 slots, mf_dim 4, hidden (16, 16), batch
64, 3 batches, records carrying ``ins_id``s, the port's weights loaded
from the JAX model) trains in both packages with a dump path, streaming
and packed, and on a pv-grouped packed pass whose batches are short (the
per-batch real ranges).  Both must write ``dump-pass-<pass_id>.txt``
with one ``ins_id\\tlabel\\tpred`` line per real record, the same ids
and labels in the same order, and preds within 2e-6 (1e-6 between the
two packages' preds plus the 6-decimal print's rounding).  A packed feed
built without its host arrays is refused, as in the JAX package.
"""

import os

import numpy as np
import jax
import pytest

from paddlebox_tpu.config import TrainerConfig as JTrainerConfig
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu_torch.config import TrainerConfig
from paddlebox_tpu_torch.models.deepfm import DeepFM

import torch_parity_helpers as h


def _name_records(blocks):
    """Every record of ``blocks`` named ``r<n>``, in order."""
    n = 0
    for blk in blocks:
        blk.ins_ids = [f"r{n + i}" for i in range(blk.n)]
        n += blk.n


def _with_ids(pkg, cfg, blocks):
    """One dataset of ``blocks``, every record named."""
    _name_records(blocks)
    ds = pkg.Dataset(cfg)
    ds._blocks = list(blocks)
    return ds


def _pass(pkg, pv):
    if pv:
        # pv-grouped: batches cut on page views, so most are short
        cfg, ds = h.pv_pass(pkg, seed=3)
        _name_records(ds.get_blocks())
        return cfg, ds, ds
    cfg, data = h.datasets(pkg, seed=2)
    ds = _with_ids(pkg, cfg, [d.get_blocks()[0] for d in data])
    return cfg, ds, ds


def _run(pkg, out_dir, packed, pv=False, params=None):
    cfg, ds, keys_ds = _pass(pkg, pv)
    eng = h.engine(pkg, [keys_ds])
    tc = (TrainerConfig if pkg is h.TORCH else JTrainerConfig)(
        dump_path=str(out_dir))
    model = (DeepFM if pkg is h.TORCH else JDeepFM)(
        h.S, 3 + h.MF, h.DENSE, hidden=(16, 16))
    tr = pkg.Trainer(eng, model, cfg, batch_size=h.B, seed=3,
                     trainer_config=tc, **pkg.kw)
    if params is not None:
        tr.model.load_jax_params(params)
    init = (jax.tree.map(np.asarray, tr.params) if pkg is h.JAX else None)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    path = os.path.join(str(out_dir), f"dump-pass-{eng.pass_id}.txt")
    with open(path) as f:
        lines = [ln.rstrip("\n").split("\t") for ln in f]
    return init, stats, lines, ds


@pytest.mark.parametrize("mode", ["streaming", "packed", "packed_pv"])
def test_dump_matches_jax(tmp_path, mode):
    packed, pv = mode != "streaming", mode == "packed_pv"
    init, _, jlines, _ = _run(h.JAX, tmp_path / "jax", packed, pv)
    _, stats, tlines, ds = _run(h.TORCH, tmp_path / "torch", packed, pv,
                                params=init)
    n_real = sum(b.n for b in ds.get_blocks())
    assert len(tlines) == len(jlines) == n_real
    assert [ln[0] for ln in tlines] == [ln[0] for ln in jlines]
    assert sorted(ln[0] for ln in tlines) == sorted(
        f"r{i}" for i in range(n_real))
    assert [ln[1] for ln in tlines] == [ln[1] for ln in jlines]
    np.testing.assert_allclose([float(ln[2]) for ln in tlines],
                               [float(ln[2]) for ln in jlines], rtol=0,
                               atol=2e-6)
    assert all(len(ln[2].split(".")[1]) == 6 for ln in tlines)
    assert stats["dump_s"] >= 0.0
    if pv:
        # the pv pass has short batches: the dump skipped their padding
        assert n_real < stats["batches"] * h.B


def test_dump_lines_are_the_pass_preds(tmp_path):
    """The packed dump's preds are the step's own: the same batch's
    sigmoid outputs to 6 decimals, and labels as %g."""
    cfg, ds, _ = _pass(h.TORCH, False)
    eng = h.engine(h.TORCH, [ds])
    tr = h.TORCH.Trainer(eng, DeepFM(h.S, 3 + h.MF, h.DENSE, hidden=(16, 16)),
                         cfg, batch_size=h.B, seed=3, device="cpu",
                         trainer_config=TrainerConfig(
                             dump_path=str(tmp_path)))
    preds = []
    core = tr._core

    def spy(*a, **k):
        loss, p = core(*a, **k)
        preds.append(p.clone())
        return loss, p
    tr._core = spy
    feed = tr.build_pass_feed(ds)
    assert feed.host is not None and feed.host.ins_ids[0] == "r0"
    tr.train_pass(feed)
    with open(tmp_path / f"dump-pass-{eng.pass_id}.txt") as f:
        lines = [ln.rstrip("\n").split("\t") for ln in f]
    want = np.concatenate([p.numpy() for p in preds])[:len(lines)]
    assert [ln[2] for ln in lines] == [f"{p:.6f}" for p in want]
    labels = feed.host.labels[:len(lines)]
    assert [ln[1] for ln in lines] == [f"{x:g}" for x in labels]


def test_packed_feed_without_host_arrays_is_refused(tmp_path):
    for pkg, tc in ((h.JAX, JTrainerConfig), (h.TORCH, TrainerConfig)):
        cfg, ds, _ = _pass(pkg, False)
        eng = h.engine(pkg, [ds])
        model = (DeepFM if pkg is h.TORCH else JDeepFM)(
            h.S, 3 + h.MF, h.DENSE, hidden=(16, 16))
        tr = pkg.Trainer(eng, model, cfg, batch_size=h.B, seed=3, **pkg.kw)
        feed = tr.build_pass_feed(ds)
        assert feed.host is None
        tr.trainer_config = tc(dump_path=str(tmp_path / "d"))
        with pytest.raises(ValueError, match="keep_host"):
            tr.train_pass(feed)


def test_keep_host_without_dump(tmp_path):
    cfg, ds, _ = _pass(h.TORCH, False)
    eng = h.engine(h.TORCH, [ds])
    tr = h.TORCH.Trainer(eng, DeepFM(h.S, 3 + h.MF, h.DENSE, hidden=(16, 16)),
                         cfg, batch_size=h.B, seed=3, device="cpu")
    feed = tr.build_pass_feed(ds, keep_host=True)
    h_ = feed.host
    assert h_ is not None and h_.num_real == sum(b.n for b in ds.get_blocks())
    lo, cnt, base = h_.real_range(h_.n_batches - 1)
    assert lo == base == (h_.n_batches - 1) * h.B and cnt == h.B
    assert not os.listdir(tmp_path)
