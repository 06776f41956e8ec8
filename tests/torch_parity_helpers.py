"""Shared factories of the PyTorch-port parity tests: one small seeded
pass, made in numpy, as datasets, engines and trainers of both packages.

``JAX`` and ``TORCH`` bundle each package's config, data, engine and
trainer classes; the factories take one of them, so both packages get
the same records, the same seeded host rows and the same layout.  One
dataset per batch, so each batch is its own ``train_pass`` and the
per-batch losses can be compared (the JAX package's ``train_pass``
returns only their mean).
"""

import types

import numpy as np

from paddlebox_tpu import config as jcfg
from paddlebox_tpu.data.dataset import SlotDataset as JDataset
from paddlebox_tpu.data.slot_record import SlotRecordBlock as JBlock
from paddlebox_tpu.ps.pass_manager import BoxPSEngine as JEngine
from paddlebox_tpu.trainer.trainer import SparseTrainer as JTrainer
from paddlebox_tpu_torch import config as tcfg
from paddlebox_tpu_torch.data.dataset import SlotDataset as TDataset
from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock as TBlock
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine as TEngine
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer as TTrainer

JAX = types.SimpleNamespace(
    Feed=jcfg.DataFeedConfig, Slot=jcfg.SlotConfig,
    Table=jcfg.EmbeddingTableConfig,
    Sgd=jcfg.SparseSGDConfig, Block=JBlock, Dataset=JDataset,
    Engine=JEngine, Trainer=JTrainer, kw={})
TORCH = types.SimpleNamespace(
    Feed=tcfg.DataFeedConfig, Slot=tcfg.SlotConfig,
    Table=tcfg.EmbeddingTableConfig, Sgd=tcfg.SparseSGDConfig, Block=TBlock,
    Dataset=TDataset, Engine=TEngine, Trainer=TTrainer,
    kw={"device": "cpu"})

# slots, mf_dim, dense dim, slot capacity, batch, batches, key space
S, MF, DENSE, CAP, B, NB, KEYS = 4, 4, 3, 3, 64, 3, 400


def raw_batches(seed=0, n_labels=1, b=B, nb=NB, disjoint=False):
    """Per batch: ({slot: (values, offsets)}, labels [n_labels, b], dense).
    disjoint: each slot draws from its own key range, so no key is pushed
    under two slots."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nb):
        slots = {}
        for i in range(S):
            lens = rng.integers(1, CAP + 1, b)
            off = np.zeros(b + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            keys = rng.integers(1, KEYS, int(off[-1]))
            if disjoint:
                keys += i * KEYS
            slots[f"s{i}"] = (keys.astype(np.uint64), off)
        labels = rng.integers(0, 2, (n_labels, b)).astype(np.float32)
        out.append((slots, labels,
                    rng.normal(0, 1, b * DENSE).astype(np.float32)))
    return out


def label_names(n_labels):
    return ["label"] + [f"label{t}" for t in range(1, n_labels)]


def datasets(pkg, seed=0, n_labels=1, b=B, nb=NB, disjoint=False):
    """(feed config, one dataset per batch) of ``pkg``."""
    names = label_names(n_labels)
    cfg = pkg.Feed(slots=tuple(
        [pkg.Slot(n, dtype="float", is_dense=True, dim=1) for n in names]
        + [pkg.Slot("dense0", dtype="float", is_dense=True, dim=DENSE)]
        + [pkg.Slot(f"s{i}", slot_id=100 + i, capacity=CAP)
           for i in range(S)]))
    out = []
    for slots, labels, dense in raw_batches(seed, n_labels, b, nb,
                                            disjoint):
        blk = pkg.Block(n=b)
        blk.uint64_slots = dict(slots)
        for n, lab in zip(names, labels):
            blk.float_slots[n] = (lab, np.arange(b + 1, dtype=np.int64))
        blk.float_slots["dense0"] = (dense,
                                     np.arange(b + 1, dtype=np.int64) * DENSE)
        ds = pkg.Dataset(cfg)
        ds._blocks = [blk]
        out.append(ds)
    return cfg, out


def engine(pkg, data, **sgd_kw):
    """A pass over every key of ``data``, begun (host rows from seed 7)."""
    sgd = pkg.Sgd(**{"mf_create_thresholds": 1.0, **sgd_kw})
    eng = pkg.Engine(pkg.Table(embedding_dim=MF, shard_num=4, sgd=sgd),
                     seed=7, **pkg.kw)
    eng.begin_feed_pass()
    for ds in data:
        for blk in ds.get_blocks():
            eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    return eng


def train_batches(trainer, data, packed=False):
    """Train each dataset as its own pass call, streaming or through
    build_pass_feed; returns the per-call stats."""
    out = []
    for ds in data:
        out.append(trainer.train_pass(trainer.build_pass_feed(ds) if packed
                                      else ds))
    return out


def ws_numpy(eng):
    """A copy of the working set as numpy (either package)."""
    return {f: np.array(v, copy=True) for f, v in eng.ws.items()}


def assert_ws_close(got, want, **tol):
    assert set(got) == set(want), (set(got) ^ set(want))
    for f in want:
        if want[f].dtype == np.int32:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want[f], err_msg=f, **tol)


def assert_tree_close(got, want, **tol):
    """Nested dicts/lists of arrays (the JAX params layout)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_tree_close(got[k], want[k], **tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_close(g, w, **tol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)
