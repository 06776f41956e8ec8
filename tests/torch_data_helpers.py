"""Seeded numpy records of the PyTorch-port parity tests, as either
package's datasets (``pkg``: a namespace with the package's ``Feed``,
``Slot``, ``Block`` and ``Dataset`` classes).  Imports no package, so a
worker process that must not import JAX can make the records the test
process makes (``tests/torch_parity_helpers.py`` re-exports them).
"""

import numpy as np

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


def pv_datasets(pkg, seed=0, nb=NB, b=B, uid=False, **feed_kw):
    """(feed config, one pv-grouped dataset per batch) of ``pkg``: page
    views of 1-4 records with distinct search ids, cmatch from {222, 223,
    224} and rank 0-4 (4 is out of range at max_rank 3), at most ``b``
    records a dataset, so each dataset is one pv-aligned batch.  ``uid``
    adds a capacity-1 sparse slot "uid" (ids 1..11) named as uid_slot;
    ``feed_kw`` goes to the feed config (rank_offset, ads_offset,
    max_rank)."""
    rng = np.random.default_rng(seed)
    slots = ([pkg.Slot("label", dtype="float", is_dense=True, dim=1),
              pkg.Slot("dense0", dtype="float", is_dense=True, dim=DENSE)]
             + [pkg.Slot(f"s{i}", slot_id=100 + i, capacity=CAP)
                for i in range(S)])
    if uid:
        slots.append(pkg.Slot("uid", slot_id=99, capacity=1))
        feed_kw["uid_slot"] = "uid"
    cfg = pkg.Feed(slots=tuple(slots), **feed_kw)
    out = []
    for k in range(nb):
        sizes = rng.integers(1, 5, b // 4)
        n = int(sizes.sum())
        blk = pkg.Block(n=n)
        for i in range(S):
            lens = rng.integers(1, CAP + 1, n)
            off = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            blk.uint64_slots[f"s{i}"] = (
                rng.integers(1, KEYS, int(off[-1])).astype(np.uint64), off)
        if uid:
            blk.uint64_slots["uid"] = (
                rng.integers(1, 12, n).astype(np.uint64),
                np.arange(n + 1, dtype=np.int64))
        blk.float_slots["label"] = (rng.integers(0, 2, n).astype(np.float32),
                                    np.arange(n + 1, dtype=np.int64))
        blk.float_slots["dense0"] = (
            rng.normal(0, 1, n * DENSE).astype(np.float32),
            np.arange(n + 1, dtype=np.int64) * DENSE)
        blk.search_ids = np.repeat(
            (k * 1000 + rng.choice(1000, len(sizes), replace=False))
            .astype(np.uint64), sizes)
        blk.cmatch = rng.choice([222, 223, 224], n).astype(np.int32)
        blk.rank = rng.integers(0, 5, n).astype(np.int32)
        ds = pkg.Dataset(cfg)
        ds._blocks = [blk]
        ds.preprocess_instance()
        out.append(ds)
    return cfg, out


def pv_pass(pkg, seed=0, nb=NB, b=B, uid=False, **feed_kw):
    """(feed config, one pv-grouped dataset) holding every record of
    :func:`pv_datasets`, so that its pv-aligned cuts make a pass of
    several batches."""
    cfg, data = pv_datasets(pkg, seed, nb, b, uid, **feed_kw)
    ds = pkg.Dataset(cfg)
    ds._blocks = [blk for d in data for blk in d.get_blocks()]
    ds.preprocess_instance()
    return cfg, ds
