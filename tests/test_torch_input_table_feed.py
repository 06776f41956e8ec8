"""The port's InputTable feed, pass-feed planes, PlaneStager and AucRunner
against the JAX package's.

* ``InputTable`` save/load (either package reads the other's file) and
  ``ReplicaCache`` rows and pulls.
* String ("InputTable") slots parse into the same aux index planes and
  the same table, and stay out of the feasign keys.
* A test-local replica-cache model (``CacheDnn``: the pooled net plus a
  user vector gathered by the aux index plane) trains on the streaming
  and the packed entry point, and its mean loss equals the JAX model's
  (rtol 1e-4).
* ``pack_pass``'s rank_offset / ads_offset / uid / aux planes are the
  JAX ``pack_pass``'s bit for bit, and so are the uploaded device
  planes.
* ``PlaneStager``: a staged upload equals an unstaged one bit for bit,
  and the stager refuses to run off the main thread.
* ``AucRunner``: the same reservoir and the same ablated block as the
  JAX package's from one seed.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.config import (DataFeedConfig as JFeed,
                                  SlotConfig as JSlot)
from paddlebox_tpu.data import pass_feed as jpf
from paddlebox_tpu.data.data_feed import SlotParser as JParser
from paddlebox_tpu.data.dataset import SlotDataset as JDataset
from paddlebox_tpu.metrics.auc_runner import AucRunner as JAucRunner
from paddlebox_tpu.models.layers import init_mlp, mlp_apply
from paddlebox_tpu.ps.aux_tables import (InputTable as JInputTable,
                                         ReplicaCache as JReplicaCache)
from paddlebox_tpu.ps.embedding import PassKeyMapper as JMapper
from paddlebox_tpu_torch.config import (DataFeedConfig as TFeed,
                                        SlotConfig as TSlot)
from paddlebox_tpu_torch.data import pass_feed as tpf
from paddlebox_tpu_torch.data.data_feed import SlotParser as TParser
from paddlebox_tpu_torch.data.dataset import SlotDataset as TDataset
from paddlebox_tpu_torch.metrics.auc_runner import AucRunner as TAucRunner
from paddlebox_tpu_torch.models.layers import MLP
from paddlebox_tpu_torch.ps.aux_tables import (InputTable as TInputTable,
                                               ReplicaCache as TReplicaCache)
from paddlebox_tpu_torch.ps.embedding import PassKeyMapper as TMapper

import torch_parity_helpers as h

CPU = torch.device("cpu")
E = 3 + h.MF


def test_input_table_save_load_across_packages(tmp_path):
    tables = (TInputTable(), JInputTable())
    for t in tables:
        for k in ("user:123", "user:456", "user:123", "ad:9"):
            t.get_or_insert(k)
        np.testing.assert_array_equal(
            t.get_or_insert_many(["ad:9", "ad:10"]), [3, 4])
    np.testing.assert_array_equal(tables[0].lookup(["user:456", "nope"]),
                                  tables[1].lookup(["user:456", "nope"]))
    for i, (src, dst_cls) in enumerate(((tables[0], JInputTable),
                                        (tables[1], TInputTable))):
        path = str(tmp_path / f"table{i}.txt")
        src.save(path)
        dst = dst_cls()
        dst.load(path)
        assert len(dst) == len(src) == 4
        keys = ["user:123", "user:456", "ad:9", "ad:10", "x"]
        np.testing.assert_array_equal(dst.lookup(keys), src.lookup(keys))


def test_replica_cache_matches_jax():
    rows = np.random.default_rng(0).normal(0, 1, (5, 4)).astype(np.float32)
    caches = (TReplicaCache(4), JReplicaCache(4))
    for c in caches:
        assert c.add_item(rows[0]) == 1
        np.testing.assert_array_equal(c.add_items(rows[1:]), [2, 3, 4, 5])
        assert len(c) == 6
    t_table = caches[0].to_device("cpu")
    assert caches[0].to_device("cpu") is t_table           # kept
    idx = np.array([[0, 3], [5, 1], [2, 2]], np.int32)
    got = TReplicaCache.pull(t_table, torch.as_tensor(idx)).numpy()
    want = np.asarray(JReplicaCache.pull(caches[1].to_device(),
                                         jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0], np.zeros(4))
    caches[0].add_item(rows[0])
    assert caches[0].to_device("cpu").shape == (7, 4)      # re-uploaded


def _cfg(Feed, Slot):
    return Feed(slots=(
        Slot("label", dtype="float", is_dense=True, dim=1),
        Slot("dense0", dtype="float", is_dense=True, dim=2),
        Slot("s0", slot_id=101, capacity=2),
        Slot("s1", slot_id=102, capacity=2),
        Slot("user", dtype="string", capacity=1),
    ))


def _write_data(path, n=96, seed=0):
    rng = np.random.default_rng(seed)
    users = [f"u{i:03d}" for i in range(12)]
    with open(path, "w") as f:
        for _ in range(n):
            parts = [f"1 {rng.integers(0, 2)}",
                     f"2 {rng.normal():.4f} {rng.normal():.4f}"]
            for _s in range(2):
                k = rng.integers(1, 3)
                vals = " ".join(str(rng.integers(1, 400)) for _ in range(k))
                parts.append(f"{k} {vals}")
            parts.append(f"1 {users[rng.integers(0, len(users))]}")
            f.write(" ".join(parts) + "\n")


def _loaded(Feed, Slot, Dataset, path):
    ds = Dataset(_cfg(Feed, Slot), read_threads=1)
    ds.set_filelist([path])
    ds.load_into_memory()
    return ds


def test_string_slots_parse_like_jax(tmp_path):
    path = str(tmp_path / "a.txt")
    _write_data(path)
    tds = _loaded(TFeed, TSlot, TDataset, path)
    jds = _loaded(JFeed, JSlot, JDataset, path)
    assert isinstance(tds.input_table, TInputTable)
    assert len(tds.input_table) == len(jds.input_table) > 1
    tb, jb = tds.get_blocks()[0], jds.get_blocks()[0]
    assert set(tb.aux_slots) == set(jb.aux_slots) == {"user"}
    for a, b in zip(tb.aux_slots["user"], jb.aux_slots["user"]):
        np.testing.assert_array_equal(a, b)
    # aux indices never reach the feasign tap
    np.testing.assert_array_equal(tb.all_keys(), jb.all_keys())
    assert "user" not in tb.uint64_slots
    # the parser alone, on lines with a shared table
    lines = open(path).read().splitlines()[:10]
    got = TParser(_cfg(TFeed, TSlot),
                  input_table=TInputTable()).parse_block(lines)
    want = JParser(_cfg(JFeed, JSlot),
                   input_table=JInputTable()).parse_block(lines)
    for a, b in zip(got.aux_slots["user"], want.aux_slots["user"]):
        np.testing.assert_array_equal(a, b)


class JCacheDnn:
    """The JAX package's test-local replica-cache model
    (tests/test_input_table_feed.py)."""

    extra_inputs = ("user",)

    def __init__(self, in_dim, cache, hidden=(16,)):
        self.cache, self.sizes = cache, (in_dim,) + tuple(hidden) + (1,)

    def init(self, key):
        return {"mlp": init_mlp(key, self.sizes)}

    def apply(self, params, pooled, dense, user):
        rows = JReplicaCache.pull(self.cache.to_device(), user[:, 0])
        x = jnp.concatenate([pooled, rows.astype(pooled.dtype), dense],
                            axis=-1)
        return mlp_apply(params["mlp"], x)[:, 0]


class TCacheDnn(torch.nn.Module):
    """The same model in the port: an MLP over the pooled features, the
    replica-cache row that the aux index plane selects, and the dense
    features."""

    extra_inputs = ("user",)

    def __init__(self, in_dim, cache, hidden=(16,)):
        super().__init__()
        self.cache = cache
        self.mlp = MLP((in_dim,) + tuple(hidden) + (1,))

    def reset_parameters(self, generator):
        self.mlp.reset_parameters(generator)

    def load_jax_params(self, params):
        self.mlp.load_jax_params(params["mlp"])

    def forward(self, pooled, dense, user):
        rows = TReplicaCache.pull(self.cache.to_device(pooled.device),
                                  user[:, 0])
        return self.mlp(torch.cat([pooled, rows.to(pooled.dtype), dense],
                                  dim=-1))[:, 0]


def _cache_run(pkg, Feed, Slot, Dataset, Cache, Model, path, packed,
               params=None):
    ds = _loaded(Feed, Slot, Dataset, path)
    eng = h.engine(pkg, [ds])
    cache = Cache(3)
    cache.add_items(np.random.default_rng(2).normal(
        0, 1, (len(ds.input_table), 3)).astype(np.float32))
    model = Model(2 * E + 2 + 3, cache)
    tr = pkg.Trainer(eng, model, ds.feed_config, batch_size=32, seed=1,
                     **pkg.kw)
    if params is not None:
        tr.model.load_jax_params(params)
    p0 = jax.tree.map(np.asarray, tr.params) if pkg is h.JAX else None
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    return stats, p0


@pytest.mark.parametrize("packed", [False, True], ids=["stream", "packed"])
def test_cache_model_trains_both_paths(tmp_path, packed):
    path = str(tmp_path / "b.txt")
    _write_data(path, seed=1)
    js, params = _cache_run(h.JAX, JFeed, JSlot, JDataset, JReplicaCache,
                            JCacheDnn, path, packed)
    ts, _ = _cache_run(h.TORCH, TFeed, TSlot, TDataset, TReplicaCache,
                       TCacheDnn, path, packed, params)
    assert ts["batches"] == 3 and np.isfinite(ts["losses"]).all()
    np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-4)
    np.testing.assert_allclose(ts["auc"], js["auc"], rtol=1e-4)


def test_model_requiring_missing_plane_fails_loud():
    cfg, data = h.datasets(h.TORCH, nb=1)
    eng = h.engine(h.TORCH, data)
    with pytest.raises(ValueError, match="extra_inputs"):
        h.TORCH.Trainer(eng, TCacheDnn(h.S * E + h.DENSE, TReplicaCache(3)),
                        cfg, batch_size=h.B, device="cpu")


def _pv_pass(pkg, Mapper, pv_cfg_kw, **kw):
    """The pv datasets of the helpers as one pass: pv-aligned batch counts
    over the concatenated blocks, with a string slot's aux plane and the
    uid plane."""
    cfg, data = h.pv_datasets(pkg, uid=True, **pv_cfg_kw)
    blocks = [b for ds in data for b in ds.get_blocks()]
    rng = np.random.default_rng(4)
    for blk in blocks:
        k = rng.integers(1, 3, blk.n)
        off = np.zeros(blk.n + 1, np.int64)
        np.cumsum(k, out=off[1:])
        blk.aux_slots["user"] = (rng.integers(1, 9, int(off[-1]))
                                 .astype(np.uint64), off)
    cfg = dataclasses.replace(cfg, slots=cfg.slots + (
        pkg.Slot("user", dtype="string", capacity=2),))
    counts = [b.n for b in blocks]
    keys = np.unique(np.concatenate([b.all_keys() for b in blocks]))
    return pkg_pack(pkg)(blocks, cfg, h.B, "label", key_mapper=Mapper(keys),
                         batch_counts=counts, **kw)


def pkg_pack(pkg):
    return jpf.pack_pass if pkg is h.JAX else tpf.pack_pass


PV_KW = dict(rank_offset=True, ads_offset=True, max_rank=3)


def test_pack_pass_planes_match_jax():
    want = _pv_pass(h.JAX, JMapper, PV_KW)
    got = _pv_pass(h.TORCH, TMapper, PV_KW)
    for f in ("indices", "lengths", "dense", "labels", "valid",
              "rank_offset", "ads_offset", "uid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert set(got.aux) == set(want.aux) == {"user"}
    np.testing.assert_array_equal(got.aux["user"], want.aux["user"])
    assert (got.rank_offset[:, 0] > 0).any()       # real ranked rows
    assert set(got.extra_planes()) == {"rank_offset", "user"}
    jfeed = jpf.upload_pass(want)
    tfeed = tpf.upload_pass(got, CPU)
    assert set(tfeed.data) == set(jfeed.data)
    for k in jfeed.data:
        np.testing.assert_array_equal(tfeed.data[k].numpy(),
                                      np.asarray(jfeed.data[k]), err_msg=k)
    assert tfeed.data["ads_offset"].shape == (got.n_batches, h.B + 1)
    np.testing.assert_array_equal(tfeed.uid, jfeed.uid)
    with pytest.raises(ValueError, match="pv-aligned"):
        cfg, data = h.pv_datasets(h.TORCH, nb=1, rank_offset=True)
        tpf.pack_pass(data[0].get_blocks(), cfg, h.B, "label")


def test_plane_stager_upload_equals_unstaged():
    stager = tpf.PlaneStager(CPU)
    staged = _pv_pass(h.TORCH, TMapper, PV_KW, on_plane=stager)
    assert set(stager.staged) == {"indices", "lengths", "dense", "labels",
                                  "valid", "user", "rank_offset",
                                  "ads_offset"}
    plain = _pv_pass(h.TORCH, TMapper, PV_KW)
    a = tpf.upload_pass(staged, CPU, staged=stager)
    b = tpf.upload_pass(plain, CPU)
    assert set(a.data) == set(b.data)
    for k in b.data:
        assert torch.equal(a.data[k], b.data[k]), k


def test_plane_stager_refused_off_the_main_thread():
    stager = tpf.PlaneStager(CPU)
    err = []

    def worker():
        try:
            _pv_pass(h.TORCH, TMapper, PV_KW, on_plane=stager)
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=worker, name="pack-worker")
    t.start()
    t.join()
    assert err and "main thread" in str(err[0])
    assert not stager.staged


def test_auc_runner_matches_jax():
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(40):
        ka = rng.integers(1, 100, rng.integers(1, 4))
        kb = rng.integers(100, 200, rng.integers(1, 3))
        lines.append(f"{len(ka)} " + " ".join(map(str, ka))
                     + f" {len(kb)} " + " ".join(map(str, kb)))
    blocks = []
    for Feed, Slot, Parser in ((TFeed, TSlot, TParser),
                               (JFeed, JSlot, JParser)):
        cfg = Feed(slots=(Slot("a", capacity=3), Slot("b", capacity=2)))
        blocks.append((Parser(cfg).parse_block(lines[:20]),
                       Parser(cfg).parse_block(lines[20:])))
    runners = (TAucRunner(["a"], pool_size=25, seed=3),
               JAucRunner(["a"], pool_size=25, seed=3))
    for r, (b1, b2) in zip(runners, blocks):
        r.record(b1)
        r.record(b2)
    assert runners[0].pool_sizes() == runners[1].pool_sizes() == {"a": 25}
    for p, q in zip(runners[0]._pool["a"], runners[1]._pool["a"]):
        np.testing.assert_array_equal(p, q)
    got = runners[0].replace(blocks[0][0], "a")
    want = runners[1].replace(blocks[1][0], "a")
    for name in ("a", "b"):
        for x, y in zip(got.uint64_slots[name], want.uint64_slots[name]):
            np.testing.assert_array_equal(x, y)
