"""The async dense table of the PyTorch port (trainer/async_dense.py) and
the trainer's ``dense_sync_mode="async_table"`` route, on the CPU.

* the table against the JAX package's ``AsyncDenseTable``: the same 8
  pushed grad trees give the same params bit for bit after ``drain()``
  (both are numpy f32 with the same expressions);
* ``drain()`` raises when the update thread died (the JAX package's
  tests/test_advice_fixes.py case), and refuses device tensors at push;
* a small DeepFM pass (4 slots, mf_dim 4, hidden (16, 16), batch 64, 3
  batches) on packed and streaming mxu: the params move, pushed =
  applied, the module's final params = ``pull()``, ``dense_opt`` never
  steps, and the table is pulled every ``sync_weight_step`` batches;
* the reference lowering and an explicit ``dense_optimizer`` are
  refused, and the device traffic of the route refuses other threads;
* the resume quirk both packages share: ``TrainCheckpoint.resume``
  restores the module's params but does not reseed the table, so after
  a pass the params are the table's construction-time params plus the
  pass's pushed grads, not the restored ones.
"""

import threading

import numpy as np
import jax
import pytest
import torch

from paddlebox_tpu.config import TrainerConfig as JTrainerConfig
from paddlebox_tpu.io.checkpoint import TrainCheckpoint as JCheckpoint
from paddlebox_tpu.models.deepfm import DeepFM as JDeepFM
from paddlebox_tpu.trainer.async_dense import AsyncDenseTable as JTable
from paddlebox_tpu_torch.config import TrainerConfig
from paddlebox_tpu_torch.io.checkpoint import TrainCheckpoint
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.trainer.async_dense import AsyncDenseTable

import torch_parity_helpers as h

ASYNC = dict(dense_sync_mode="async_table")


def grad_trees(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
             "b": rng.normal(0, 1, (3,)).astype(np.float32)}
            for _ in range(n)]


def test_table_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "b": np.zeros((3,), np.float32)}
    kw = dict(learning_rate=3e-3, beta1=0.8, beta2=0.99, eps=1e-7)
    tt, jt = AsyncDenseTable(params, **kw), JTable(params, **kw)
    for g in grad_trees():
        tt.push(g)
        jt.push(g)
    tt.drain()
    jt.drain()
    got, want = tt.pull(), jt.pull()
    assert tt.pushed == tt.applied == 8
    for k in params:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert not np.array_equal(got[k], params[k])
    np.testing.assert_array_equal(tt.finalize()["w"], jt.finalize()["w"])
    assert not tt.thread.is_alive()


def test_drain_raises_on_dead_thread():
    t = AsyncDenseTable({"w": np.zeros((4,), np.float32)})
    # a grad tree missing the param's name kills the update thread
    t._ch.put({"not_w": np.zeros((4,), np.float32)})
    t._pushed += 1
    with pytest.raises(RuntimeError, match="async dense update thread"):
        t.drain()


def test_normal_drain_and_tensor_refused():
    t = AsyncDenseTable({"w": np.zeros((4,), np.float32)})
    for _ in range(3):
        t.push({"w": np.ones((4,), np.float32)})
    t.drain()
    assert t.applied == 3
    with pytest.raises(TypeError, match="not a host array"):
        t.push({"w": torch.ones(4)})
    assert t.pushed == 3
    assert np.all(np.isfinite(t.finalize()["w"]))


def _trainer(pkg=h.TORCH, seed=0, data=None, sync=1, **kw):
    cfg, data = data or h.datasets(pkg, seed=seed)
    eng = h.engine(pkg, data)
    tc = (TrainerConfig if pkg is h.TORCH else JTrainerConfig)(
        sync_weight_step=sync, **ASYNC)
    model = (DeepFM if pkg is h.TORCH else JDeepFM)(
        h.S, 3 + h.MF, h.DENSE, hidden=(16, 16))
    tr = pkg.Trainer(eng, model, cfg, batch_size=h.B, seed=3,
                     trainer_config=tc, **pkg.kw, **kw)
    return eng, tr, data


def _one_pass_dataset(pkg, data):
    ds = pkg.Dataset(data[0].feed_config)
    ds._blocks = [d.get_blocks()[0] for d in data]
    return ds


def _params(tr):
    return {n: p.detach().clone().numpy()
            for n, p in tr.model.named_parameters()}


@pytest.mark.parametrize("sync", [1, 2])
@pytest.mark.parametrize("packed", [False, True], ids=["streaming", "packed"])
def test_trainer_async_pass(packed, sync):
    eng, tr, data = _trainer(sync=sync)
    assert tr._resolve_path() == "mxu"
    before = _params(tr)
    pulls = []
    pull = tr.async_dense.pull
    tr.async_dense.pull = lambda: pulls.append(1) or pull()
    ds = _one_pass_dataset(h.TORCH, data)
    stats = tr.train_pass(tr.build_pass_feed(ds) if packed else ds)
    assert stats["batches"] == h.NB and np.all(np.isfinite(stats["losses"]))
    assert stats["dense_copy_s"] >= 0.0
    table = tr.async_dense
    assert table.pushed == table.applied == h.NB
    # every sync_weight_step batches, and once more at the end of the pass
    assert len(pulls) == h.NB // sync + 1
    final = table.pull()
    after = _params(tr)
    for n in before:
        np.testing.assert_array_equal(after[n], final[n], err_msg=n)
        assert not np.array_equal(after[n], before[n]), n
    # dense_opt never stepped: no Adam state
    assert not tr.dense_opt.state_dict()["state"]


def test_async_pass_replays_into_a_fresh_table():
    """The params after a pass are exactly what a fresh table seeded
    with the initial params makes of the pushed grads."""
    eng, tr, data = _trainer(seed=4)
    init = _params(tr)
    pushed = []
    push = tr.async_dense.push
    tr.async_dense.push = lambda g: pushed.append(g) or push(g)
    tr.train_pass(tr.build_pass_feed(_one_pass_dataset(h.TORCH, data)))
    replay = AsyncDenseTable(init)
    for g in pushed:
        replay.push(g)
    want = replay.finalize()
    for n, v in _params(tr).items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)


def test_async_refuses_reference_and_explicit_optimizer():
    eng, tr, data = _trainer(sparse_path="reference")
    with pytest.raises(ValueError, match="async_table"):
        tr.train_pass(data[0])
    with pytest.raises(ValueError, match="async_table"):
        tr.build_pass_feed(data[0])
    cfg, data = h.datasets(h.TORCH)
    eng = h.engine(h.TORCH, data)
    model = DeepFM(h.S, 3 + h.MF, h.DENSE, hidden=(16, 16))
    with pytest.raises(ValueError, match="dense_optimizer"):
        h.TORCH.Trainer(eng, model, cfg, batch_size=h.B, device="cpu",
                        dense_optimizer=torch.optim.SGD(model.parameters(),
                                                        lr=0.1),
                        trainer_config=TrainerConfig(**ASYNC))


def test_async_device_traffic_refuses_other_threads():
    eng, tr, data = _trainer()
    tr.train_pass(data[0])
    err = []

    def worker():
        try:
            tr._load_async_params()
        except RuntimeError as e:
            err.append(str(e))
    t = threading.Thread(target=worker, name="not-main")
    t.start()
    t.join()
    assert err and "not-main" in err[0]


def test_allreduce_mode_still_steps_dense_opt():
    cfg, data = h.datasets(h.TORCH)
    eng = h.engine(h.TORCH, data)
    tr = h.TORCH.Trainer(eng, DeepFM(h.S, 3 + h.MF, h.DENSE, hidden=(16, 16)),
                         cfg, batch_size=h.B, seed=3, device="cpu")
    assert tr.async_dense is None
    tr.train_pass(data[0])
    assert tr.dense_opt.state_dict()["state"]


def _begin(eng, data):
    eng.begin_feed_pass()
    for ds in data:
        for blk in ds.get_blocks():
            eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()


def _leaves(params):
    return [np.asarray(x) for x in jax.tree.leaves(params)]


@pytest.mark.parametrize("pkg_name", ["jax", "torch"])
def test_resume_does_not_reseed_the_table(tmp_path, pkg_name):
    """Reference-side limit pinned in both packages (ROADMAP Queue 3):
    after resume, the first sync pull overwrites the restored params with
    the table's, which still holds the fresh trainer's init."""
    pkg = h.JAX if pkg_name == "jax" else h.TORCH
    Ckpt = JCheckpoint if pkg_name == "jax" else TrainCheckpoint
    Table = JTable if pkg_name == "jax" else AsyncDenseTable
    cfg, data = h.datasets(pkg, seed=5)
    # run A: one pass, then a checkpoint of its trained params
    eng, tr, _ = _trainer(pkg, data=(cfg, data[:2]))
    for ds in data[:2]:
        tr.train_pass(ds)
    eng.end_pass()
    ck = Ckpt(str(tmp_path / "ckpt"))
    ck.save(eng, tr)
    saved = (_leaves(tr.params) if pkg_name == "jax"
             else list(_params(tr).values()))
    # run B: a fresh trainer of the same seed resumes, then trains a pass
    eng_b, tr_b, _ = _trainer(pkg, data=(cfg, data[:2]))
    init = tr_b.async_dense.pull()
    eng_b.end_pass()
    ck.resume(eng_b, tr_b)
    restored = (_leaves(tr_b.params) if pkg_name == "jax"
                else list(_params(tr_b).values()))
    for a, b in zip(restored, saved):
        np.testing.assert_array_equal(a, b)
    _begin(eng_b, data[2:])
    pushed = []
    push = tr_b.async_dense.push
    tr_b.async_dense.push = lambda g: pushed.append(g) or push(g)
    tr_b.train_pass(data[2])
    replay = Table(init)
    for g in pushed:
        replay.push(g)
    want = replay.finalize()
    got = (tr_b.params if pkg_name == "jax"
           else {n: p.detach().numpy()
                 for n, p in tr_b.model.named_parameters()})
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)
    # the restored params are gone: a table seeded from them differs
    other = Table(jax.tree.unflatten(jax.tree.structure(init), restored)
                  if pkg_name == "jax"
                  else dict(zip(init, restored)))
    for g in pushed:
        other.push(g)
    assert any(not np.array_equal(a, b) for a, b in
               zip(_leaves(got), _leaves(other.finalize())))


def test_async_under_the_pass_prefetcher():
    """Two passes through PassPrefetcher: its worker packs while the
    table's thread applies grads; neither makes a device call, and the
    module ends each pass on the table's params."""
    from paddlebox_tpu_torch.data.prefetch import PassPrefetcher
    cfg, data = h.datasets(h.TORCH, seed=6, nb=4)
    eng = h.TORCH.Engine(h.TORCH.Table(embedding_dim=h.MF, shard_num=4,
                                       sgd=h.TORCH.Sgd(
                                           mf_create_thresholds=0.0)),
                         seed=7, device="cpu")
    tr = h.TORCH.Trainer(eng, DeepFM(h.S, 3 + h.MF, h.DENSE, hidden=(16, 16)),
                         cfg, batch_size=h.B, seed=3, device="cpu",
                         trainer_config=TrainerConfig(**ASYNC))
    with PassPrefetcher(eng, tr) as pre:
        for p in range(2):
            def load(p=p):
                ds = h.TORCH.Dataset(cfg)
                ds._blocks = [d.get_blocks()[0] for d in data[2 * p:2 * p + 2]]
                for blk in ds.get_blocks():
                    eng.add_keys(blk.all_keys())
                return ds
            pre.submit(load, tag=f"p{p}")
        for _ in range(2):
            stats = tr.train_pass(pre.next_pass())
            pre.end_pass()
            assert np.all(np.isfinite(stats["losses"]))
            final = tr.async_dense.pull()
            for n, v in _params(tr).items():
                np.testing.assert_array_equal(v, final[n], err_msg=n)
    assert tr.async_dense.pushed == tr.async_dense.applied == 4
    assert tr.async_dense.thread.is_alive()


def test_drained_pulls_equal_synchronous_adam(monkeypatch):
    """The table's Adam is torch's Adam up to rounding (torch applies the
    bias corrections in another order): with every pull waiting for the
    queue (no staleness), an async pass leaves the synchronous pass's
    losses and its params within rtol 1e-6 / atol 1e-9.  Without the
    wait the step trains on params one or more pushes behind, as the
    reference's does."""
    cfg, data = h.datasets(h.TORCH, seed=8, nb=4)
    eng = h.engine(h.TORCH, data)
    sync = h.TORCH.Trainer(eng, DeepFM(h.S, 3 + h.MF, h.DENSE,
                                       hidden=(16, 16)),
                           cfg, batch_size=h.B, seed=3, device="cpu")
    want = sync.train_pass(sync.build_pass_feed(_one_pass_dataset(h.TORCH,
                                                                  data)))
    plain = AsyncDenseTable.pull

    def waiting_pull(self):
        self.drain()
        return plain(self)
    monkeypatch.setattr(AsyncDenseTable, "pull", waiting_pull)
    eng2, tr, _ = _trainer(seed=8, data=(cfg, data))
    got = tr.train_pass(tr.build_pass_feed(_one_pass_dataset(h.TORCH, data)))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    for (n, a), b in zip(tr.model.named_parameters(), sync.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=n)
