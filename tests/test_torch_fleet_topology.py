"""``fleet.init(strategy, topology)`` in both packages: the fleet keeps the
topology, ``worker_num`` is its world size, and ``init_engine`` hands it
to the engine, whose trainer then resolves ``auto`` to mxu_sharded."""

import numpy as np
import jax

from paddlebox_tpu import fleet as jfleet
from paddlebox_tpu.config import EmbeddingTableConfig as JTable
from paddlebox_tpu.config import MeshConfig as JMesh
from paddlebox_tpu.parallel.topology import HybridTopology as JTopology
from paddlebox_tpu_torch import fleet as tfleet
from paddlebox_tpu_torch.config import EmbeddingTableConfig as TTable
from paddlebox_tpu_torch.config import MeshConfig as TMesh
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.parallel.topology import HybridTopology
from paddlebox_tpu_torch.trainer.trainer import SparseTrainer

import torch_parity_helpers as h


def test_fleet_init_with_topology_matches_jax(monkeypatch):
    monkeypatch.setitem(jfleet._GLOBAL, "fleet", None)
    monkeypatch.setitem(tfleet._GLOBAL, "fleet", None)
    jt = JTopology(JMesh(dp=2, sharding=4), jax.devices()[:8])
    tt = HybridTopology(TMesh(dp=2, sharding=4), device="cpu")
    jf = jfleet.init(None, jt)
    tf = tfleet.init(None, tt)
    assert tfleet.instance() is tf and tf.topology is tt
    assert tf.worker_num == jf.worker_num == 8
    jeng = jf.init_engine(JTable(embedding_dim=4))
    teng = tf.init_engine(TTable(embedding_dim=4))
    assert jeng.topology is jt and teng.topology is tt
    assert teng.device == tt.device       # the topology's device

    # with no topology: one worker in both
    assert tfleet.init().worker_num == jfleet.init().worker_num == 1
    assert tfleet.instance().init_engine(
        TTable(embedding_dim=4), device="cpu").topology is None


def test_fleet_engine_trains_sharded():
    """The engine fleet.init_engine built carries the topology into a
    pass: the trainer on it resolves auto to mxu_sharded and trains."""
    tt = HybridTopology(TMesh(dp=4), device="cpu")
    f = tfleet.Fleet(None, tt)
    eng = f.init_engine(TTable(embedding_dim=h.MF, sgd=h.TORCH.Sgd(
        mf_create_thresholds=1.0)), seed=7)
    cfg, data = h.datasets(h.TORCH)
    eng.begin_feed_pass()
    for ds in data:
        for blk in ds.get_blocks():
            eng.add_keys(blk.all_keys())
    eng.end_feed_pass()
    eng.begin_pass()
    tr = SparseTrainer(eng, DeepFM(h.S, 3 + h.MF, h.DENSE, hidden=(16,)),
                       cfg, batch_size=h.B, device="cpu", topology=tt)
    assert tr._resolve_path() == "mxu_sharded"
    stats = h.train_batches(tr, data)
    assert all(np.isfinite(s["loss"]) for s in stats)
