"""The port's serving tier against the JAX package's, over the wire.

One xbox dump (written by the port) is served by a replica of each
package.  A JAX ``ServingRouter`` querying the port's replica, and a port
router querying the JAX replica, must get the answers each package's
router gets from its own replica, bit for bit, for ``pull_sparse`` (hits
and seeded default rows for misses) and ``forward`` (the f64
prefix-sum pool).  A sharded port fleet behind a JAX router in
``shard_groups`` mode answers like the full-table replicas too.  Then
``python -m paddlebox_tpu_torch.serve`` runs as a process: it announces
its address, answers a query and exits 0 on SIGINT.
"""

import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from paddlebox_tpu.config import EmbeddingTableConfig as JCfg
from paddlebox_tpu.ps import serving as jsrv
from paddlebox_tpu_torch.config import EmbeddingTableConfig as TCfg
from paddlebox_tpu_torch.io.checkpoint import save_xbox
from paddlebox_tpu_torch.ps import serving as tsrv
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable

MF = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Eng:
    def __init__(self, cfg, table):
        self.config, self.table = cfg, table


def _dump(path, n=300, seed=0):
    """A dump of ``n`` rows that clear the base threshold; → its keys."""
    cfg = TCfg(embedding_dim=MF)
    tab = ShardedHostTable(cfg, seed=0)
    rng = np.random.default_rng(seed)
    keys = rng.choice(2 ** 40, n, replace=False).astype(np.uint64)
    rows = tab.bulk_pull(keys)
    rows["show"] = rows["show"] + 20.0
    rows["click"] = rows["click"] + 5.0
    rows["mf_size"][:] = MF
    rows["mf"][:] = rng.standard_normal(rows["mf"].shape).astype(np.float32)
    tab.bulk_write(keys, rows)
    save_xbox(_Eng(cfg, tab), path)
    return keys


def _query(keys, seed=1):
    rng = np.random.default_rng(seed)
    misses = rng.choice(2 ** 39, 60, replace=False).astype(np.uint64)
    q = np.concatenate([keys[:200], misses])
    rng.shuffle(q)
    lod = np.concatenate([[0], np.cumsum(rng.integers(0, 5, 80))])
    lod = np.minimum(lod, len(q)).astype(np.int64)
    return q, lod


def _assert_rows_equal(a, b):
    assert set(a) == set(b)
    for f in a:
        np.testing.assert_array_equal(np.asarray(a[f]), np.asarray(b[f]),
                                      err_msg=f)


@pytest.fixture()
def replicas(tmp_path):
    path = str(tmp_path / "day1.xbox")
    keys = _dump(path)
    jrep = jsrv.ServingReplica(config=JCfg(embedding_dim=MF),
                               xbox_path=path, tenants=["ads"])
    trep = tsrv.ServingReplica(config=TCfg(embedding_dim=MF),
                               xbox_path=path, tenants=["ads"])
    yield keys, jrep, trep
    jrep.shutdown(drain_timeout=2.0)
    trep.shutdown(drain_timeout=2.0)


@pytest.mark.parametrize("router_pkg", ["jax", "torch"])
def test_each_router_gets_the_same_answers_from_either_replica(
        replicas, router_pkg):
    keys, jrep, trep = replicas
    Router = (jsrv if router_pkg == "jax" else tsrv).ServingRouter
    q, lod = _query(keys)
    to_j = Router([jrep.addr], tenant="ads")
    to_t = Router([trep.addr], tenant="ads")
    try:
        _assert_rows_equal(to_t.pull_sparse(q), to_j.pull_sparse(q))
        np.testing.assert_array_equal(to_t.forward(q, lod),
                                      to_j.forward(q, lod))
        # the answers are the frozen table's rows and its pool
        frozen = trep._gen.tables["ads/embedding"]
        _assert_rows_equal(to_t.pull_sparse(q), frozen.lookup_rows(q))
        np.testing.assert_array_equal(
            to_t.forward(q, lod),
            tsrv._pool_rows(frozen.lookup_rows(q), lod))
    finally:
        to_j.close()
        to_t.close()


def test_a_jax_router_over_a_sharded_port_fleet(replicas, tmp_path):
    keys, jrep, _ = replicas
    path = str(tmp_path / "day1.xbox")
    fleet = [tsrv.ServingReplica(config=TCfg(embedding_dim=MF),
                                 xbox_path=path, tenants=["ads"], shard=s,
                                 n_shards=4) for s in range(4)]
    fan = jsrv.ServingRouter(shard_groups=[[r.addr] for r in fleet],
                             tenant="ads")
    solo = jsrv.ServingRouter([jrep.addr], tenant="ads")
    try:
        q, lod = _query(keys, seed=5)
        _assert_rows_equal(fan.pull_sparse(q), solo.pull_sparse(q))
        np.testing.assert_array_equal(fan.forward(q, lod),
                                      solo.forward(q, lod))
    finally:
        fan.close()
        solo.close()
        for r in fleet:
            r.shutdown(drain_timeout=2.0)


def test_serve_entry_point_announces_answers_and_exits_on_sigint(tmp_path):
    path = str(tmp_path / "day1.xbox")
    keys = _dump(path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.serve", "--xbox", path,
         "--port", "0", "--mf_dim", str(MF), "--tenants", "ads,feed",
         "--timeline_s", "0.2"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stderr.readline()
        m = re.search(r"replica ([\d.]+):(\d+) shard=0/1 generation=1 "
                      r"tenants=ads,feed dump=", line)
        assert m, line
        router = tsrv.ServingRouter([(m.group(1), int(m.group(2)))],
                                    tenant="feed")
        try:
            got = router.pull_sparse(keys[:20])
            assert np.all(got["show"] >= 20.0)
            assert router.health()[0]["tenants"] == "ads,feed"
        finally:
            router.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
