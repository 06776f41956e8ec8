"""The PyTorch port's SSD tier below the host table (counterpart of
test_ssd_table.py, run against ``paddlebox_tpu_torch``): the log-structured
shard file round-trip and compaction, and spill / fault-in of the tiered
table."""

import numpy as np

from paddlebox_tpu_torch.config import AccessorConfig, EmbeddingTableConfig
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.ps.ssd_table import SSDShard, SSDTieredTable


def make_host(dim=4):
    return ShardedHostTable(EmbeddingTableConfig(
        embedding_dim=dim, shard_num=2))


def test_ssd_shard_roundtrip(tmp_path):
    from paddlebox_tpu_torch.ps import feature_value as fv
    shard = SSDShard(str(tmp_path / "s.log"), mf_dim=4)
    keys = np.array([10, 20, 30], np.uint64)
    soa = fv.empty_soa(3, 4)
    soa["show"][:] = [1, 2, 3]
    soa["mf"][:] = np.arange(12).reshape(3, 4)
    shard.write_rows(keys, soa)
    out, found = shard.read_rows(np.array([20, 99, 10], np.uint64))
    assert found.tolist() == [True, False, True]
    np.testing.assert_allclose(out["show"], [2, 0, 1])
    np.testing.assert_allclose(out["mf"][0], [4, 5, 6, 7])
    # overwrite wins
    soa2 = fv.empty_soa(1, 4)
    soa2["show"][:] = [99]
    shard.write_rows(np.array([20], np.uint64), soa2)
    out, _ = shard.read_rows(np.array([20], np.uint64))
    assert out["show"][0] == 99
    # index rebuild from file
    shard2 = SSDShard(str(tmp_path / "s.log"), mf_dim=4)
    assert len(shard2) == 3
    out, _ = shard2.read_rows(np.array([20], np.uint64))
    assert out["show"][0] == 99


def test_ssd_shard_compact(tmp_path):
    from paddlebox_tpu_torch.ps import feature_value as fv
    shard = SSDShard(str(tmp_path / "c.log"), mf_dim=2)
    soa = fv.empty_soa(1, 2)
    for i in range(20):
        soa["show"][:] = [i]
        shard.write_rows(np.array([7], np.uint64), soa)  # 20 versions
    import os
    big = os.path.getsize(str(tmp_path / "c.log"))
    shard.compact()
    small = os.path.getsize(str(tmp_path / "c.log"))
    assert small < big
    out, found = shard.read_rows(np.array([7], np.uint64))
    assert found[0] and out["show"][0] == 19


def test_tiered_spill_and_fault_back(tmp_path):
    host = make_host()
    tiered = SSDTieredTable(host, str(tmp_path / "ssd"))
    keys = np.arange(1, 21, dtype=np.uint64)
    rows = host.bulk_pull(keys)
    rows["show"][:10] = 0.1    # cold: score 0.01
    rows["show"][10:] = 100.0  # hot
    host.bulk_write(keys, rows)
    spilled = tiered.spill(score_threshold=1.0)
    assert spilled == 10
    assert host.size() == 10
    assert tiered.total_size() == 20
    # pull a cold key: faulted back with its data
    back = tiered.bulk_pull(np.array([3, 15], np.uint64))
    np.testing.assert_allclose(back["show"], [0.1, 100.0])
    assert host.size() == 11  # key 3 promoted
    # SSD no longer holds key 3
    sid = host._shard_ids(np.array([3], np.uint64))[0]
    assert 3 not in tiered.shards[sid].index


def test_ssd_fault_in_pooled_matches_sequential(tmp_path):
    """Spill + batched fault-in through the table pool vs sequentially:
    same promoted rows, same values, same residency split (counterpart
    of test_host_table_pool.py's test of the same name)."""
    from paddlebox_tpu_torch import flags
    from paddlebox_tpu_torch.utils import workpool

    def run(threads, sub):
        flags.set_flags({"ps_table_threads": threads})
        assert workpool.table_pool().threads == threads
        host = ShardedHostTable(EmbeddingTableConfig(
            embedding_dim=4, shard_num=8, accessor=AccessorConfig()),
            seed=7)
        tiered = SSDTieredTable(host, str(tmp_path / sub))
        keys = np.arange(1, 2001, dtype=np.uint64)
        rows = host.bulk_pull(keys)
        rows["show"][:1000] = 0.1
        rows["show"][1000:] = 100.0
        host.bulk_write(keys, rows)
        spilled = tiered.spill(score_threshold=1.0)
        pull = tiered.bulk_pull(np.arange(1, 2001, 7, dtype=np.uint64))
        return spilled, host.size(), tiered.total_size(), pull

    before = flags.get_flags("ps_table_threads")
    try:
        s1, h1, t1, p1 = run(1, "seq")
        s4, h4, t4, p4 = run(4, "par")
    finally:
        flags.set_flags({"ps_table_threads": before})
    assert (s1, h1, t1) == (s4, h4, t4)
    for f in p1:
        np.testing.assert_array_equal(p1[f], p4[f], err_msg=f)
