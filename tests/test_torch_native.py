"""The native host library of the PyTorch port (paddlebox_tpu_torch/native):
counterparts of the JAX package's tests/test_native.py, on the CPU.

* The native MultiSlot parser gives the Python parser's block bit for
  bit (uint64 feasigns up to 2^64 − 1, float values, ins_id / logkey),
  and the JAX package's Python parser's; a bad record is a parse error.
* The key hash: insertion rows, lookups, growth, and the threaded
  ``find_rows1_i32``.
* ``PassKeyMapper`` gives the same rows through the native hash as
  through the binary search, and says which one ran; the host table
  and the mapper give the all-ones key its own row.
* ``make_parser`` / ``DataFeed`` pick the native parser unless told not
  to, and two processes building the library at once into one
  directory leave one whole library.

No test asserts a speed.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from paddlebox_tpu.config import DataFeedConfig as JFeed
from paddlebox_tpu.config import SlotConfig as JSlot
from paddlebox_tpu.data.data_feed import SlotParser as JSlotParser
from paddlebox_tpu_torch.config import (DataFeedConfig, EmbeddingTableConfig,
                                        SlotConfig, SparseSGDConfig)
from paddlebox_tpu_torch.data import data_feed
from paddlebox_tpu_torch.data.data_feed import DataFeed, SlotParser
from paddlebox_tpu_torch.native import build, hash_map
from paddlebox_tpu_torch.native import slot_parser as native
from paddlebox_tpu_torch.ps.embedding import PassKeyMapper
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable
from paddlebox_tpu_torch.utils.monitor import StatRegistry, stat_get

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = [
    "1 1 2 11 12 1 21",
    "1 0 1 13 2 22 18446744073709551615",  # max uint64 feasign
    "1 1 3 14 15 16 1 24",
]


@pytest.fixture(autouse=True)
def _clean():
    StatRegistry.instance().reset()
    yield


def make_config(pkg_feed=DataFeedConfig, pkg_slot=SlotConfig):
    return pkg_feed(slots=(
        pkg_slot("label", dtype="float", is_dense=True, dim=1),
        pkg_slot("a", capacity=3),
        pkg_slot("b", capacity=2),
    ))


def assert_same_block(got, want):
    assert got.n == want.n
    for kind in ("uint64_slots", "float_slots"):
        g, w = getattr(got, kind), getattr(want, kind)
        assert set(g) == set(w), kind
        for name in w:
            for x, y in zip(g[name], w[name]):
                assert x.dtype == y.dtype, (kind, name)
                np.testing.assert_array_equal(x, y, err_msg=name)
    for field in ("ins_ids", "search_ids", "cmatch", "rank"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
        elif isinstance(w, list):
            assert g == w, field
        else:
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)


def random_lines(rng, n):
    lines = []
    for _ in range(n):
        parts = [f"1 {rng.integers(0, 2)}"]
        for cap in (3, 2):
            k = rng.integers(1, cap + 1)
            parts.append(f"{k} " + " ".join(
                str(v) for v in rng.integers(1, 2**63, k, dtype=np.uint64)
                * np.uint64(2) + np.uint64(1)))
        lines.append(" ".join(parts))
    return lines


def test_library_builds_and_loads():
    assert native.available() and hash_map.available()
    assert build.lib_path().startswith(os.path.join(REPO, "build", "native"))


def test_native_matches_python_parser_bitwise():
    cfg = make_config()
    lines = LINES + random_lines(np.random.default_rng(0), 500)
    got = native.NativeSlotParser(cfg).parse_block(lines)
    assert_same_block(got, SlotParser(cfg).parse_block(lines))
    jwant = JSlotParser(make_config(JFeed, JSlot)).parse_block(lines)
    for name in ("a", "b"):
        for x, y in zip(got.uint64_slots[name], jwant.uint64_slots[name]):
            np.testing.assert_array_equal(x, y)
    assert got.uint64_slots["b"][0][2] == np.uint64(2**64 - 1)


def test_native_ins_id_logkey_match_python():
    cfg = DataFeedConfig(slots=(SlotConfig("s", capacity=1),))
    cases = {(True, True): ["1 insA 1 abc0102 1 42", "1 insB 1 def0304 1 43"],
             (True, False): ["1 insA 1 42", "1 insB 1 43"],
             (False, True): ["1 abc0102 1 42", "1 def0304 1 43"]}
    for (ins_id, logkey), lines in cases.items():
        got = native.NativeSlotParser(cfg, ins_id, logkey).parse_block(lines)
        want = SlotParser(cfg, ins_id, logkey).parse_block(lines)
        assert_same_block(got, want)
    block = native.NativeSlotParser(cfg, True, True).parse_block(
        cases[(True, True)])
    assert block.ins_ids == ["insA", "insB"]
    assert int(block.search_ids[0]) == 0xabc
    assert int(block.cmatch[1]) == 3 and int(block.rank[1]) == 4


def test_native_parse_error_status():
    cfg = make_config()
    with pytest.raises(ValueError, match="status=3"):
        native.NativeSlotParser(cfg).parse_block(["1 1 0"])  # zero count
    with pytest.raises(ValueError, match="status=1"):
        native.NativeSlotParser(cfg, parse_ins_id=True).parse_block(
            ["2 a b 1 1 1 5 1 6"])


@pytest.mark.parametrize("fmt", ["{:.6g}", "{:.4f}", "{:.9e}", "{!r}"])
def test_native_float_values_bitwise(fmt):
    """strtof in C and numpy's string→float32 give the same bits on the
    forms the feeds write (%.6g dense values and friends)."""
    cfg = DataFeedConfig(slots=(
        SlotConfig("d", dtype="float", is_dense=True, dim=3),))
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.normal(0, 1, 3000),
                           rng.normal(0, 1e4, 3000),
                           [0.5, -1.25, 300.0, 1, 2, 3]])
    lines = ["3 " + " ".join(fmt.format(float(v)) for v in row)
             for row in vals.reshape(-1, 3)]
    got = native.NativeSlotParser(cfg).parse_block(lines)
    assert_same_block(got, SlotParser(cfg).parse_block(lines))
    np.testing.assert_allclose(got.float_slots["d"][0][-6:],
                               [0.5, -1.25, 300.0, 1, 2, 3])


def test_hash_rows_lookups_and_key_order():
    h = hash_map.NativeKeyHash(4)
    keys = np.array([5, 7, 5, 99, 2**63, 7], np.uint64)
    assert h.upsert(keys).tolist() == [0, 1, 0, 2, 3, 1]
    assert len(h) == 4
    assert h.find(np.array([99, 123, 2**63], np.uint64)).tolist() \
        == [2, -1, 3]
    np.testing.assert_array_equal(
        h.keys_by_row(), np.array([5, 7, 99, 2**63], np.uint64))
    np.testing.assert_array_equal(
        h.find_rows1_i32(np.array([0, 5, 123, 99], np.uint64)),
        [0, 1, 0, 3])


def test_hash_growth():
    h = hash_map.NativeKeyHash(4)
    rng = np.random.default_rng(0)
    keys = rng.integers(1, 2**63, size=50000).astype(np.uint64)
    rows = h.upsert(keys)
    uniq = np.unique(keys)
    assert len(h) == len(uniq)
    assert (h.find(uniq) >= 0).all()
    np.testing.assert_array_equal(h.find(keys), rows)
    # threaded probes (above 2^16 keys) = the single-thread answer
    probe = np.concatenate([keys, keys, np.zeros(5, np.uint64)])
    np.testing.assert_array_equal(h.find_rows1_i32(probe, n_threads=4),
                                  h.find_rows1_i32(probe, n_threads=1))


def test_hash_all_ones_key_has_its_own_row():
    """2^64 − 1 is the slot array's empty marker; it is still a key with
    its own row, and the keys inserted after it keep the insertion rows."""
    top = np.uint64(2**64 - 1)
    h = hash_map.NativeKeyHash(4)
    keys = np.array([5, top, 7, top, 9], np.uint64)
    assert h.upsert(keys).tolist() == [0, 1, 2, 1, 3]
    more = np.arange(10, 5000, dtype=np.uint64)       # grows the slots
    np.testing.assert_array_equal(h.upsert(more), np.arange(4, 4 + len(more)))
    assert len(h) == 4 + len(more)
    assert h.find(np.array([top, 7, 123456], np.uint64)).tolist() \
        == [1, 2, -1]
    assert h.keys_by_row()[1] == top
    probe = np.concatenate([np.full(70_000, top), np.zeros(3, np.uint64)])
    for threads in (1, 4):
        got = h.find_rows1_i32(probe, n_threads=threads)
        assert (got[:-3] == 2).all() and (got[-3:] == 0).all()
    assert (hash_map.NativeKeyHash(4).find(np.array([top], np.uint64))
            == -1).all()


def sorted_only(monkeypatch):
    monkeypatch.setattr(hash_map, "available", lambda: False)


def test_pass_key_mapper_native_equals_sorted(monkeypatch):
    rng = np.random.default_rng(4)
    sorted_keys = np.unique(rng.integers(1, 2**40, 20_000).astype(np.uint64))
    probe = np.concatenate([rng.choice(sorted_keys, 90_000),
                            rng.integers(1, 2**40, 10_000).astype(np.uint64),
                            np.zeros(7, np.uint64)])
    got = PassKeyMapper(sorted_keys)(probe)
    small = PassKeyMapper(sorted_keys)(probe[:1000])   # one thread
    assert stat_get("ps.mapper.native_rows") == len(probe) + 1000
    assert stat_get("ps.mapper.sorted_rows") == 0
    sorted_only(monkeypatch)
    want = PassKeyMapper(sorted_keys)(probe)
    assert stat_get("ps.mapper.sorted_rows") == len(probe)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(small, want[:1000])
    assert (want[-7:] == 0).all()


def all_ones_run():
    """Host table writes and pulls, and a pass mapper, over keys that
    hold the all-ones feasign among others written before and after."""
    cfg = EmbeddingTableConfig(embedding_dim=4, shard_num=4,
                               sgd=SparseSGDConfig(mf_create_thresholds=0.0))
    table = ShardedHostTable(cfg, seed=5)
    top = np.uint64(2**64 - 1)
    rng = np.random.default_rng(6)
    out = []
    for step in range(3):
        keys = rng.integers(1, 2**63, 3000, dtype=np.uint64)
        if step == 1:
            keys = np.concatenate([keys, [top]])
        keys = np.unique(keys)
        rows = table.bulk_pull(keys)
        rows["show"] = rows["show"] + np.arange(len(keys), dtype=np.float32)
        table.bulk_write(keys, rows)
        out.append(table.bulk_pull(np.sort(table.export_keys())))
    sorted_keys = np.sort(table.export_keys())
    assert sorted_keys[-1] == top
    probe = np.concatenate([rng.choice(sorted_keys, 70_000),
                            np.array([top, 0], np.uint64)])
    out.append({"rows": PassKeyMapper(sorted_keys)(probe)})
    return out


def test_all_ones_key_native_equals_sorted(monkeypatch):
    """The host table gives 2^64 − 1 its own row and the keys written
    after it theirs, and the pass mapper maps it as the binary search
    does, through the native hash or without it."""
    native_out = all_ones_run()
    assert stat_get("ps.mapper.native_rows") > 0
    sorted_only(monkeypatch)
    sorted_out = all_ones_run()
    for a, b in zip(native_out, sorted_out):
        assert set(a) == set(b)
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    rows = native_out[-1]["rows"]
    assert rows[-2] == len(native_out[-2]["show"]) and rows[-1] == 0
    # the last key of step 1's 3,001 kept the show it was written with
    assert native_out[-2]["show"][-1] == 3000


def test_make_parser_and_feed_pick_the_native_parser(tmp_path):
    cfg = make_config()
    assert isinstance(data_feed.make_parser(cfg), native.NativeSlotParser)
    assert isinstance(data_feed.make_parser(cfg, use_native=False),
                      SlotParser)
    path = tmp_path / "part-0.txt"
    lines = random_lines(np.random.default_rng(2), 3000)
    path.write_text("\n".join(lines) + "\n")
    nat = DataFeed(cfg, chunk_lines=1024)
    py = DataFeed(cfg, chunk_lines=1024, use_native=False)
    assert isinstance(nat._parser, native.NativeSlotParser)
    got, want = list(nat.read_file(str(path))), list(py.read_file(str(path)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same_block(g, w)


def test_two_processes_build_one_library(tmp_path):
    """Two processes build a copy of the package at once, each into the
    copy's empty build/native/: each gets a loadable library, and one
    whole file is left, no temporary."""
    shutil.copytree(os.path.join(REPO, "paddlebox_tpu_torch"),
                    tmp_path / "paddlebox_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import ctypes\n"
            "from paddlebox_tpu_torch.native import build\n"
            "ok = build.ensure_built(quiet=False)\n"
            "ctypes.CDLL(build.lib_path())\n"
            "print(ok, build.lib_path())\n")
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[0] == "True"
    paths = {out.split()[1] for out, _ in outs}
    assert len(paths) == 1
    lib = paths.pop()
    assert os.path.dirname(lib) == str(tmp_path / "build" / "native")
    assert os.listdir(os.path.dirname(lib)) == [os.path.basename(lib)]


def test_without_a_compiler_the_python_paths_run(tmp_path):
    """No g++: the library reports unavailable once, and the parser and
    the mapper take their Python paths."""
    shutil.copytree(os.path.join(REPO, "paddlebox_tpu_torch"),
                    tmp_path / "paddlebox_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import numpy as np\n"
        "from paddlebox_tpu_torch.native import build, hash_map\n"
        "build.CXX = 'no-such-compiler'\n"
        "from paddlebox_tpu_torch.config import *\n"
        "from paddlebox_tpu_torch.data.data_feed import SlotParser, "
        "make_parser\n"
        "from paddlebox_tpu_torch.ps.embedding import PassKeyMapper\n"
        "from paddlebox_tpu_torch.ps.host_table import ShardedHostTable\n"
        "from paddlebox_tpu_torch.utils.monitor import stat_get\n"
        "cfg = DataFeedConfig(slots=(SlotConfig('a', capacity=3),))\n"
        "assert type(make_parser(cfg)) is SlotParser\n"
        "t = ShardedHostTable(EmbeddingTableConfig(embedding_dim=4), 0)\n"
        "k = np.arange(1, 3000, dtype=np.uint64)\n"
        "t.bulk_write(k, t.bulk_pull(k)); t.bulk_pull(k)\n"
        "m = PassKeyMapper(k)(np.tile(k, 30))\n"
        "assert (m[:len(k)] == np.arange(1, len(k) + 1)).all()\n"
        "assert stat_get('ps.mapper.native_rows') == 0\n"
        "assert stat_get('ps.mapper.sorted_rows') == 30 * len(k)\n"
        "assert not hash_map.available()\n"
        "print('fallback ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": str(tmp_path)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "fallback ok"
    assert not (tmp_path / "build" / "native").exists() or \
        not os.listdir(tmp_path / "build" / "native")
