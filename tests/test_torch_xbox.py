"""The port's xbox half of ``io/checkpoint.py`` against the JAX package's.

The same table rows (numpy seed) sit in one host table of each package.
``save_xbox`` must write the same bytes in both, with the native TSV
writer and with the per-row Python writer, for base and delta dumps
(the accessor's thresholds) and with ``quant_bits``.  The PS server's
``dump_xbox`` verb over a 4-shard ``PSFleet`` must dump the rows of the
local dump.  ``load_xbox`` must give the same verdict and the same row
number on malformed and non-finite lines in both packages and with both
parsers, dedupe last-wins, derive ``mf_size`` from the dumped ``mf``,
and read a dump written by either package into equal tables.  The swap
manifest written by one package reads back in the other.  All exact:
the dump is text, so equal bytes or equal float32 values.
"""

import os
import re

import numpy as np
import pytest

from paddlebox_tpu.config import AccessorConfig as JAcc
from paddlebox_tpu.config import EmbeddingTableConfig as JCfg
from paddlebox_tpu.io import checkpoint as jck
from paddlebox_tpu.native import dump_writer as jdw
from paddlebox_tpu.ps.host_table import ShardedHostTable as JTable
from paddlebox_tpu_torch.config import AccessorConfig as TAcc
from paddlebox_tpu_torch.config import EmbeddingTableConfig as TCfg
from paddlebox_tpu_torch.io import checkpoint as tck
from paddlebox_tpu_torch.launch import PSFleet
from paddlebox_tpu_torch.native import dump_writer as tdw
from paddlebox_tpu_torch.ps.host_table import ShardedHostTable as TTable
from paddlebox_tpu_torch.ps.pass_manager import BoxPSEngine
from paddlebox_tpu_torch.ps.service import PSClient, RemoteTableAdapter

MF = 4
N = 400


class _Eng:
    """What save_xbox / load_xbox read of an engine."""

    def __init__(self, config, table, mode="serving"):
        self.config, self.table, self.mode = config, table, mode
        self.cache = None


def _cfgs(quant_bits=0):
    acc = dict(base_threshold=1.5, delta_threshold=0.25)
    return (JCfg(embedding_dim=MF, shard_num=4, quant_bits=quant_bits,
                 accessor=JAcc(**acc)),
            TCfg(embedding_dim=MF, shard_num=4, quant_bits=quant_bits,
                 accessor=TAcc(**acc)))


def _rows(table, keys, seed=0):
    """Trained-shaped rows: some below the base threshold, some with a
    small delta score, some uncreated (their mf dumps as zeros)."""
    rng = np.random.default_rng(seed)
    rows = table.bulk_pull(keys)
    n = len(keys)
    rows["show"] = rng.integers(0, 40, n).astype(rows["show"].dtype)
    rows["click"] = np.minimum(rng.integers(0, 8, n),
                               rows["show"]).astype(rows["click"].dtype)
    rows["embed_w"] = rng.normal(0, 0.3, n).astype(np.float32)
    rows["delta_score"] = rng.normal(0, 0.5, n).astype(np.float32)
    rows["mf_size"] = np.where(rng.random(n) < 0.8, MF, 0).astype(
        rows["mf_size"].dtype)
    rows["mf"] = rng.normal(0, 0.2, (n, MF)).astype(np.float32)
    return rows


def _both_tables(quant_bits=0, seed=0):
    jcfg, tcfg = _cfgs(quant_bits)
    keys = np.random.default_rng(seed).choice(
        2 ** 40, N, replace=False).astype(np.uint64)
    jt, tt = JTable(jcfg, seed=0), TTable(tcfg, seed=0)
    rows = _rows(jt, keys, seed)
    jt.bulk_write(keys, rows)
    tt.bulk_write(keys, {f: v.copy() for f, v in rows.items()})
    return _Eng(jcfg, jt), _Eng(tcfg, tt), keys


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(params=["native", "python"])
def writer(request, monkeypatch):
    """Run a test with the native dump writer and parser, or with both
    packages forced onto the per-row Python writer and parser."""
    if request.param == "native":
        assert jdw.available() and tdw.available()
    else:
        for mod in (jdw, tdw):
            monkeypatch.setattr(mod, "available", lambda: False)
            monkeypatch.setattr(mod, "load_rows", lambda path, d: None)
    return request.param


@pytest.mark.parametrize("base,quant_bits", [
    (True, 0), (False, 0), (True, 8), (False, 16)])
def test_save_xbox_same_bytes_in_both_packages(tmp_path, writer, base,
                                               quant_bits):
    je, te, _ = _both_tables(quant_bits)
    jp, tp = str(tmp_path / "j.xbox"), str(tmp_path / "t.xbox")
    nj = jck.save_xbox(je, jp, base=base)
    nt = tck.save_xbox(te, tp, base=base)
    assert nj == nt and 0 < nt < N          # the thresholds filtered some
    assert _read(jp) == _read(tp)
    assert not os.path.exists(tp + ".tmp")


def test_native_and_python_writers_give_the_same_bytes(tmp_path,
                                                       monkeypatch):
    _, te, _ = _both_tables(quant_bits=8)
    native = str(tmp_path / "native.xbox")
    tck.save_xbox(te, native)
    monkeypatch.setattr(tdw, "available", lambda: False)
    python = str(tmp_path / "python.xbox")
    tck.save_xbox(te, python)
    assert _read(native) == _read(python)


def _parse(path):
    """{key: line} of a dump."""
    out = {}
    for line in _read(path).decode().splitlines():
        out[int(line.split("\t", 1)[0])] = line
    return out


def test_dump_xbox_verb_over_a_4_shard_fleet_equals_the_local_dump(
        tmp_path):
    """``save_xbox`` through a remote table asks every shard's server to
    dump its own rows (the ``dump_xbox`` verb) and concatenates the
    parts: the same lines as the local table's dump, in shard order."""
    _, te, keys = _both_tables()
    flt = PSFleet(4, config=te.config, seed=0)
    client = PSClient(flt.addrs)
    try:
        rows = te.table.bulk_pull(keys)
        client.push_sparse(keys, rows)
        remote = str(tmp_path / "remote.xbox")
        n = tck.save_xbox(_Eng(te.config, RemoteTableAdapter(client)),
                          remote)
        local = str(tmp_path / "local.xbox")
        assert n == tck.save_xbox(te, local)
        assert _parse(remote) == _parse(local)
        assert not [f for f in os.listdir(tmp_path) if ".shard-" in f]
    finally:
        client.close()
        flt.stop()


def _line_of(exc) -> int:
    return int(re.search(r"malformed xbox line (\d+)", str(exc)).group(1))


_GOOD = "7\t3\t1\t0.5\t0.1 0.2 0.3 0.4\n"


@pytest.mark.parametrize("bad,row", [
    ("9\t3\t1\t0.5\n", 2),                            # too few fields
    ("9\t3\t1\t0.5\t0.1 0.2 0.3\n", 2),               # mf width 3
    ("x9\t3\t1\t0.5\t0.1 0.2 0.3 0.4\n", 2),          # key not a number
    ("-9\t3\t1\t0.5\t0.1 0.2 0.3 0.4\n", 2),          # negative key
    ("18446744073709551616\t3\t1\t0.5\t0 0 0 0\n", 2),  # key > uint64
    ("9\tnan\t1\t0.5\t0.1 0.2 0.3 0.4\n", 2),         # non-finite show
    ("9\t3\t1\t0.5\t0.1 inf 0.3 0.4\n", 2),           # non-finite mf
    ("9\t3\t1\t0.5\t0.1 1e39 0.3 0.4\n", 2),          # mf overflows f32
    ("\n9\t3\t1\t0.5\t0.1 0.2 0.3\n", 2),             # blank line skipped
])
def test_load_xbox_same_verdict_and_row_in_both_packages(
        tmp_path, writer, bad, row):
    path = str(tmp_path / "bad.xbox")
    with open(path, "w") as f:
        f.write(_GOOD + bad + _GOOD.replace("7", "8", 1))
    jcfg, tcfg = _cfgs()
    with pytest.raises(ValueError, match="malformed xbox line") as je:
        jck.load_xbox(_Eng(jcfg, JTable(jcfg)), path)
    with pytest.raises(ValueError, match="malformed xbox line") as te:
        tck.load_xbox(_Eng(tcfg, TTable(tcfg)), path)
    assert _line_of(je.value) == _line_of(te.value) == row
    assert type(je.value) is type(te.value)


def _load_state(load, eng, path):
    keys = load(eng, path)
    return keys, eng.table.bulk_pull(np.sort(keys))


@pytest.mark.parametrize("dumper", ["jax", "torch"])
def test_a_dump_of_either_package_loads_equal_in_both(tmp_path, writer,
                                                      dumper):
    """A base dump with a delta appended (keys repeat: last wins) reads
    into equal tables in both packages: show / click / embed_w / mf as
    dumped, ``mf_size`` from any(mf != 0), every other field zero."""
    je, te, keys = _both_tables(seed=3)
    path = str(tmp_path / "d.xbox")
    save = jck.save_xbox if dumper == "jax" else tck.save_xbox
    save(je if dumper == "jax" else te, path, base=True)
    rows = te.table.bulk_pull(keys[:50])
    rows["embed_w"] = rows["embed_w"] + np.float32(7.0)
    rows["show"] = rows["show"] + 30.0
    te.table.bulk_write(keys[:50], rows)
    delta = str(tmp_path / "delta.xbox")
    tck.save_xbox(te, delta, base=True)
    with open(path, "ab") as f:
        f.write(_read(delta))
    jcfg, tcfg = _cfgs()
    jk, js = _load_state(jck.load_xbox, _Eng(jcfg, JTable(jcfg)), path)
    tk, ts = _load_state(tck.load_xbox, _Eng(tcfg, TTable(tcfg)), path)
    np.testing.assert_array_equal(np.sort(jk), np.sort(tk))
    assert set(js) == set(ts)
    for f in js:
        np.testing.assert_array_equal(js[f], ts[f], err_msg=f)
    lines = _parse(path)                      # the dict keeps the last
    for i, k in enumerate(np.sort(tk)):
        vals = lines[int(k)].split("\t")
        assert ts["embed_w"][i] == np.float32(float(vals[3]))
        mf = np.array(vals[4].split(), np.float32)
        np.testing.assert_array_equal(ts["mf"][i], mf)
        assert ts["mf_size"][i] == (MF if mf.any() else 0)
    assert not ts["embed_g2sum"].any() and not ts["delta_score"].any()


def test_load_xbox_into_a_serving_engine_and_warning_on_a_training_one(
        tmp_path):
    """``BoxPSEngine(mode="serving")`` loads a dump quietly; a training
    engine gets the JAX package's warning (mf_size cannot round-trip);
    any other mode is refused."""
    _, te, keys = _both_tables()
    path = str(tmp_path / "d.xbox")
    n = tck.save_xbox(te, path)
    eng = BoxPSEngine(te.config, device="cpu", mode="serving")
    assert eng.mode == "serving"
    assert len(tck.load_xbox(eng, path)) == n
    with pytest.warns(UserWarning, match="training-mode engine"):
        tck.load_xbox(BoxPSEngine(te.config, device="cpu"), path)
    with pytest.raises(ValueError, match="'train' or 'serving'"):
        BoxPSEngine(te.config, device="cpu", mode="predict")


def test_empty_dump_still_creates_the_file(tmp_path, writer):
    jcfg, tcfg = _cfgs()
    for save, cfg, table in ((jck.save_xbox, jcfg, JTable(jcfg)),
                             (tck.save_xbox, tcfg, TTable(tcfg))):
        path = str(tmp_path / f"{cfg.__module__.split('.')[0]}.xbox")
        assert save(_Eng(cfg, table), path) == 0
        assert _read(path) == b""


def test_manifest_round_trip_across_packages(tmp_path):
    root = str(tmp_path / "man")
    assert tck.read_xbox_manifest(root) is None
    tck.publish_xbox_manifest(root, "/d/xbox-1", generation=3, day="d1")
    got = jck.read_xbox_manifest(root)
    assert (got["generation"], got["path"], got["day"]) == \
        (3, "/d/xbox-1", "d1")
    jck.publish_xbox_manifest(root, "/d/xbox-2", generation=4, day="d2")
    got = tck.read_xbox_manifest(root)
    assert (got["generation"], got["path"], got["day"]) == \
        (4, "/d/xbox-2", "d2")
    with open(os.path.join(root, tck.XBOX_MANIFEST), "w") as f:
        f.write('{"path": "/d"}')
    with pytest.raises(ValueError, match="malformed xbox manifest"):
        tck.read_xbox_manifest(root)
