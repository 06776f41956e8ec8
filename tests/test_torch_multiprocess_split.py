"""The table split across processes: two ranks under ``python -m
paddlebox_tpu_torch.launch --nproc_per_node 2`` (``tests/
torch_split_worker.py``, which imports the port only, on
``device="cpu"``), one dp coordinate a rank over the launcher's gloo
group, each holding its own row blocks of the working set.

Runs: (m) ``auto`` on dp 2, which resolves to ``mxu_sharded`` on the
flat layout; (n) explicit ``mxu``, (p) ``reference`` and (q) ``fast`` on
dp 2; (o) ``auto`` on dp 2 × mp 2 under adagrad, which resolves to
``fast``; (r) explicit ``mxu``, (s) ``fast`` and (t) ``reference`` on dp
2 × sharding 4, the multi-node layout, where each rank holds a whole
replica and reads and steps its own.  Each trains a streaming and a
packed pass, then ``end_pass``;
(m) and (o) also train a two-pass day through ``fleet.train_passes``
((o) through the pass prefetcher).  The configuration is
``tests/test_torch_multicard.py``'s (4 slots × capacity 3, mf_dim 4, 3
dense, DeepFM (16,), batch 64, three batches), from the JAX trainer's
dense init.

The ranks must be bit-equal to each other (losses, AUC, the working set
joined over the group, dense params, the host table after ``end_pass``
and after the day) and to the same mesh in one process with one device
a dp row (the worker's functions with no group: the "halves" layout),
since every sum is folded in that process's order.  Against the JAX
package's same lowering on the same mesh over its virtual CPU devices
they hold ``tests/test_torch_multicard_paths.py``'s tolerances: the pass
loss rtol 1e-4; the working set and the dense params rtol 1e-5 / atol
1e-6; integer fields equal.  The five collectives that send each rank
only its own parts are held bitwise against the one-process list ops,
and ``Sharded.locate`` / ``gather_rows`` against the placed tensor on a
rank whose first block does not start at row 0.  ``pull_sparse`` reads
every row on each rank, its own replica on the multi-node layout, the
other rank's rows over the group where the rows are split across
processes.  One spawn serves every test of the file.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_multicard as mc
import test_torch_multiprocess as mp
import test_torch_mxu_sharded_trainer as base
import torch_mesh_worker as mw
import torch_split_worker as sw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_split_worker.py")
SEED = 7
SPAWN_TIMEOUT_S = 180
PREFIXES = [f"{r}.{p}" for r in sw.RUNS for p in sw.PASSES]
DAY_RECORDS = 128           # two batches a pass


@pytest.fixture(scope="module")
def jax_runs():
    """Each run's lowering through the JAX package on its mesh, streaming
    and packed: (the dense init, {prefix: (stats, ws, params)}).  The
    init is the same on every mesh."""
    out, params0 = {}, None
    for prefix in PREFIXES:
        run, name = prefix.split(".")
        degrees, path, _ = sw.RUNS[run]
        jds, jeng, jtr = base._setup("jax", SEED, degrees, path)
        init = jax.tree.map(np.asarray, jtr.params)
        if params0 is None:
            params0 = init
        for a, b in zip(jax.tree.leaves(init), jax.tree.leaves(params0)):
            np.testing.assert_array_equal(a, b)
        stats = base._train(jds, jtr, name == "packed")
        out[prefix] = (stats, base._ws(jeng),
                       jax.tree.map(np.asarray, jtr.params))
    return params0, out


def _day_files(root):
    files = []
    for p in range(2):
        path = os.path.join(root, f"day{p}.txt")
        rng = np.random.default_rng(40 + p)
        with open(path, "w") as f:
            for _ in range(DAY_RECORDS):
                parts = [f"1 {rng.integers(0, 2)}",
                         f"{mw.DENSE_DIM} " + " ".join(
                             f"{rng.normal():.4f}"
                             for _ in range(mw.DENSE_DIM))]
                for _s in range(mw.N_SLOTS):
                    k = rng.integers(1, mw.CAP + 1)
                    parts.append(f"{k} " + " ".join(
                        str(rng.integers(1, 300)) for _ in range(k)))
                f.write(" ".join(parts) + "\n")
        files.append([path])
    return files


@pytest.fixture(scope="module")
def work(jax_runs, tmp_path_factory):
    """The spawn's directory: the dense init, the seed and the day's
    pass files."""
    out = tmp_path_factory.mktemp("split")
    mw.save_params(str(out / "params.npz"), jax_runs[0])
    with open(out / "spec.json", "w") as f:
        json.dump({"seed": SEED, "day_files": _day_files(str(out))}, f)
    return out


@pytest.fixture(scope="module")
def ranks(work):
    """Both ranks' results (``torch_split_worker``)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.launch",
         "--nproc_per_node", "2", "--coordinator",
         f"127.0.0.1:{mp._free_port()}", WORKER, str(work)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        stdout, stderr = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"the two ranks did not finish in {SPAWN_TIMEOUT_S} s")
    assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    got = []
    for r in range(2):
        with np.load(work / f"rank{r}.npz") as z:
            got.append(dict(z))
    assert [int(g["rank"]) for g in got] == [0, 1]
    return got


@pytest.fixture(scope="module")
def one_process(jax_runs, work):
    """The worker's passes and days with no group: each mesh in one
    process, one device a dp row."""
    with open(work / "spec.json") as f:
        spec = json.load(f)
    out = {}
    for run in sw.RUNS:
        for packed in (False, True):
            sw.one_pass(None, run, SEED, jax_runs[0], packed, out)
    for run in sw.DAY_RUNS:
        sw.day(None, run, spec["day_files"], jax_runs[0], out)
    return out


def _keys(res: dict, prefix: str):
    return sorted(k for k in res if k.startswith(prefix + "."))


DAY_PREFIXES = [f"day.{r}" for r in sw.DAY_RUNS]


@pytest.mark.parametrize("prefix", PREFIXES + DAY_PREFIXES)
def test_ranks_bit_equal(ranks, prefix):
    """Losses, AUC, the working set joined over the group, the dense
    params and the host table after end_pass: the same bits on both
    ranks, on the lowering the run names."""
    a, b = ranks
    keys = _keys(a, prefix)
    assert keys == _keys(b, prefix) and keys
    assert f"{prefix}.table.keys" in keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if not prefix.startswith("day."):
        assert str(a[f"{prefix}.path"]) == sw.RUNS[prefix[0]][2]


@pytest.mark.parametrize("prefix", PREFIXES + DAY_PREFIXES)
def test_ranks_equal_one_process_bitwise(ranks, one_process, prefix):
    """Each rank = the mesh in one process with one device a dp row, bit
    for bit, the host table after end_pass (and after the day: a
    ctr_double table, f64 show / click) included."""
    keys = _keys(one_process, prefix)
    assert keys
    if prefix.startswith("day."):
        assert one_process[f"{prefix}.table.show"].dtype == np.float64
    for res in ranks:
        assert _keys(res, prefix) == keys
        for k in keys:
            np.testing.assert_array_equal(res[k], one_process[k], err_msg=k)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_ranks_match_jax(ranks, jax_runs, prefix):
    """The same lowering through the JAX package on the same mesh."""
    js, jws, jparams = jax_runs[1][prefix]
    for res in ranks:
        assert len(res[f"{prefix}.losses"]) == js["batches"] == 3
        np.testing.assert_allclose(res[f"{prefix}.losses"].mean(),
                                   js["loss"], **base.LOSS_TOL)
        np.testing.assert_allclose(res[f"{prefix}.auc"], js["auc"],
                                   **base.LOSS_TOL)
        for k in jws:
            got = res[f"{prefix}.ws.{k}"]
            if jws[k].dtype == np.int32:
                np.testing.assert_array_equal(got, jws[k], err_msg=k)
            else:
                np.testing.assert_allclose(got, jws[k], err_msg=k,
                                           **base.TOL)
        got = mp._as_jax_params(res, prefix)
        for lw, lg in zip(jparams["mlp"], got["mlp"]):
            np.testing.assert_allclose(lg["w"], lw["w"], **base.TOL)
            np.testing.assert_allclose(lg["b"], lw["b"], **base.TOL)
        for k in ("dense_w", "bias"):
            np.testing.assert_allclose(got[k], jparams[k], **base.TOL)


COLLECTIVES = ("reduce_scatter", "reduce_scatter_world", "all_to_all",
               "ppermute", "ppermute_one_way", "gather_onto",
               "reduce_scatter_onto", "reduce_scatter_onto_replicas")


def _one_process_collectives():
    """The worker's collectives on dp 2 × sharding 4 with every shard on
    one device in this process, by name: the per-shard results."""
    out = {}
    sw.collectives_on(mc.one_device(**mw.MESH), out)
    return out


@pytest.mark.parametrize("name", COLLECTIVES)
def test_cross_process_collective_bit_equal(ranks, name):
    """Each rank's results on its shards = the one-process list op's on
    the same shards; a shard whose result is None there (another
    destination, a pipeline gap) has none on its rank."""
    want = _one_process_collectives()
    for r, res in enumerate(ranks):
        for k in range(4 * r, 4 * r + 4):
            key = f"col.{name}.{k}"
            assert (key in res) == (key in want), (r, k)
            if key in want:
                np.testing.assert_array_equal(res[key], want[key],
                                              err_msg=(r, k))
    assert any(k.startswith(f"col.{name}.") for k in want)


def test_locate_and_gather_rows_on_each_rank(ranks):
    """A [64, 3] placed over dp 2: rank r holds rows [32 r, 32 r + 32).
    ``locate`` names the owning block (r) and the row within it,
    ``gather_rows`` reads the rank's own rows and, both ranks asking,
    the other rank's (over the group), and the join over the group gives
    the whole tensor on both ranks."""
    x = np.random.default_rng(1).normal(0, 1, (64, 3)).astype(np.float32)
    t = mc.one_device(dp=2)
    want = t.place(torch.as_tensor(x), t.table_spec())
    for r, res in enumerate(ranks):
        rows = np.array([63, 40, 32, 33]) - 32 * (1 - r)
        which, local = want.locate(torch.as_tensor(rows))
        np.testing.assert_array_equal(res["rows.which"], [r] * 4)
        np.testing.assert_array_equal(res["rows.which"], which.numpy())
        np.testing.assert_array_equal(res["rows.local"], local.numpy())
        np.testing.assert_array_equal(res["rows.local"], [31, 8, 0, 1])
        np.testing.assert_array_equal(res["rows.gathered"], x[rows])
        np.testing.assert_array_equal(res["rows.remote"],
                                      x[[5 + 32 * (1 - r)]])
        np.testing.assert_array_equal(res["rows.joined"], x)


@pytest.mark.parametrize("prefix", PREFIXES)
def test_pull_sparse_on_each_rank(ranks, one_process, prefix):
    """``pull_sparse`` of every row: on the multi-node layout each rank
    reads its own replica; where the rows are split across processes
    each rank reads the other rank's rows over the group.  Either way
    bit-equal to one process."""
    want = one_process[f"pull.{prefix}"]
    assert want.shape[1] == 3 + mw.MF
    for res in ranks:
        np.testing.assert_array_equal(res[f"pull.{prefix}"], want)
