"""The dp axis across processes: two ranks under ``python -m
paddlebox_tpu_torch.launch --nproc_per_node 2`` train the mxu_sharded pass
on a dp 2 × sharding 4 mesh, one dp coordinate a process, over the
launcher's gloo group (``tests/torch_mesh_worker.py``, which imports the
port only, on ``device="cpu"``).

The configuration is ``tests/test_torch_multicard.py``'s (4 slots ×
capacity 3, mf_dim 4, 3 dense, DeepFM (16,), batch 64, three batches).
The ranks start from the JAX trainer's dense init on the same mesh.  They
must be bit-equal to each other (losses, AUC, working set, dense params,
the host table after a two-pass day) and to the same mesh in one process
with one device a dp row (the worker's functions with no group: the
"halves" layout), since the push's second tier and the dense gradient sum
fold every rank's part in rank order.  Against the JAX package's
``mxu_sharded`` on its 8 virtual CPU devices they hold that file's
tolerances: the pass loss rtol 1e-4; the working set and the dense params
rtol 1e-5 / atol 1e-6; integer fields equal.

The worker also runs the cross-process ``all_reduce`` / ``all_gather``
over ``dp``, held bitwise against the one-process list ops, and the
refusals of what a cross-process dp axis does not carry (the instance
dump and the per-user AUC, ROADMAP item 4.5).  The table split across
processes is ``tests/test_torch_multiprocess_split.py``'s, the rest of
the trainer family ``tests/test_torch_multiprocess_models.py``'s.  One
spawn serves every test of the file.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from paddlebox_tpu_torch.data.slot_record import SlotRecordBlock as TBlock
from paddlebox_tpu_torch.models.deepfm import DeepFM as TDeepFM
from paddlebox_tpu_torch.parallel import collective as tcol

import test_torch_multicard as mc
import test_torch_mxu_sharded_trainer as base
import torch_mesh_worker as w

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")
SEED = 7
SPAWN_TIMEOUT_S = 240
PASSES = ("streaming", "packed")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's mxu_sharded pass, streaming and packed, on the
    dp 2 × sharding 4 mesh: (its initial params, {pass: (stats, ws,
    params)})."""
    out, params0 = {}, None
    for name in PASSES:
        jds, jeng, jtr = base._setup("jax", SEED, w.MESH, "mxu_sharded")
        params0 = params0 or jax.tree.map(np.asarray, jtr.params)
        stats = base._train(jds, jtr, name == "packed")
        out[name] = (stats, base._ws(jeng),
                     jax.tree.map(np.asarray, jtr.params))
    return params0, out


@pytest.fixture(scope="module")
def ranks(jax_runs, tmp_path_factory):
    """Both ranks' results (``torch_mesh_worker``), from the JAX init."""
    out = tmp_path_factory.mktemp("mesh")
    w.save_params(str(out / "params.npz"), jax_runs[0])
    with open(out / "spec.json", "w") as f:
        json.dump({"seed": SEED}, f)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddlebox_tpu_torch.launch",
         "--nproc_per_node", "2", "--coordinator",
         f"127.0.0.1:{_free_port()}", WORKER, str(out)],
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
        with np.load(out / f"rank{r}.npz") as z:
            got.append(dict(z))
    assert [int(g["rank"]) for g in got] == [0, 1]
    return got


@pytest.fixture(scope="module")
def one_process(jax_runs):
    """The worker's passes and day with no group: the mesh in one
    process, one device a dp row."""
    out = {}
    for name in PASSES:
        w.one_pass(None, SEED, jax_runs[0], name == "packed", out, name)
    w.day(None, jax_runs[0], out)
    return out


def _keys(res: dict, prefix: str):
    return sorted(k for k in res if k.startswith(prefix + "."))


@pytest.mark.parametrize("prefix", PASSES + ("day",))
def test_ranks_bit_equal(ranks, prefix):
    a, b = ranks
    keys = _keys(a, prefix)
    assert keys == _keys(b, prefix) and keys
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if prefix != "day":
        assert str(a[f"{prefix}.path"]) == "mxu_sharded"


@pytest.mark.parametrize("name", PASSES)
def test_ranks_equal_one_process_bitwise(ranks, one_process, name):
    """Losses, AUC, working set and dense params of each rank = the
    one-process run with one device a dp row, bit for bit."""
    blk, ref = w.make_block(SEED), base._block(TBlock, SEED)
    for s in blk.uint64_slots:
        for x, y in zip(blk.uint64_slots[s], ref.uint64_slots[s]):
            np.testing.assert_array_equal(x, y)
    for s in blk.float_slots:
        np.testing.assert_array_equal(blk.float_slots[s][0],
                                      ref.float_slots[s][0])
    keys = _keys(one_process, name)
    for res in ranks:
        assert _keys(res, name) == keys
        for k in keys:
            np.testing.assert_array_equal(res[k], one_process[k], err_msg=k)


def _as_jax_params(res: dict, name: str):
    model = TDeepFM(base.N_SLOTS, 3 + base.MF, base.DENSE_DIM, hidden=(16,))
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.as_tensor(res[f"{name}.param.{i}"]))
    return model.jax_params()


@pytest.mark.parametrize("name", PASSES)
def test_ranks_match_jax(ranks, jax_runs, name):
    js, jws, jparams = jax_runs[1][name]
    for res in ranks:
        np.testing.assert_allclose(res[f"{name}.losses"].mean(), js["loss"],
                                   **base.LOSS_TOL)
        np.testing.assert_allclose(res[f"{name}.auc"], js["auc"],
                                   **base.LOSS_TOL)
        for k in jws:
            got = res[f"{name}.ws.{k}"]
            if jws[k].dtype == np.int32:
                np.testing.assert_array_equal(got, jws[k], err_msg=k)
            else:
                np.testing.assert_allclose(got, jws[k], err_msg=k,
                                           **base.TOL)
        got = _as_jax_params(res, name)
        for lw, lg in zip(jparams["mlp"], got["mlp"]):
            np.testing.assert_allclose(lg["w"], lw["w"], **base.TOL)
            np.testing.assert_allclose(lg["b"], lw["b"], **base.TOL)
        for k in ("dense_w", "bias"):
            np.testing.assert_allclose(got[k], jparams[k], **base.TOL)


def test_day_host_table_equals_one_process(ranks, one_process):
    """Two passes with end_pass write-back (the second built while the
    first trains, its stale rows refreshed): each rank's host table,
    every key and field, = the one-process run's, bit for bit."""
    keys = _keys(one_process, "day")
    assert "day.keys" in keys and "day.table.show" in keys
    assert one_process["day.table.show"].dtype == np.float64
    for res in ranks:
        assert _keys(res, "day") == keys
        for k in keys:
            np.testing.assert_array_equal(res[k], one_process[k], err_msg=k)


COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "all_reduce_min",
               "all_reduce_mean", "all_gather", "all_gather_stacked",
               "all_gather_world")


@pytest.mark.parametrize("name", COLLECTIVES)
def test_cross_process_collective_bit_equal(ranks, name):
    """Each rank's results on its shards = the one-process list op's on
    the same shards."""
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, (8, 8, 3)).astype(np.float32))
    topo = mc.one_device(**w.MESH)
    xs = [x[k].clone() for k in range(8)]
    if name.startswith("all_reduce_"):
        want = tcol.all_reduce(xs, topo, "dp", name[len("all_reduce_"):])
    elif name == "all_gather_world":
        want = tcol.all_gather(xs, topo, ("dp", "sharding"))
    else:
        want = tcol.all_gather(xs, topo, "dp",
                               tiled=name == "all_gather", concat_dim=(
                                   1 if name == "all_gather_stacked" else 0))
    for r, res in enumerate(ranks):
        for k in range(4 * r, 4 * r + 4):
            np.testing.assert_array_equal(res[f"col.{name}.{k}"],
                                          want[k].numpy(), err_msg=(r, k))


REFUSALS = {"dump_path": "NotImplementedError",
            "uid_slot": "NotImplementedError"}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cross_process_refusals_name_item_4_5(ranks, case):
    """The instance dump and the per-user AUC raise when the trainer is
    built, naming ROADMAP item 4.5 and why: they read the whole batch's
    preds on the host, which the JAX package does with ``np.asarray`` and
    a batch split across hosts does not allow.  (The async dense table,
    the page-view models and the device row cache on a split table are
    carried: ``tests/test_torch_multiprocess_models.py``.)"""
    for res in ranks:
        msg = str(res.get(f"refused.{case}", "not refused"))
        assert msg.startswith(REFUSALS[case] + ":"), msg
        assert "item 4.5" in msg and "np.asarray" in msg, msg


def test_init_distributed_fails_without_its_peer():
    """A rank whose peer never joins fails within FLAGS_fleet_deadline_s
    (gloo's default would hold it 30 minutes)."""
    code = ("from paddlebox_tpu_torch.launch import init_distributed; "
            f"init_distributed('127.0.0.1:{_free_port()}', 2, 0)")
    env = dict(os.environ, FLAGS_fleet_deadline_s="2")
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        _, stderr = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail("init_distributed waited past 120 s for a lost peer")
    assert proc.returncode != 0
    assert time.monotonic() - t0 < 60
    assert "Timed out" in stderr or "timed out" in stderr, stderr[-2000:]
