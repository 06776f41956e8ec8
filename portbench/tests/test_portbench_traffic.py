"""The traffic generator: one seed, one pass; the same sizes for every
seed; the stated key spaces, skew and label share."""

import numpy as np
import pytest

from portbench import harness, traffic

SPEC = {"name": "t", "driver": "steady_pass", "batches_per_pass": 4,
        "cardinalities": [1000, 30, 7], "zipf_exponent": 1.1,
        "keys_per_slot": [1, 3], "capacity": 3, "positive_rate": 0.256,
        "dense_features": 5, "slot_id_base": 100}


def _pass(seed, spec=SPEC, batch=2048):
    return traffic.make_pass(spec, batch, seed, "cpu")


def test_same_seed_same_pass_and_large_seeds():
    seed = 2**31 + 5
    a, b = _pass(seed), _pass(seed)
    for (ka, oa), (kb, ob) in zip(a.keys, b.keys):
        assert np.array_equal(ka, kb) and np.array_equal(oa, ob)
    assert np.array_equal(a.labels, b.labels)
    assert np.array_equal(a.dense, b.dense)
    assert 0 <= traffic.sub_seed(2**40 + 3, 2) < 2**63


def test_other_seed_other_draws_same_sizes():
    a, b = _pass(11), _pass(12)
    assert not np.array_equal(a.keys[0][0], b.keys[0][0])
    assert a.n == b.n == 4 * 2048
    for (ka, oa), (kb, ob) in zip(a.keys, b.keys):
        assert len(ka) == len(kb)
        la, lb = np.diff(oa), np.diff(ob)
        assert la.min() >= 1 and la.max() <= 3
        assert np.array_equal(np.bincount(la), np.bincount(lb))


def test_key_spaces_disjoint_and_bounded():
    p = _pass(3)
    seen = []
    for s, (keys, _) in enumerate(p.keys):
        space = traffic.feasigns(s, np.arange(1, SPEC["cardinalities"][s] + 1))
        assert np.isin(keys, space).all()
        seen.append(set(np.unique(keys).tolist()))
    assert not (seen[0] & seen[1]) and not (seen[1] & seen[2])
    assert p.slot_ids == [100, 101, 102]


def test_zipf_skew_and_label_share():
    p = _pass(7, batch=8192)
    keys = p.keys[0][0]
    _, counts = np.unique(keys, return_counts=True)
    ranks = np.arange(1, 1001, dtype=np.float64)
    p1 = 1.0 / (ranks ** -1.1).sum()
    assert abs(counts.max() / len(keys) - p1) < 0.01
    top = traffic.feasigns(0, np.array([1]))[0]
    assert np.sum(keys == top) == counts.max()
    assert abs(p.labels.mean() - 0.256) < 0.01
    assert abs(p.dense.std() - 1.0) < 0.02


def test_batches_slice_records_in_order():
    p = _pass(5, batch=256)
    slots, labels, dense = p.batch(2)
    assert np.array_equal(labels, p.labels[512:768])
    keys, off = p.keys[1]
    assert np.array_equal(slots[1][0], keys[off[512]:off[768]])
    assert np.array_equal(slots[1][1], np.diff(off[512:769]))


def test_criteo_file_states_the_kaggle_cardinalities():
    tr = harness.load_json(harness.HERE / "traffic" / "criteo_zipf.json")
    cards = tr["cardinalities"]
    assert len(cards) == 26 and sum(cards) == 33_762_577
    assert min(cards) == 3 and max(cards) == 10_131_227
    assert tr["batches_per_pass"] == 32 and tr["zipf_exponent"] == 1.1
    # Criteo's categorical fields are one-hot
    assert tr["keys_per_slot"] == [1, 1] and tr["capacity"] == 1
    p = traffic.make_pass(dict(tr, cardinalities=[40, 3]), 64, 9, "cpu")
    assert all((np.diff(off) == 1).all() for _, off in p.keys)


def test_a_bad_spec_is_refused():
    with pytest.raises(ValueError):
        traffic.check_spec(dict(SPEC, keys_per_slot=[1, 4]))
