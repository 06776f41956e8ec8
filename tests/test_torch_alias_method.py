"""The port's alias-method sampling (ops/alias_method.py) against the JAX
package's.

``build_alias_table`` is the same numpy code: its tables must equal the
JAX package's bit for bit.  ``alias_sample`` draws from a seeded
``torch.Generator`` (the JAX package takes a PRNG key, so the draws
themselves differ): 200,000 draws must pass a chi-square test against
the table's probabilities at p > 1e-3, the floor the JAX package's own
test (tests/test_optimizer_rules.py, ``test_alias_method``) holds within
0.01 per bin.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from paddlebox_tpu.ops import alias_method as ja
from paddlebox_tpu_torch.ops import alias_method as ta

N_DRAWS = 200_000


def distributions():
    rng = np.random.default_rng(0)
    return {
        "four": np.array([0.1, 0.2, 0.3, 0.4]),
        "unnormalized": np.array([3.0, 1.0, 0.0, 6.0, 2.0]),
        "zipf": 1.0 / np.arange(1, 65) ** 1.1,
        "random": rng.random(257),
        "one": np.array([5.0]),
    }


@pytest.mark.parametrize("name", sorted(distributions()))
def test_build_alias_table_matches_jax(name):
    probs = distributions()[name]
    a_t, l_t = ta.build_alias_table(probs)
    a_j, l_j = ja.build_alias_table(probs)
    assert a_t.dtype == np.float32 and l_t.dtype == np.int32
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(l_t, l_j)


@pytest.mark.parametrize("name", ["four", "unnormalized", "zipf", "random"])
def test_alias_sample_chi_square(name):
    probs = distributions()[name]
    p = probs / probs.sum()
    accept, alias = ta.build_alias_table(probs)
    gen = torch.Generator().manual_seed(1)
    draws = ta.alias_sample(gen, torch.as_tensor(accept),
                            torch.as_tensor(alias), (N_DRAWS,))
    assert draws.dtype == torch.int32 and tuple(draws.shape) == (N_DRAWS,)
    counts = np.bincount(draws.numpy(), minlength=len(p))
    assert counts[p == 0].sum() == 0     # a zero-probability bin never drawn
    live = p > 0
    _, pval = stats.chisquare(counts[live], N_DRAWS * p[live])
    assert pval > 1e-3, (name, pval)
    np.testing.assert_allclose(counts / N_DRAWS, p, atol=0.01)


def test_alias_sample_is_seeded_and_shaped():
    accept, alias = ta.build_alias_table(np.array([0.1, 0.2, 0.3, 0.4]))
    a, l = torch.as_tensor(accept), torch.as_tensor(alias)
    one = ta.alias_sample(torch.Generator().manual_seed(5), a, l, (7, 3))
    two = ta.alias_sample(torch.Generator().manual_seed(5), a, l, (7, 3))
    assert tuple(one.shape) == (7, 3)
    assert torch.equal(one, two)
    assert int(one.min()) >= 0 and int(one.max()) < 4
