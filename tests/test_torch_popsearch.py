"""The population search's plan: the port's copy against the JAX package's.

Two `SearchPlan`s, one from each package, built with the same universe,
prices, spot flags, knobs and seed and fed the same verdicts round after
round, must propose the same keys, keep the same survivors and pick the
same `best()`.  The verdicts are a fixed function of the key, so both plans
see what a scorer would tell them."""

import pytest

from karpenter_tpu.scheduling import popsearch as jax_popsearch
from karpenter_tpu_torch.scheduling import popsearch as port_popsearch


def _verdict(key):
    """(fits, replacement price) as a scorer might answer a subset."""
    fits = (sum(key) * 7 + len(key)) % 5 != 0
    price = 0.0 if len(key) % 3 == 0 else 0.05 * (1 + sum(key) % 4)
    return fits, price


# (universe size, population, rounds, seed, warm start)
CASES = [
    (6, 16, 3, 0, ()),
    (12, 40, 4, 1, ()),
    (1, 8, 2, 2, ()),
    (20, 64, 3, 3, ((0, 1, 2), (3, 5), (7,), (19, 25))),
    (9, 4, 5, 4, ((1, 2),)),
]


@pytest.mark.parametrize("n,population,rounds,seed,warm", CASES)
def test_plans_propose_and_pick_alike(n, population, rounds, seed, warm):
    prices = [0.1 + 0.01 * (i % 7) for i in range(n)]
    spot = [i % 4 == 3 for i in range(n)]
    plans = [
        mod.SearchPlan(n, prices, spot, population, rounds, seed, warm=warm)
        for mod in (jax_popsearch, port_popsearch)
    ]
    proposed = 0
    while True:
        keys = [plan.propose() for plan in plans]
        assert keys[0] == keys[1]
        if not keys[0]:
            break
        proposed += len(keys[0])
        for plan in plans:
            plan.observe(keys[0], [_verdict(k) for k in keys[0]])
        assert plans[0].survivors() == plans[1].survivors()
    assert plans[0].round_no == plans[1].round_no
    assert plans[0].best() == plans[1].best()
    assert tuple(plans[1].best() or ()) == tuple(plans[0].best() or ())
    if n >= 2:
        assert proposed > 0
    for key in list(plans[0].results)[:20]:
        fits, price = _verdict(key)
        assert plans[0].acceptable(key, fits, price) == plans[1].acceptable(key, fits, price)


def test_constants_match():
    assert port_popsearch.SURVIVOR_FRACTION == jax_popsearch.SURVIVOR_FRACTION
    assert port_popsearch.FILL_ATTEMPTS == jax_popsearch.FILL_ATTEMPTS
    assert port_popsearch.BestAction._fields == jax_popsearch.BestAction._fields
