"""The traffic generator repeats exactly from a seed, and every seed offers
the same sizes in the same order."""

import itertools

import numpy as np
import pytest

from portbench.lib import spec, traffic as tr

MIXES = ("oversub",)


def take(mix, seed, n, vocab=1000):
    t = spec.load_json(spec.BENCH / "traffic" / f"{mix}.json")
    return t, list(itertools.islice(tr.stream(t, seed, vocab), n))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    _, a = take(mix, 2 ** 33 + 5, 150)
    _, b = take(mix, 2 ** 33 + 5, 150)
    for x, y in zip(a, b):
        assert (x.tenant, x.priority, x.max_new) == \
            (y.tenant, y.priority, y.max_new)
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_same_work(mix):
    _, a = take(mix, 1, 100)
    _, b = take(mix, 2 ** 40, 100)
    assert [(len(s.prompt), s.max_new, s.tenant) for s in a] == \
        [(len(s.prompt), s.max_new, s.tenant) for s in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)


def test_quantiles_hand_worked():
    assert list(tr.quantiles({"dist": "uniform", "min": 0, "max": 10}, 5)) \
        == [1, 3, 5, 7, 9]
    q = tr.quantiles({"dist": "loguniform", "min": 1, "max": 100}, 2)
    assert list(q) == [3, 32]          # 10^0.5, 10^1.5 rounded


def test_tenant_shares_and_means():
    t = spec.load_json(spec.BENCH / "traffic" / "oversub.json")
    slots = tr.tenant_slots(t["tenants"], 40)
    assert list(np.bincount(slots)) == [4, 12, 24]
    m = tr.mean_lengths(t)
    assert abs(m["prompt"] - 7680 / np.log(16)) < 15
    assert abs(m["output"] - 448 / np.log(8)) < 2
