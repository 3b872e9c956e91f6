"""The one traffic generator: deterministic under the seed, and every
seed gets the same lengths in another order."""
import json

import pytest

from perfbench.harness import spec
from perfbench.harness.traffic import Requests, quantile_lengths

MIXES = sorted(p.stem for p in (spec.PERFBENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = spec.traffic(name)
    a = [next(Requests(mix, 1000, 2**31 + 5)) for _ in range(3)]
    r1, r2 = Requests(mix, 1000, 2**31 + 5), Requests(mix, 1000, 2**31 + 5)
    assert [next(r1) for _ in range(100)] == [next(r2) for _ in range(100)]
    assert a[0] == a[1]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_the_same_lengths_in_each_block(name):
    mix = spec.traffic(name)
    blocks, orders = [], []
    for seed in (1, 2, 3):
        r = Requests(mix, 1000, seed)
        reqs = [next(r) for _ in range(2 * mix["levels"])]
        blocks.append(sorted((len(p), n) for p, n in reqs[:mix["levels"]]))
        orders.append([len(p) for p, _ in reqs[:mix["levels"]]])
        assert sorted(len(p) for p, _ in reqs) == sorted(r.prompts * 2)
        assert all(1 <= t < 1000 for p, _ in reqs for t in p)
    assert blocks[0] == blocks[1] == blocks[2]     # the same pairs, every seed
    assert orders[0] != orders[1]                   # in the seed's order
    assert sorted(n for _, n in blocks[0]) == sorted(r.outputs)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_range_and_fit_the_cache(name):
    mix = spec.traffic(name)
    for key in ("prompt", "output"):
        ls = quantile_lengths(mix[key], mix["levels"])
        assert min(ls) >= mix[key]["min"] and max(ls) <= mix[key]["max"]
    assert Requests(mix, 1000, 0).longest() <= mix["max_seq"] - 1
    assert set(json.loads((spec.PERFBENCH / "traffic" / f"{name}.json").read_text())) >= {
        "driver", "clients", "max_batch", "max_seq", "levels", "check_requests"}


def test_quantiles_by_hand():
    assert quantile_lengths({"dist": "uniform", "min": 10, "max": 13}, 4) == [10, 11, 12, 13]
    ls = quantile_lengths({"dist": "lognormal", "median": 100, "sigma": 0.5,
                           "min": 1, "max": 10**6}, 3)
    assert ls[1] == 100 and ls[0] < 100 < ls[2]
