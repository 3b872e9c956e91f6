"""The one traffic generator: requests of a mix from its parameters and
a seed. Every seed gets the same set of requests in another order: the
lengths are fixed quantiles of the mix's distributions, ``levels`` of
each, prompt level i always paired with output level PAIR * i mod
``levels`` (so long prompts come with short and long answers alike),
and each block of ``levels`` requests holds every pair once, in an order
drawn from the seed, as are the token ids. So the work of a window does
not change with the seed, only its order and its ids."""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

PAIR = 5          # prime to every power-of-two number of levels


def quantile_lengths(dist: dict, levels: int) -> list:
    """`levels` lengths at the quantiles (i + 1/2) / levels of `dist`:
    {"dist": "lognormal", "median", "sigma", "min", "max"} or
    {"dist": "uniform", "min", "max"} (both ends included)."""
    qs = [(i + 0.5) / levels for i in range(levels)]
    if dist["dist"] == "lognormal":
        out = [dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(q)) for q in qs]
    elif dist["dist"] == "uniform":
        out = [dist["min"] + q * (dist["max"] - dist["min"] + 1) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [int(min(max(round(x) if dist["dist"] == "lognormal" else math.floor(x),
                        dist["min"]), dist["max"])) for x in out]


class Requests:
    """An endless stream of (prompt ids, output tokens) of a mix."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.levels = mix["levels"]
        if math.gcd(PAIR, self.levels) != 1:
            raise ValueError(f"levels {self.levels} must be prime to {PAIR}")
        self.prompts = quantile_lengths(mix["prompt"], self.levels)
        self.outputs = quantile_lengths(mix["output"], self.levels)
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.block = []

    def __iter__(self):
        return self

    def __next__(self):
        if not self.block:
            order = self.rng.permutation(self.levels)
            self.block = [(self.prompts[i], self.outputs[PAIR * i % self.levels])
                          for i in order][::-1]
        length, out = self.block.pop()
        return self.rng.integers(1, self.vocab, length).tolist(), out

    def longest(self) -> int:
        """The most tokens a request of the mix holds: its longest pair."""
        return max(self.prompts[i] + self.outputs[PAIR * i % self.levels]
                   for i in range(self.levels))
