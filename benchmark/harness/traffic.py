"""The one traffic generator: request sizes and contents from a cell's
parameters and the seed.

Sizes are the same set for every seed, in another order: a cycle of
one size a client, at evenly spaced quantiles of the stated
distribution, shuffled by the seed, so that runs on different seeds do
the same work and differ only in order and content.
"""

from __future__ import annotations

import math
import random
from statistics import NormalDist


def lognormal_sizes(n: int, median: float, sigma: float, lo: int, hi: int):
    """``n`` sizes at the quantiles (i + 1/2) / n of a log-normal with
    this median and sigma, rounded and clipped to ``[lo, hi]``."""
    z = NormalDist()
    return [min(hi, max(lo, round(median * math.exp(
        sigma * z.inv_cdf((i + .5) / n))))) for i in range(n)]


def sizes(spec: dict, cycle: int, seed: int, salt: int) -> list[int]:
    """A shuffled cycle of sizes for ``spec`` (``{"median", "sigma",
    "min", "max"}``)."""
    out = lognormal_sizes(cycle, spec["median"], spec["sigma"], spec["min"],
                          spec["max"])
    random.Random(seed * 1000003 + salt).shuffle(out)
    return out


class ClosedLoop:
    """Requests of a closed loop: request ``k`` has prompt length
    ``prompts[k % clients]`` and output length ``outputs[k % clients]``
    (drawn independently, so a long prompt may ask for a short answer),
    and tokens uniform over the vocabulary from the seed, unique to the
    request (no shared prefixes)."""

    def __init__(self, params: dict, vocab: int, seed: int):
        cycle = params["clients"]
        self.prompts = sizes(params["prompt"], cycle, seed, 1)
        self.outputs = sizes(params["output"], cycle, seed, 2)
        self.vocab, self.seed = vocab, seed

    def request(self, k: int):
        """``(prompt tokens as int64 numpy, output length)``."""
        import numpy as np

        c = k % len(self.prompts)
        rng = np.random.default_rng([self.seed, k])
        prompt = rng.integers(0, self.vocab, self.prompts[c], dtype=np.int64)
        return prompt, self.outputs[c]
