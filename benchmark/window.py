"""The measured window's arithmetic, and the sample of its outputs that
the reference judges."""

from __future__ import annotations

import random


def factor_ms(elapsed_s: float, count: int) -> float:
    """The window's time over the factorizations it completed: every
    factorization's wall and the harness's work between them, in ms."""
    return 1e3 * elapsed_s / count


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all the values, by linear
    interpolation between the closest ranks (numpy's default, Python's
    statistics 'inclusive')."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def p95_ms(walls_s) -> float:
    """The 95th percentile of every factorization's wall, in ms."""
    return 1e3 * percentile(walls_s, 95.0)


class Reservoir:
    """A uniform sample of `size` items of a stream of unknown length,
    drawn from the seed (Algorithm R), holding no more than `size`."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.items = []
        self._seen = 0
        self._rng = random.Random(seed)

    def offer(self, item):
        self._seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            r = self._rng.randrange(self._seen)
            if r < self.size:
                self.items[r] = item
