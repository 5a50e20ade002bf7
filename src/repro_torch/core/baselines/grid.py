"""Grid Search: stride-stratified lattice enumeration of the design space.

Visits a low-discrepancy sequence of flat ids (golden-ratio stride over the
mixed-radix space) so any prefix of the sequence spreads across the lattice —
the classic budgeted variant of exhaustive grid search.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines.common import BaseOptimizer


class GridSearch(BaseOptimizer):
    def __init__(self, space=None, seed: int = 0, **kw):
        super().__init__(space=space, seed=seed, **kw)
        size = self.space.size
        phi = (np.sqrt(5) - 1) / 2
        self._stride = max(1, int(size * phi) | 1)   # odd stride, ~coprime
        self._pos = int(self.rng.integers(size))

    def ask(self, n: int) -> np.ndarray:
        out = []
        for _ in range(n):
            out.append(self._pos)
            self._pos = (self._pos + self._stride) % self.space.size
        return self.space.flat_to_idx(np.asarray(out))
