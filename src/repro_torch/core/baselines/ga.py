"""Genetic Algorithm: NSGA-II-lite (nondominated sort + crowding distance,
binary tournament, uniform crossover, per-gene mutation)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines.common import BaseOptimizer
from repro_torch.core.pareto import pareto_mask


def _nondominated_rank(Y: np.ndarray) -> np.ndarray:
    rank = np.full(len(Y), -1)
    r, remaining = 0, np.arange(len(Y))
    while len(remaining):
        mask = pareto_mask(Y[remaining])
        rank[remaining[mask]] = r
        remaining = remaining[~mask]
        r += 1
    return rank


def _crowding(Y: np.ndarray) -> np.ndarray:
    n, m = Y.shape
    if n <= 2:
        return np.full(n, np.inf)
    d = np.zeros(n)
    for j in range(m):
        order = np.argsort(Y[:, j])
        span = Y[order[-1], j] - Y[order[0], j] or 1.0
        d[order[0]] = d[order[-1]] = np.inf
        d[order[1:-1]] += (Y[order[2:], j] - Y[order[:-2], j]) / span
    return d


class GeneticAlgorithm(BaseOptimizer):
    def __init__(self, space=None, seed: int = 0, pop: int = 24,
                 p_mut: float = 0.15, **kw):
        super().__init__(space=space, seed=seed, **kw)
        self.pop_size = pop
        self.p_mut = p_mut

    def ask(self, n: int) -> np.ndarray:
        if len(self.X) < self.pop_size:
            return self.space.sample(self.rng, n)
        return np.stack([self._offspring() for _ in range(n)])

    def _offspring(self) -> np.ndarray:
        X = np.stack(self.X)
        Y = self._norm_y()
        rank = _nondominated_rank(Y)
        crowd = _crowding(Y)

        def tournament():
            i, j = self.rng.integers(len(X), size=2)
            if rank[i] != rank[j]:
                return i if rank[i] < rank[j] else j
            return i if crowd[i] > crowd[j] else j

        a, b = X[tournament()], X[tournament()]
        mask = self.rng.random(self.space.n_params) < 0.5
        child = np.where(mask, a, b).astype(np.int32)
        for pi in range(self.space.n_params):
            if self.rng.random() < self.p_mut:
                child[pi] = self.rng.integers(self.space.cardinalities[pi])
        return child
