"""Ant Colony Optimization: per-(parameter, choice) pheromone trails.

Ants sample each categorical choice proportionally to pheromone^alpha;
nondominated ants deposit pheromone on their choices; trails evaporate.
Exhibits the paper's observed far-to-near behaviour: early exploration is
near-uniform until trails accumulate.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines.common import BaseOptimizer
from repro_torch.core.pareto import pareto_mask


class AntColony(BaseOptimizer):
    def __init__(self, space=None, seed: int = 0, alpha: float = 1.2,
                 rho: float = 0.08, deposit: float = 1.0, **kw):
        super().__init__(space=space, seed=seed, **kw)
        self.alpha, self.rho, self.deposit = alpha, rho, deposit
        self.tau = [np.ones(c, dtype=np.float64) for c in self.space.cardinalities]

    def ask(self, n: int) -> np.ndarray:
        out = np.zeros((n, self.space.n_params), dtype=np.int32)
        for pi in range(self.space.n_params):
            p = self.tau[pi] ** self.alpha
            p /= p.sum()
            out[:, pi] = self.rng.choice(len(p), size=n, p=p)
        return out

    def tell(self, X: np.ndarray, Y: np.ndarray) -> None:
        super().tell(X, Y)
        # evaporate, then deposit on the current nondominated set
        Yall = np.stack(self.Y)
        Xall = np.stack(self.X)
        mask = pareto_mask(Yall)
        for pi in range(self.space.n_params):
            self.tau[pi] *= (1.0 - self.rho)
            np.add.at(self.tau[pi], Xall[mask, pi], self.deposit * self.rho)
            self.tau[pi] = np.maximum(self.tau[pi], 1e-3)
