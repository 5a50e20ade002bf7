"""Random Walker: unbiased random walk over the design lattice."""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines.common import BaseOptimizer


class RandomWalker(BaseOptimizer):
    def __init__(self, space=None, seed: int = 0, restart_p: float = 0.05, **kw):
        super().__init__(space=space, seed=seed, **kw)
        self._cur = None
        self._restart_p = restart_p

    def ask(self, n: int) -> np.ndarray:
        out = []
        for _ in range(n):
            if self._cur is None or self.rng.random() < self._restart_p:
                self._cur = self.space.sample(self.rng, 1)[0]
            else:
                nbrs = self.space.neighbors(self._cur)
                self._cur = nbrs[int(self.rng.integers(len(nbrs)))]
            out.append(self._cur.copy())
        return np.stack(out)
