"""Multi-objective Bayesian Optimization (ParEGO-style).

GP surrogate (RBF kernel, numpy Cholesky) over normalized index coordinates;
each iteration draws a random weight vector, scalarizes the normalized
objectives with the augmented Tchebycheff function, fits the GP, and
maximizes Expected Improvement over a candidate pool (random + neighbors of
the incumbent).  O(n^3) in observed samples — the scalability limit the
paper cites for BO [22].
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.baselines.common import BaseOptimizer


def _rbf(A: np.ndarray, B: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / ls ** 2)


class BayesianOptimization(BaseOptimizer):
    def __init__(self, space=None, seed: int = 0, n_init: int = 8,
                 lengthscale: float = 0.35, noise: float = 1e-6,
                 pool: int = 512, **kw):
        super().__init__(space=space, seed=seed, **kw)
        self.n_init = n_init
        self.ls = lengthscale
        self.noise = noise
        self.pool = pool

    def ask(self, n: int) -> np.ndarray:
        out = []
        for _ in range(n):
            if len(self.X) < self.n_init:
                out.append(self.space.sample(self.rng, 1)[0])
                continue
            out.append(self._propose())
        return np.stack(out)

    # ------------------------------------------------------------------
    def _propose(self) -> np.ndarray:
        Xn = self._norm_x(np.stack(self.X))
        Yn = self._norm_y()
        # augmented Tchebycheff scalarization with random weights
        w = self.rng.dirichlet(np.ones(Yn.shape[1]))
        s = np.max(Yn * w, axis=1) + 0.05 * (Yn * w).sum(axis=1)
        mu, std = s.mean(), s.std() + 1e-12
        z = (s - mu) / std

        K = _rbf(Xn, Xn, self.ls) + self.noise * np.eye(len(Xn))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, z))

        cands = self._candidates()
        Cn = self._norm_x(cands)
        Ks = _rbf(Cn, Xn, self.ls)
        mean = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(axis=0), 1e-12, None)
        sd = np.sqrt(var)

        best = z.min()
        imp = best - mean
        zz = imp / sd
        ei = imp * _ncdf(zz) + sd * _npdf(zz)
        return cands[int(np.argmax(ei))]

    def _candidates(self) -> np.ndarray:
        cands = [self.space.sample(self.rng, self.pool)]
        # densify around the current scalarized incumbent
        Yn = self._norm_y()
        inc = self.X[int(np.argmin(Yn.sum(axis=1)))]
        cands.append(self.space.neighbors(inc))
        seen = {tuple(x) for x in self.X}
        allc = np.concatenate(cands, axis=0)
        mask = [tuple(c) not in seen for c in allc]
        out = allc[np.asarray(mask, dtype=bool)]
        return out if len(out) else allc


def _npdf(x):
    return np.exp(-0.5 * x ** 2) / np.sqrt(2 * np.pi)


def _ncdf(x):
    # Abramowitz-Stegun erf approximation (no scipy dependency)
    t = 1.0 / (1.0 + 0.2316419 * np.abs(x))
    poly = t * (0.319381530 + t * (-0.356563782 + t * (1.781477937
              + t * (-1.821255978 + t * 1.330274429))))
    nd = 1.0 - _npdf(np.abs(x)) * poly
    return np.where(x >= 0, nd, 1.0 - nd)
