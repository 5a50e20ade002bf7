"""Ask/tell interface shared by all black-box DSE baselines (Table 2)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Type

import numpy as np

from repro_torch.core.pareto import dominates_ref, ParetoArchive
from repro_torch.perfmodel.designspace import DesignSpace, SPACE


class BaseOptimizer:
    """Black-box multi-objective optimizer over the index-coded space.

    ask(n) -> (n, n_params) candidate designs;
    tell(X, Y) -> observe objectives (minimize, shape (n, 3)).
    """

    def __init__(self, space: DesignSpace = SPACE, seed: int = 0):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.X: List[np.ndarray] = []
        self.Y: List[np.ndarray] = []

    def ask(self, n: int) -> np.ndarray:
        raise NotImplementedError

    def tell(self, X: np.ndarray, Y: np.ndarray) -> None:
        for x, y in zip(np.atleast_2d(X), np.atleast_2d(Y)):
            self.X.append(np.asarray(x, dtype=np.int32))
            self.Y.append(np.asarray(y, dtype=np.float64))

    # -------- helpers shared by subclasses --------
    def _norm_y(self) -> np.ndarray:
        y = np.stack(self.Y)
        lo, hi = y.min(axis=0), y.max(axis=0)
        return (y - lo) / np.maximum(hi - lo, 1e-12)

    def _norm_x(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, dtype=np.float64) / (self.space.cardinalities - 1)


@dataclasses.dataclass
class MethodResult:
    name: str
    X: np.ndarray
    Y: np.ndarray
    phv: float
    sample_efficiency: float
    superior_count: int
    phv_curve: np.ndarray          # PHV after each evaluation


def run_method(opt_cls: Type[BaseOptimizer], evaluator, budget: int,
               ref_point: np.ndarray, space: DesignSpace = SPACE,
               seed: int = 0, batch: int = 1, curve_stride: int = 25,
               name: Optional[str] = None, **kw) -> MethodResult:
    """Drive one baseline for `budget` evaluations.

    `evaluator` is either an :class:`~repro_torch.perfmodel.evaluator.
    Evaluator` (its fused ``objectives`` dispatch is used — one dispatch
    per ask batch, one ``ppa_eval`` launch on ``backend="cuda"``) or a
    callable ``X: (n, n_params) int -> (n, 3)`` objectives
    ``[ttft, tpot, area]``.  The optimizers run on the host (numpy); only
    the evaluations are device work.
    """
    if hasattr(evaluator, "evaluate") and hasattr(evaluator, "objectives"):
        evaluator = evaluator.objectives
    opt = opt_cls(space=space, seed=seed, **kw)
    ref = np.asarray(ref_point, dtype=np.float64)
    # Streaming Pareto archive: PHV is a function of the front alone, so each
    # curve point costs O(front) insertion + O(front^2) sweep instead of
    # recomputing dominance over the whole history (O(budget^2) total).
    archive = ParetoArchive(n_obj=ref.shape[0])
    n_superior = 0
    phv_curve = []
    next_record = curve_stride
    while len(opt.X) < budget:
        n = min(batch, budget - len(opt.X))
        X = np.atleast_2d(opt.ask(n))[:n]
        Y = np.atleast_2d(evaluator(X))
        opt.tell(X, Y)
        archive.insert(Y)
        n_superior += int(dominates_ref(Y, ref).sum())
        # record once per stride crossing (batch-aware) and at the end
        if len(opt.X) >= next_record or len(opt.X) >= budget:
            phv_curve.append(archive.hypervolume(ref))
            next_record = (len(opt.X) // curve_stride + 1) * curve_stride
    X = np.stack(opt.X)
    Y = np.stack(opt.Y)
    return MethodResult(
        name=name or opt_cls.__name__, X=X, Y=Y,
        phv=phv_curve[-1] if phv_curve else archive.hypervolume(ref),
        sample_efficiency=n_superior / max(len(opt.X), 1),
        superior_count=n_superior,
        phv_curve=np.asarray(phv_curve),
    )
