"""Pareto-front utilities: dominance, exact hypervolume (2D/3D), metrics.

Conventions: ALL objectives are minimized.  The Pareto Hypervolume (PHV,
paper Definition 3) is the m-dimensional volume of the region dominated by
the front and bounded above by the reference point; points not strictly
better than the reference in every objective contribute nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np


def pareto_mask(y: np.ndarray, block_size: int = 512) -> np.ndarray:
    """Boolean mask of nondominated rows of y (n, m), minimization.

    Blockwise vectorized dominance with objective-sum pruning: a dominator of
    x must have all objectives <= and at least one < — hence a strictly
    smaller objective sum — so after a stable sort by sum, only *earlier*
    still-alive rows can dominate a block.  Duplicate rows never dominate
    each other (no strict inequality) and are all kept, matching the
    historical O(n^2) Python-loop semantics.
    """
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    order = np.argsort(y.sum(axis=1), kind="stable")
    ys = y[order]
    alive = np.ones(n, dtype=bool)
    # Survivors of earlier blocks can never be dominated by later rows (their
    # sums are >=), so the running `front` only grows and is the complete
    # dominator set for every later block.
    front = np.empty((0, ys.shape[1]))
    for s in range(0, n, block_size):
        e = min(s + block_size, n)
        blk = ys[s:e]                                   # (b, m)
        balive = ~_dominated_by(front, blk)
        idx = np.flatnonzero(balive)
        if idx.size > 1:                                # within-block pass
            sub = blk[idx]
            dom = _dominated_by(sub, sub)
            if dom.any():
                balive[idx[dom]] = False
                idx = idx[~dom]
        alive[s:e] = balive
        front = np.concatenate([front, blk[idx]], axis=0)
    mask = np.zeros(n, dtype=bool)
    mask[order] = alive
    return mask


def _dominated_by(front: np.ndarray, blk: np.ndarray,
                  prefilter: int = 64) -> np.ndarray:
    """Rows of blk (b, m) dominated by some row of front (f, m).

    Two-tier: screen against the `prefilter` strongest (lowest objective-sum)
    front rows first — they kill most of the block cheaply — then run the
    full front only on the survivors.  Comparisons are per-objective 2D ops
    (much faster in NumPy than 3D broadcast + axis reduction).
    """
    b, m = blk.shape
    if front.shape[0] == 0 or b == 0:
        return np.zeros(b, dtype=bool)
    if front.shape[0] > 2 * prefilter:
        dead = _dominated_by(front[:prefilter], blk, prefilter)
        idx = np.flatnonzero(~dead)
        if idx.size:
            dead2 = _dominated_by(front[prefilter:], blk[idx], front.shape[0])
            dead[idx[dead2]] = True
        return dead
    all_le = np.ones((b, front.shape[0]), dtype=bool)
    any_lt = np.zeros((b, front.shape[0]), dtype=bool)
    for j in range(m):
        fj = front[:, j][None, :]
        bj = blk[:, j][:, None]
        all_le &= fj <= bj
        any_lt |= fj < bj
    return (all_le & any_lt).any(axis=1)


def pareto_front(y: np.ndarray) -> np.ndarray:
    return np.asarray(y)[pareto_mask(y)]


class ParetoArchive:
    """Streaming nondominated archive (minimization).

    Insertion is O(batch x front): newcomers are screened against the current
    front, surviving newcomers prune dominated incumbents, and the invariant
    "self.y == pareto_front(everything ever inserted)" holds exactly while
    the archive stays under ``capacity``.  With a capacity set, overflow is
    resolved by dropping the most crowded points (extreme points per
    objective are always kept), which bounds memory for full-space sweeps.

    Optionally carries one integer id per point (e.g. the flat design id) so
    sweep results remain traceable back to design vectors.

    ``capacity="auto"`` sizes the bound from the observed front width
    instead of a user guess: after every insert the cap is raised to
    ``auto_headroom`` x the widest (post-dominance) front seen so far
    (never below ``auto_floor``), BEFORE any pruning could fire — auto
    never truncates, memory stays proportional to the true front width,
    and the final ``capacity`` is the data-derived bound a fixed-capacity
    run of the same stream should use.
    """

    def __init__(self, n_obj: int, capacity: Union[int, str, None] = None, *,
                 auto_floor: int = 2_048, auto_headroom: float = 2.0):
        self.n_obj = int(n_obj)
        self.auto = capacity == "auto"
        self.auto_floor = int(auto_floor)
        self.auto_headroom = float(auto_headroom)
        self._peak = 0               # widest front observed (auto sizing)
        self.capacity = self.auto_floor if self.auto else capacity
        self.y = np.empty((0, self.n_obj), dtype=np.float64)
        self.ids = np.empty((0,), dtype=np.int64)
        self.n_seen = 0
        self.truncated = False       # True once capacity pruning ever fired

    def __len__(self) -> int:
        return self.y.shape[0]

    def insert(self, y: np.ndarray, ids: Optional[np.ndarray] = None) -> int:
        """Insert a batch of points; returns how many entered the front."""
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        if y.shape[0] == 0:
            return 0
        if y.shape[1] != self.n_obj:
            raise ValueError(f"expected {self.n_obj} objectives, got {y.shape[1]}")
        ids = (np.full(y.shape[0], -1, dtype=np.int64) if ids is None
               else np.asarray(ids, dtype=np.int64).reshape(-1))
        seen = y.shape[0]

        # newcomers must be mutually nondominated first
        keep_new = pareto_mask(y)
        y, ids = y[keep_new], ids[keep_new]
        dead = None
        if self.y.shape[0]:
            # drop newcomers dominated by the current front (duplicates of
            # incumbents are NOT dominated and accumulate, matching
            # pareto_front on the concatenated history)
            dominated = _dominated_by(self.y, y)
            y, ids = y[~dominated], ids[~dominated]
            if y.shape[0]:
                # incumbents dominated by surviving newcomers
                dead = _dominated_by(y, self.y)
        return self.apply(y, ids, dead, seen)

    def apply(self, y: np.ndarray, ids: np.ndarray,
              dead: Optional[np.ndarray], seen: int) -> int:
        """Apply a screened batch: drop the incumbents `dead` marks, append
        the entering rows `y` (with `ids`) in their batch order, count the
        `seen` rows the whole batch held, and size or prune to capacity;
        returns how many entered.  ``insert`` screens a batch and ends
        here; a caller that screened it elsewhere (the sweep's on-device
        reduction) gets the same archive, bit for bit."""
        y = np.asarray(y, dtype=np.float64).reshape(-1, self.n_obj)
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        self.n_seen += int(seen)
        if y.shape[0] == 0:
            return 0
        if dead is not None and dead.any():
            self.y, self.ids = self.y[~dead], self.ids[~dead]
        self.y = np.concatenate([self.y, y], axis=0)
        self.ids = np.concatenate([self.ids, ids], axis=0)
        if self.auto:
            # raise the cap from the observed (post-dominance) width FIRST
            # so auto never prunes — not even on a first insert wider than
            # the floor; the cap is the data-derived recommendation
            self._peak = max(self._peak, len(self))
            self.capacity = max(self.auto_floor,
                                int(self.auto_headroom * self._peak))
        elif self.capacity is not None and len(self) > self.capacity:
            self._prune_to(self.capacity)
        return y.shape[0]

    def _prune_to(self, cap: int) -> None:
        """Keep the `cap` least-crowded points (NSGA-II crowding distance)."""
        self.truncated = True
        d = self._crowding(self.y)
        keep = np.argsort(-d, kind="stable")[:cap]
        keep.sort()
        self.y, self.ids = self.y[keep], self.ids[keep]

    @staticmethod
    def _crowding(y: np.ndarray) -> np.ndarray:
        n, m = y.shape
        d = np.zeros(n)
        for j in range(m):
            o = np.argsort(y[:, j], kind="stable")
            span = max(y[o[-1], j] - y[o[0], j], 1e-300)
            d[o[0]] = d[o[-1]] = np.inf        # always keep the extremes
            d[o[1:-1]] += (y[o[2:], j] - y[o[:-2], j]) / span
        return d

    def hypervolume(self, ref: Sequence[float]) -> float:
        return hypervolume(self.y, ref)

    def dominating(self, ref: Sequence[float]) -> np.ndarray:
        """Archive points strictly better than `ref` in every objective."""
        if not len(self):
            return np.zeros(0, dtype=bool)
        return dominates_ref(self.y, np.asarray(ref, dtype=np.float64))


def dominates_ref(y: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Mask of points strictly better than the reference in ALL objectives."""
    return np.all(np.asarray(y) < np.asarray(ref)[None, :], axis=1)


def _hv2d(pts: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2D hypervolume (minimization)."""
    pts = pts[np.all(pts < ref[None, :], axis=1)]
    if len(pts) == 0:
        return 0.0
    order = np.argsort(pts[:, 0])
    pts = pts[order]
    hv, y_best = 0.0, ref[1]
    for x, y in pts:
        if y < y_best:
            hv += (ref[0] - x) * (y_best - y)
            y_best = y
    return float(hv)


def _hv3d(pts: np.ndarray, ref: np.ndarray) -> float:
    """Exact 3D hypervolume via z-sweep over 2D slabs (minimization).

    Sort by z; between consecutive z levels the dominated xy-area is the 2D
    hypervolume of all points at or below the slab.  O(n^2 log n) — the
    fronts here are <= a few hundred points.
    """
    pts = pts[np.all(pts < ref[None, :], axis=1)]
    if len(pts) == 0:
        return 0.0
    order = np.argsort(pts[:, 2])
    pts = pts[order]
    zs = np.concatenate([pts[:, 2], [ref[2]]])
    hv = 0.0
    for i in range(len(pts)):
        dz = zs[i + 1] - zs[i]
        if dz <= 0:
            continue
        hv += _hv2d(pts[: i + 1, :2], ref[:2]) * dz
    return float(hv)


def hypervolume(points: np.ndarray, ref: Sequence[float]) -> float:
    """Exact hypervolume for 2 or 3 objectives (minimization)."""
    points = np.asarray(points, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if points.ndim != 2 or points.shape[0] == 0:
        return 0.0
    points = points[pareto_mask(points)]
    m = points.shape[1]
    if m == 2:
        return _hv2d(points, ref)
    if m == 3:
        return _hv3d(points, ref)
    raise NotImplementedError(f"hypervolume for m={m}")


def hypervolume_mc(points: np.ndarray, ref: Sequence[float], lo: Sequence[float],
                   n: int = 200_000, seed: int = 0) -> float:
    """Monte-Carlo hypervolume estimate (oracle for property tests)."""
    rng = np.random.default_rng(seed)
    ref = np.asarray(ref, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    pts = np.asarray(points, dtype=np.float64)
    samples = rng.uniform(lo, ref, size=(n, len(ref)))
    dominated = np.zeros(n, dtype=bool)
    for p in pts:
        dominated |= np.all(samples >= p[None, :], axis=1)
    return float(dominated.mean() * np.prod(ref - lo))


def sample_efficiency(y: np.ndarray, ref: np.ndarray) -> float:
    """Paper metric: fraction of evaluated designs strictly better than the
    reference point in all objectives."""
    y = np.asarray(y)
    if len(y) == 0:
        return 0.0
    return float(dominates_ref(y, ref).mean())
