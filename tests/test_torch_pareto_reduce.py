"""The Pareto reduction's plain version on the CPU: against a brute-force
dominance check, against ParetoArchive.insert, and a step-by-step copy of
the CUDA kernel's scan (``pareto_reduce.cu``) against both."""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core.pareto import ParetoArchive
from repro_torch.kernels.pareto_reduce import (entrants, pareto_reduce,
                                               pareto_reduce_cost,
                                               pareto_reduce_plain, sort_key)
from repro_torch.kernels.pareto_reduce import ops

torch.set_num_threads(1)


def _dominates(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.all(a <= b) and np.any(a < b))


def _brute(ys, front, keep):
    """O(n^2) by definition: entering candidates, dead front rows."""
    cand = np.flatnonzero(keep)
    enter = [i for i in cand
             if not any(_dominates(ys[j], ys[i]) for j in cand)
             and not any(_dominates(r, ys[i]) for r in front)]
    dead = np.array([any(_dominates(ys[i], r) for i in enter)
                     for r in front], dtype=bool)
    return np.array(enter, dtype=np.int64), dead


def _case(name: str, rng: np.random.Generator):
    """(batch rows, keep mask, incumbent rows) for one named case."""
    grid = lambda n, hi=5: rng.integers(0, hi, (n, 3)).astype(np.float32)
    ys, front = grid(300), grid(40, 7)
    if name == "ties":                      # few values: many equal keys
        ys, front = grid(300, 3), grid(20, 3)
    elif name == "duplicates":              # repeats in the batch and of
        ys[100:150] = ys[:50]               # the incumbents
        ys[150:170] = front[:20]
    elif name == "inf":
        ys[rng.integers(0, 300, 40), rng.integers(0, 3, 40)] = np.inf
        ys[rng.integers(0, 300, 10)] = np.inf
        ys[4] = [-1, np.inf, np.inf]        # dominated by row 5, at a
        ys[5] = [-1, np.inf, 5]             # tied key, and entering
        ys[6] = [np.inf, -1, 1]
        front[3] = [np.inf, -1, 0]          # kills row 6
    elif name == "nan":
        ys[rng.integers(0, 300, 30), rng.integers(0, 3, 30)] = np.nan
        ys[7] = [-1, -1, np.nan]            # would dominate all but NaN
        front[2] = [np.nan, -1, -1]
    elif name == "empty_archive":
        front = front[:0]
    elif name == "empty_batch":
        ys = ys[:0]
    elif name == "kills_incumbents":        # a mutually nondominated
        front = (rng.dirichlet((1, 1, 1), 40) * 6 + 3).astype(np.float32)
        ys[:10] = grid(10, 3)
    elif name == "continuous":              # sweep-like: distinct floats
        ys = np.exp(rng.normal(size=(3_000, 3))).astype(np.float32)
        front = np.exp(rng.normal(size=(60, 3)) - 1.5).astype(np.float32)
    keep = rng.random(len(ys)) < 0.85
    keep[4:8] = len(ys) > 0
    arch = ParetoArchive(3)
    arch.insert(front, ids=np.arange(len(front)) + 100_000)
    return ys, keep, arch


CASES = ["ties", "duplicates", "inf", "nan", "empty_archive", "empty_batch",
         "kills_incumbents", "continuous"]


def _kernel_order(ys, front, keep, ids, w):
    """``pareto_reduce.cu`` step by step in numpy: the keys, the sort, the
    staged candidates, each thread's scan (the front, then the sorted rows
    four at a time, indices clamped to n - 1, stopping after a group whose
    last key is larger than its own), the appended entering rows, then
    the dead pass over them."""
    c = len(ys)
    key = sort_key(torch.as_tensor(ys), w).numpy()
    key = np.where(keep, key, np.inf).astype(np.float32)
    perm = np.argsort(key, kind="stable")
    skey = key[perm]
    n = int(np.sum(skey < np.inf))
    rows = np.concatenate([ys[perm[:n]], skey[:n, None]], axis=1)
    out = []
    for t in range(n):
        me = rows[t]
        dom = any(_dominates(r, me[:3]) for r in front)
        j = 0
        while j < n and not dom:
            grp = [rows[min(j + u, n - 1)] for u in range(4)]
            dom = any(_dominates(r[:3], me[:3]) for r in grp)
            if grp[-1][3] > me[3]:
                break
            j += 4
        if not dom:
            out.append((me[:3], ids[perm[t]]))
    dead = np.array([any(_dominates(y, r) for y, _ in out) for r in front],
                    dtype=bool)
    return n, sorted(int(i) for _, i in out), dead


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_brute_force_insert_and_kernel_order(case):
    rng = np.random.default_rng(CASES.index(case))
    ys, keep, arch = _case(case, rng)
    front = arch.y.astype(np.float32)
    ids = (np.arange(len(ys)) * 7 + 3).astype(np.int32)
    enter, dead = _brute(ys, front, keep)
    w = (1.0, 0.5, 2.0)
    for block in (1024, 8):           # one block, and ties across blocks
        head, rows = pareto_reduce_plain(
            torch.as_tensor(ys), torch.as_tensor(front),
            torch.as_tensor(keep), torch.as_tensor(ids), w, block=block)
        n, y_in, ids_in, dead_got = entrants(head, rows)
        assert n == int(keep.sum())
        assert np.array_equal(ids_in, ids[enter])          # batch order
        assert np.array_equal(y_in, ys[enter].astype(np.float64),
                              equal_nan=True)
        assert np.array_equal(dead_got, dead)
    # the kernel's scan finds the same rows
    n_k, ids_k, dead_k = _kernel_order(ys, front, keep, ids, w)
    assert n_k == n and ids_k == sorted(ids[enter].tolist())
    assert np.array_equal(dead_k, dead)
    # applied, they give the archive insert gives: rows, ids, order,
    # n_seen, truncation, capacity
    want, got = copy.deepcopy(arch), copy.deepcopy(arch)
    want.insert(ys[keep], ids=ids[keep])
    got.apply(y_in, ids_in, dead_got, n)
    assert np.array_equal(got.y, want.y, equal_nan=True)
    assert np.array_equal(got.ids, want.ids)
    assert (got.n_seen, got.truncated, got.capacity) == (
        want.n_seen, want.truncated, want.capacity)
    if case == "kills_incumbents":
        assert dead.sum() > 10
    if case in ("inf", "nan"):
        assert not np.isfinite(y_in).all()


@pytest.mark.parametrize("capacity", ["auto", 12])
def test_apply_sizes_and_prunes_as_insert(capacity):
    """apply runs insert's capacity step: auto sizing, crowding pruning."""
    rng = np.random.default_rng(5)
    want = ParetoArchive(3, capacity=capacity, auto_floor=4)
    got = copy.deepcopy(want)
    for _ in range(4):
        ys = np.exp(rng.normal(size=(400, 3))).astype(np.float32)
        ids = rng.permutation(10**6)[:400].astype(np.int32)
        front = got.y.astype(np.float32)
        want.insert(ys, ids=ids)
        n, y_in, ids_in, dead = entrants(*pareto_reduce(
            torch.as_tensor(ys), torch.as_tensor(front),
            torch.ones(len(ys), dtype=torch.bool), torch.as_tensor(ids)))
        assert np.all(np.diff(ids_in) > 0)            # ordered by id
        pos = {int(i): k for k, i in enumerate(ids)}   # back to batch order
        batch = np.argsort([pos[int(i)] for i in ids_in], kind="stable")
        got.apply(y_in[batch], ids_in[batch], dead, n)
        assert np.array_equal(got.y, want.y)
        assert np.array_equal(got.ids, want.ids)
        assert (got.n_seen, got.truncated, got.capacity) == (
            want.n_seen, want.truncated, want.capacity)
    assert want.truncated == (capacity == 12)


def test_sort_key_is_monotone_under_dominance():
    """What dominates a row has a key <= the row's, with inf, -inf and
    overflow in the mix; NaN rows and overflow clamp to FLT_MAX."""
    rng = np.random.default_rng(1)
    vals = np.array([-np.inf, -3e38, -1.0, 0.0, 1e-30, 1.0, 2.5, 3e38,
                     np.inf], dtype=np.float32)
    a = vals[rng.integers(0, len(vals), (20_000, 3))]
    b = np.maximum(a, vals[rng.integers(0, len(vals), (20_000, 3))])
    w = (1.0, 7.0, 0.25)
    ka = sort_key(torch.as_tensor(a), w).numpy()
    kb = sort_key(torch.as_tensor(b), w).numpy()
    dom = np.all(a <= b, axis=1) & np.any(a < b, axis=1)
    assert dom.sum() > 10_000
    assert np.all(ka[dom] <= kb[dom])
    assert not np.isnan(ka).any() and not np.isnan(kb).any()
    assert ka.max() == ops.FLT_MAX
    nan = sort_key(torch.tensor([[np.nan, 0.0, 0.0]]), w).numpy()
    assert nan[0] == ops.FLT_MAX


def test_wrapper_checks_and_cost():
    ys = torch.zeros((4, 3))
    front = torch.zeros((0, 3))
    keep = torch.ones(4, dtype=torch.bool)
    ids = torch.arange(4, dtype=torch.int32) + 9
    before = pareto_reduce.launches
    head, rows = pareto_reduce(ys, front, keep, ids)
    assert pareto_reduce.launches == before           # the CPU: plain
    assert head.tolist() == [4, 4] and rows[:, 3].tolist() == [9, 10, 11, 12]
    with pytest.raises(TypeError):
        pareto_reduce(ys.double(), front, keep, ids)
    with pytest.raises(ValueError, match="shape"):
        pareto_reduce(torch.zeros((4, 2)), front, keep, ids)
    with pytest.raises(ValueError, match="keep"):
        pareto_reduce(ys, front, keep[:3], ids)
    with pytest.raises(ValueError, match="ids"):
        pareto_reduce(ys, front, keep, ids.long())
    with pytest.raises(ValueError, match="weights"):
        pareto_reduce(ys, front, keep, ids, weights=(1.0, 0.0, 1.0))
    cost = pareto_reduce_cost(c=524_288, n=52_358, f=0, m=345)
    assert cost["tests"] == (52_358 - 345) + 345 * 344
    assert cost["ops"] == ops.OPS_PER_TEST * cost["tests"]
    assert cost["bytes"] == 17 * 524_288 + 8 + 16 * 345
