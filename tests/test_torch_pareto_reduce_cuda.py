"""The CUDA pareto_reduce kernel against its plain version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built at first use); skipped
elsewhere.  On the card: ``python -m pytest -q -m cuda tests/``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pareto import pareto_mask
from repro_torch.kernels.pareto_reduce import (entrants, pareto_reduce,
                                               pareto_reduce_plain)
from repro_torch.kernels.pareto_reduce.bench import absorb_by_insert
from repro_torch.perfmodel import SweepEngine, get_evaluator

pytestmark = pytest.mark.cuda

CHUNK = 524_288                 # the benchmark sweep's chunk
W = (1.0, 0.5, 0.01)            # key weights of the sweep's magnitudes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _sweep_like(c: int, n: int, f: int, seed: int, dev):
    """c rows of three correlated log-normal objectives, n of them kept,
    ids ascending from a chunk start; f rows of another sample's front."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(c, 3))
    z[:, 1] += 0.8 * z[:, 0]
    z[:, 2] = 2.0 * z[:, 2] + 5.0
    ys = np.exp(z).astype(np.float32)
    keep = np.zeros(c, dtype=bool)
    keep[rng.choice(c, size=n, replace=False)] = True
    other = np.exp(rng.normal(size=(200_000, 3)) * [1.0, 1.0, 2.0]
                   + [0.0, 0.0, 5.0]).astype(np.float32)
    front = other[pareto_mask(other)][:f]
    ids = np.arange(c, dtype=np.int32) + 3 * c
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (ys, front, keep, ids))


def _same(head, rows, want_head, want_rows) -> None:
    assert torch.equal(head, want_head)
    got, want = entrants(head, rows), entrants(want_head, want_rows)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g, w, equal_nan=True)


@pytest.mark.parametrize("n, f", [(52_358, 0), (52_358, 345),
                                  (2_526, 349), (0, 40)])
def test_kernel_matches_plain_at_the_sweeps_chunks(cuda, n, f):
    """A first chunk (about 52k survivors, empty or full archive), a later
    one, and one without survivors, at the sweep's chunk of 524,288."""
    ys, front, keep, ids = _sweep_like(CHUNK, n, f, seed=n + f, dev=cuda)
    before = pareto_reduce.launches
    head, rows = pareto_reduce(ys, front, keep=keep, ids=ids, weights=W)
    torch.cuda.synchronize()
    assert pareto_reduce.launches == before + 1
    _same(head, rows, *pareto_reduce_plain(ys, front, keep, ids, W))
    again = pareto_reduce(ys, front, keep=keep, ids=ids, weights=W)
    _same(*again, head, rows)
    assert int(head[0]) == n
    if n:
        assert 0 < int(head[1]) < n


@pytest.mark.parametrize("c", [1, 255, 257, 4_113])
def test_kernel_matches_plain_on_ties_inf_and_nan(cuda, c):
    rng = np.random.default_rng(c)
    ys = rng.integers(0, 4, (c, 3)).astype(np.float32)
    ys[rng.random((c, 3)) < 0.05] = np.inf
    ys[rng.random((c, 3)) < 0.03] = np.nan
    ys[rng.random(c) < 0.02] = -np.inf
    front = rng.integers(0, 6, (37, 3)).astype(np.float32)
    front[0] = np.nan
    front[1] = np.inf
    ids = rng.permutation(10 * c)[:c].astype(np.int32)
    args = [torch.as_tensor(a, device=cuda) for a in (ys, front)]
    for keep in (rng.random(c) < 0.9, np.ones(c, dtype=bool)):
        more = [torch.as_tensor(a, device=cuda) for a in (keep, ids)]
        head, rows = pareto_reduce(*args, *more)
        torch.cuda.synchronize()
        _same(head, rows, *pareto_reduce_plain(*args, *more))


def test_sweep_on_the_card_equals_the_host_insert(cuda, monkeypatch):
    """Four chunks of a sweep through the kernel give what inserting every
    survivor on the host gives, bit for bit, n_seen included."""
    ev = get_evaluator("proxy", backend="cuda", device=cuda)
    seen = {}
    real = SweepEngine._reduce_states

    def reduced(self, states, seconds):
        seen[tag] = [a.n_seen for st in states for a in st["archives"]]
        return real(self, states, seconds)

    monkeypatch.setattr(SweepEngine, "_reduce_states", reduced)
    tag, before = "kernel", pareto_reduce.launches
    got = SweepEngine(ev, chunk_size=131_072, stall_topk=4).run(0, 500_000)
    assert pareto_reduce.launches == before + 4
    tag = "host"
    monkeypatch.setattr(SweepEngine, "_absorb", absorb_by_insert)
    want = SweepEngine(ev, chunk_size=131_072, stall_topk=4).run(0, 500_000)
    for f in ("n_superior", "pareto_y", "pareto_ids", "topk_val", "topk_ids",
              "stall_topk_ids", "archive_truncated", "archive_capacity"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert seen["kernel"] == seen["host"]
