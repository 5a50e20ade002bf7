"""Streaming full-space sweep engine: every design in [0, 4.7M) on device.

:class:`SweepEngine` streams the flat id range through the torch roofline
model (or the CUDA ``ppa_eval`` kernel) in fixed-size chunks, with

* mixed-radix unranking on the device — no host-side ``flat_to_idx``
  materialization of 4.7M index vectors;
* per-chunk on-device reduction: a running top-k per objective, the count
  of designs strictly dominating the reference point, optional per-stall-
  class top-k seeds, and a bounded dominance filter that kills ~all
  dominated points before anything leaves the device;
* an exact host-side :class:`~repro_torch.core.pareto.ParetoArchive`
  absorbing the few filter survivors per chunk, so the final front equals
  the brute-force ``pareto_front`` of all evaluated points (while under
  archive capacity).

Ties follow the reference (``lax.top_k``: the lower position wins), here
through stable sorts: the running carry comes before the chunk and ids
ascend within a chunk, so the earlier id wins.

Objectives follow the repo convention: ``[ttft, tpot, area]``, all
minimized.  This is the single-process path; portfolio (multi-scenario)
sweeps, ``run(workers=N)``, checkpoints and ``chunk_size="auto"`` are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.pareto import ParetoArchive
from repro_torch.perfmodel.designspace import DesignSpace, SPACE, A100_REFERENCE
from repro_torch.perfmodel.hardware import derive_hardware
from repro_torch.perfmodel.roofline import _seq_sum, _workload_fingerprint

_N_STALL = 4            # stall classes in carry order (critical_path order)
BACKENDS = ("roofline", "cuda")


# --------------------------------------------------------------------------
# on-device pieces
# --------------------------------------------------------------------------

def _unrank(flat: torch.Tensor, cards: Tuple[int, ...]) -> torch.Tensor:
    """Mixed-radix unrank on device: (c,) int32 flat ids -> (c, n_params)
    int32.  Matches ``DesignSpace.flat_to_idx`` (last parameter fastest)."""
    cols = []
    rem = flat
    for c in reversed(cards):
        cols.append(rem % c)
        rem = rem // c
    return torch.stack(cols[::-1], dim=1).to(torch.int32)


def _smallest_k(vals: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest values, ascending; ties keep the lower
    position first (the order ``lax.top_k(-vals, k)`` gives)."""
    return torch.sort(vals, stable=True).indices[:k]


def _dominated_on_device(filt: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(f, m) filter rows x (c, m) points -> (c,) dominated mask; +inf
    filter rows can never dominate anything."""
    f = filt.shape[0]
    c, m = ys.shape
    all_le = torch.ones((c, f), dtype=torch.bool, device=ys.device)
    any_lt = torch.zeros((c, f), dtype=torch.bool, device=ys.device)
    for j in range(m):
        fj = filt[:, j][None, :]
        yj = ys[:, j][:, None]
        all_le &= fj <= yj
        any_lt |= fj < yj
    return (all_le & any_lt).any(dim=1)


@dataclasses.dataclass
class SweepResult:
    n_evaluated: int
    n_superior: int               # designs strictly dominating the reference
    pareto_y: np.ndarray          # (p, 3) exact front of evaluated points
    pareto_ids: np.ndarray        # (p,) flat design ids of the front
    topk_val: np.ndarray          # (3, k) best objective values seen
    topk_ids: np.ndarray          # (3, k) their flat design ids
    ref_point: np.ndarray
    seconds: float
    points_per_sec: float
    archive_truncated: bool       # capacity pruning fired (front then inexact)
    stall_topk_val: Optional[np.ndarray] = None   # (4, k) best rank key
    stall_topk_ids: Optional[np.ndarray] = None   # (4, k) per dominant stall
    archive_capacity: Optional[int] = None

    def pareto_idx(self, space: DesignSpace = SPACE) -> np.ndarray:
        """Front design-index vectors (p, n_params)."""
        return space.flat_to_idx(self.pareto_ids)

    def stall_seeds(self, space: DesignSpace = SPACE) -> Dict[str, np.ndarray]:
        """Per-stall-class seed designs for bottleneck-guided DSE:
        {stall class -> (k', n_params) index vectors}, the best designs
        (under the engine's ``stall_rank`` key) whose dominant stall is that
        class.  A class no swept design was dominated by comes back EMPTY."""
        if self.stall_topk_ids is None:
            raise ValueError("sweep ran without stall_topk; no stall seeds")
        from repro_torch.perfmodel.critical_path import STALL_CLASSES
        out = {}
        for c, name in enumerate(STALL_CLASSES):
            ids = self.stall_topk_ids[c]
            out[name] = space.flat_to_idx(ids[ids >= 0])
        return out


class SweepEngine:
    """Chunked streaming evaluation of the full (or a partial) design space.

    Parameters
    ----------
    evaluator:
        A two-workload :class:`~repro_torch.perfmodel.evaluator.
        ModelEvaluator` (``[ttft, tpot]``); the sweep runs on its device
        and its models' op terms.
    stall_topk:
        When > 0, the chunk step also attributes stalls (TTFT workload) and
        keeps the `stall_topk` best designs per dominant stall class.
    stall_rank:
        Ranking key for the per-stall-class top-k: ``"ttft"`` (default) or
        ``"ref"`` — the minimax objective ratio vs the reference point.
    chunk_size:
        Designs per device step (default 131,072); on the ``cuda`` backend
        rounded up to whole 256-design kernel blocks.
    topk, filter_size, local_filter, archive_capacity:
        Running best-k per objective; rows of the on-device dominance filter
        synced from the host archive; per-objective (and log-sum) chunk-local
        killer rows; bound on the host Pareto archive.
    backend:
        ``"roofline"`` evaluates chunks with the torch op-term model;
        ``"cuda"`` through the ``ppa_eval`` kernel (bare roofline tier
        only).  ``None`` (default) follows the evaluator: ``"cuda"`` for
        an evaluator built with ``backend="cuda"``, else ``"roofline"``.
    """

    def __init__(self, evaluator, *,
                 chunk_size: Optional[int] = None, topk: int = 16,
                 filter_size: int = 128, local_filter: int = 32,
                 archive_capacity: Union[int, str, None] = 16_384,
                 ref_point: Optional[np.ndarray] = None,
                 backend: Optional[str] = None,
                 stall_topk: int = 0, stall_rank: str = "ttft"):
        if not hasattr(evaluator, "models"):
            raise TypeError("SweepEngine needs a ModelEvaluator, got "
                            f"{type(evaluator).__name__}")
        if len(evaluator.workloads) < 2:
            raise ValueError("sweep needs a two-workload evaluator "
                             "(ttft + tpot)")
        scenarios = getattr(evaluator, "scenarios", None)
        if scenarios is not None and len(scenarios) > 1:
            raise NotImplementedError(
                "portfolio (multi-scenario) sweeps are not ported yet")
        ttft_model = evaluator.models[evaluator.workloads[0]]
        tpot_model = evaluator.models[evaluator.workloads[1]]
        space = evaluator.space
        if backend is None:
            backend = "cuda" if evaluator.backend == "cuda" else "roofline"
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
        if backend == "cuda":
            for m in (ttft_model, tpot_model):
                if (m.op_overhead_s, m.nonoverlap, m.mem_efficiency) != (0.0, 0.0, 1.0):
                    raise ValueError(
                        "backend='cuda' implements the bare roofline tier; "
                        f"{type(m).__name__} carries compass-tier knobs the "
                        "kernel ignores — use backend='roofline'")
        if stall_rank not in ("ttft", "ref"):
            raise ValueError(f"stall_rank must be 'ttft' or 'ref', "
                             f"got {stall_rank!r}")
        if chunk_size is not None and not isinstance(chunk_size, int):
            raise NotImplementedError(
                f"chunk_size must be an int; {chunk_size!r} (auto-tuning) "
                "is not ported yet")
        self.ttft_model = ttft_model
        self.tpot_model = tpot_model
        self.evaluator = evaluator
        self.device = evaluator.device
        self.space = space
        self.size = space.size
        self.topk = int(topk)
        self.stall_topk = int(stall_topk)
        self.stall_rank = stall_rank
        self.filter_size = int(filter_size)
        self.local_filter = int(local_filter)
        self.backend = backend
        self.archive_capacity = archive_capacity
        self._cards = tuple(int(c) for c in space.cardinalities)

        if ref_point is None:
            ref_idx = space.encode_nearest(A100_REFERENCE)[None, :]
            ref_point = self.evaluator.objectives(ref_idx)[0]
        self.ref_point = np.asarray(ref_point, dtype=np.float64)
        self._ref = torch.as_tensor(self.ref_point, dtype=torch.float32,
                                    device=self.device)

        chunk_size = 131_072 if chunk_size is None else int(chunk_size)
        if backend == "cuda":
            # whole kernel blocks per chunk (ids past `stop` are masked)
            from repro_torch.kernels.ppa_eval.ops import BLOCK, kernel_tables
            chunk_size += (-chunk_size) % BLOCK
            self._tables = kernel_tables([ttft_model.wl, tpot_model.wl],
                                         self.device)
        self.chunk_size = int(chunk_size)
        self._iota = torch.arange(self.chunk_size, dtype=torch.int32,
                                  device=self.device)

    # ------------------------------------------------------------------
    def _chunk_eval(self, idx: torch.Tensor):
        """(c, n_params) int32 -> ((c, 3) objectives, dominant-stall (c,)
        or None).  Decode + hardware derivation run once per chunk; stall
        attribution only when stall_topk is enabled."""
        if self.backend == "cuda":
            from repro_torch.kernels.ppa_eval import ppa_eval_workloads
            lat, area, stall = ppa_eval_workloads(
                self.space.decode_values(idx), self._tables)
            ys = torch.stack([lat[0], lat[1], area], dim=1)
            dom = (torch.argmax(stall[0], dim=1).to(torch.int32)
                   if self.stall_topk else None)
            return ys, dom
        hw = derive_hardware(self.space.decode(idx))
        hwb = {kk: vv[:, None] for kk, vv in hw.items()}
        detail_t = "stalls" if self.stall_topk else "objectives"
        out_t = self.ttft_model._workload_batch(hwb, detail_t)
        out_p = self.tpot_model._workload_batch(hwb, "objectives")
        ys = torch.stack([out_t["latency"], out_p["latency"], hw["area_mm2"]],
                         dim=1)
        dom = (torch.argmax(out_t["stall"], dim=1).to(torch.int32)
               if self.stall_topk else None)
        return ys, dom

    def _step(self, carry: Dict[str, torch.Tensor], start: int, stop: int,
              filt: torch.Tensor):
        """One chunk step: unrank -> evaluate -> reduce."""
        ids = self._iota + start
        valid = ids < stop
        idx = _unrank(torch.clamp(ids, max=self.size - 1), self._cards)
        ys, dom = self._chunk_eval(idx)                       # (c, 3), (c,)
        ysm = torch.where(valid[:, None], ys, math.inf)

        # ---- reference-superiority count (exact, streaming) ----
        ref = self._ref
        sup = (ysm < ref[None, :]).all(dim=1)
        out = {"n_super": carry["n_super"] + sup.sum(),
               "n_eval": carry["n_eval"] + valid.sum()}

        # ---- running top-k per objective ----
        vals_o, ids_o = [], []
        for o in range(3):
            vals = torch.cat([carry["topk_val"][o], ysm[:, o]])
            cand = torch.cat([carry["topk_id"][o], ids])
            sel = _smallest_k(vals, self.topk)
            vals_o.append(vals[sel])
            ids_o.append(cand[sel])
        out["topk_val"] = torch.stack(vals_o)
        out["topk_id"] = torch.stack(ids_o)

        # ---- running top-k per dominant stall class (optional) ----
        if self.stall_topk:
            if self.stall_rank == "ref":
                # minimax objective ratio vs the reference (< 1 dominates)
                lat = (ysm / ref[None, :]).max(dim=1).values
            else:
                lat = ysm[:, 0]                               # rank by TTFT
            vals_c, ids_c = [], []
            for c in range(_N_STALL):
                lat_c = torch.where(dom == c, lat, math.inf)
                vals = torch.cat([carry["stall_topk_val"][c], lat_c])
                cand = torch.cat([carry["stall_topk_id"][c], ids])
                sel = _smallest_k(vals, self.stall_topk)
                vals_c.append(vals[sel])
                ids_c.append(torch.where(torch.isfinite(vals[sel]), cand[sel],
                                         -1))
            out["stall_topk_val"] = torch.stack(vals_c)
            out["stall_topk_id"] = torch.stack(ids_c)

        # ---- streaming Pareto reduction ----
        # archive filter (synced from host) + chunk-local killer rows:
        # per-objective minima and smallest log-products dominate most of
        # the chunk, so the cold-start chunk also reduces on device.
        L = self.local_filter
        locals_ = [ysm[_smallest_k(ysm[:, o], L)] for o in range(3)]
        logsum = _seq_sum(torch.log(torch.clamp(ysm, min=1e-300)))
        locals_.append(ysm[_smallest_k(logsum, L)])
        full_filt = torch.cat([filt] + locals_, dim=0)
        survivor = valid & ~_dominated_on_device(full_filt, ysm)
        return out, survivor, ys, ids

    def _fresh_carry(self) -> Dict[str, torch.Tensor]:
        k, dev = self.topk, self.device
        carry = {
            "n_super": torch.zeros((), dtype=torch.int64, device=dev),
            "n_eval": torch.zeros((), dtype=torch.int64, device=dev),
            "topk_val": torch.full((3, k), math.inf, dtype=torch.float32,
                                   device=dev),
            "topk_id": torch.full((3, k), -1, dtype=torch.int32, device=dev),
        }
        if self.stall_topk:
            carry["stall_topk_val"] = torch.full(
                (_N_STALL, self.stall_topk), math.inf, dtype=torch.float32,
                device=dev)
            carry["stall_topk_id"] = torch.full(
                (_N_STALL, self.stall_topk), -1, dtype=torch.int32,
                device=dev)
        return carry

    def _filter_from_archive(self, archive: ParetoArchive) -> np.ndarray:
        """Up to filter_size spread-out front rows, +inf padded."""
        rows = self.filter_size
        filt = np.full((rows, 3), np.inf, dtype=np.float32)
        n = len(archive)
        if n:
            order = np.argsort(archive.y.sum(axis=1), kind="stable")
            take = order[np.linspace(0, n - 1, min(n, rows))
                         .astype(np.int64)]
            filt[: take.size] = archive.y[take]
        return filt

    def fingerprint(self) -> str:
        """Identity of (space, workloads, knobs) — the reference's format."""
        parts = [
            str(self._cards), self.backend,
            _workload_fingerprint(self.ttft_model.wl),
            _workload_fingerprint(self.tpot_model.wl),
            type(self.ttft_model).__qualname__,
            type(self.tpot_model).__qualname__,
        ]
        if self.stall_rank != "ttft":
            parts.append(f"stall_rank={self.stall_rank}")
        return "|".join(parts)

    # ------------------------------------------------------------------
    def run(self, start: int = 0, stop: Optional[int] = None) -> SweepResult:
        """Sweep flat ids [start, stop) and reduce to a SweepResult."""
        stop = self.size if stop is None else min(int(stop), self.size)
        t0 = time.perf_counter()
        carry = self._fresh_carry()
        archive = ParetoArchive(3, capacity=self.archive_capacity)
        s = int(start)
        while s < stop:
            filt = torch.as_tensor(self._filter_from_archive(archive),
                                   device=self.device)
            carry, survivor, ys, ids = self._step(carry, s, stop, filt)
            keep = torch.nonzero(survivor).squeeze(1)
            if keep.numel():
                archive.insert(ys[keep].cpu().numpy(),
                               ids=ids[keep].cpu().numpy())
            s = min(s + self.chunk_size, stop)
        seconds = time.perf_counter() - t0
        n_eval = int(carry["n_eval"])
        stall_val = stall_id = None
        if self.stall_topk:
            stall_val = carry["stall_topk_val"].cpu().numpy()
            stall_id = carry["stall_topk_id"].cpu().numpy()
        order = np.argsort(archive.ids, kind="stable")
        return SweepResult(
            n_evaluated=n_eval,
            n_superior=int(carry["n_super"]),
            pareto_y=archive.y[order],
            pareto_ids=archive.ids[order],
            topk_val=carry["topk_val"].cpu().numpy(),
            topk_ids=carry["topk_id"].cpu().numpy(),
            ref_point=self.ref_point.copy(),
            seconds=seconds,
            points_per_sec=n_eval / max(seconds, 1e-9),
            archive_truncated=archive.truncated,
            stall_topk_val=stall_val,
            stall_topk_ids=stall_id,
            archive_capacity=archive.capacity,
        )
