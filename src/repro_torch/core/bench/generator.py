"""DSE Benchmark generator (paper §4).

Produces the three task families as multiple-choice questions whose ground
truth is *computed from the analytical models* (not hand-labeled):

* bottleneck analysis  (paper: 308 questions) — given a design, its stall
  report and an objective, which parameter adjustment helps most?  Ground
  truth: evaluate every candidate move-set on the model, pick the best.
* perf/area prediction (paper: 127 questions) — given a sensitivity table
  around a reference design and a perturbed design, predict the metric.
  Distractors include the paper's reported failure mode (delta computed
  against a zero baseline instead of the sensitivity reference).
* parameter tuning     (paper: 30 questions) — given an initial design,
  constraints and an objective, pick the best full configuration.

Workload targets range from primitive operators (matmul, layernorm, ...) to
the full GPT-3 layer, per the paper ("ranging from primitive operators to
full workload").

Every answer is computed through fused evaluator dispatches on ``device``
(the CUDA device by default), on the roofline tier the reference's
generator uses; the question stream itself is numpy on the host, so the
same seed gives the same suite on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.llm import (MCQuery, TASK_BOTTLENECK,
                                  TASK_PREDICTION, TASK_TUNING)
from repro_torch.core.quane import sensitivity_analysis
from repro_torch.device import DeviceLike
from repro_torch.perfmodel import workload as W
from repro_torch.perfmodel.critical_path import STALL_CLASSES
from repro_torch.perfmodel.designspace import DesignSpace, SPACE
from repro_torch.perfmodel.evaluator import make_evaluator
from repro_torch.perfmodel.hardware import AREA_MODEL_SOURCE
from repro_torch.perfmodel.roofline import SRAM_FEED_WORDS_PER_KB
from repro_torch.perfmodel.workload import (Workload, _allreduce, _matmul,
                                            _vector)


# ---- workload targets: primitives and the full-layer workloads -----------

def _primitive_workloads() -> List[Workload]:
    out = []
    for m, k, n in ((4096, 4096, 4096), (8, 12288, 4608), (16384, 12288, 6144),
                    (2048, 128, 2048), (512, 512, 512)):
        out.append(Workload(f"matmul-{m}x{k}x{n}", [_matmul("mm", m, k, n)]))
    out.append(Workload("layernorm-16Mx", [_vector("ln", 16 << 20, 8.0)]))
    out.append(Workload("softmax-64Mx", [_vector("sm", 64 << 20, 6.0)]))
    out.append(Workload("allreduce-192MB", [_allreduce("ar", 96 << 20)]))
    out.append(Workload("kvread-600MB", [W.Op("kv", W.MEMCPY, bytes=600e6)]))
    return out


def _full_workloads() -> List[Workload]:
    return [W.gpt3_layer_prefill(), W.gpt3_layer_decode()]


@dataclasses.dataclass
class BenchmarkSuite:
    questions: List[MCQuery]

    def by_task(self, task: str) -> List[MCQuery]:
        return [q for q in self.questions if q.task == task]


# ---------------------------------------------------------------------------

PRIMARY = {"tensor_compute": "sa_dim", "vector_compute": "vector_width",
           "memory_bw": "mem_channels", "interconnect": "link_count"}

# coarse relevance sets used to build plausible-but-wrong distractors
RELEVANT = {
    "tensor_compute": ("sa_dim", "core_count", "sublane_count", "sram_kb"),
    "vector_compute": ("vector_width", "core_count", "sublane_count"),
    "memory_bw": ("mem_channels", "gbuf_mb"),
    "interconnect": ("link_count",),
}


def _sa_headroom(space: DesignSpace, idx: np.ndarray) -> bool:
    v = space.decode_np(idx)
    names = list(space.names)
    sa_choices = space.choices[names.index("sa_dim")]
    sa = float(v["sa_dim"])
    bigger = next((c for c in sa_choices if c > sa), sa)
    return (SRAM_FEED_WORDS_PER_KB * float(v["sram_kb"])
            / (bigger * float(v["sublane_count"]))) >= 0.5


def _apply_moves(space: DesignSpace, idx: np.ndarray, moves) -> np.ndarray:
    out = idx.copy()
    for p, d in moves:
        pi = space.names.index(p)
        out[pi] = np.clip(out[pi] + d, 0, space.cardinalities[pi] - 1)
    return out


def generate_bottleneck(n: int = 308, seed: int = 0,
                        space: DesignSpace = SPACE,
                        device: DeviceLike = None) -> List[MCQuery]:
    rng = np.random.default_rng(seed)
    wls = _primitive_workloads() + _full_workloads()
    # one single-workload evaluator per target
    evs = {w.name: make_evaluator({"lat": w}, space=space, device=device)
           for w in wls}
    out: List[MCQuery] = []
    while len(out) < n:
        wl = wls[int(rng.integers(len(wls)))]
        ev = evs[wl.name]
        idx = space.sample(rng, 1)[0]
        rep = ev.stalls(idx).stall_report()
        dom = rep.dominant
        primary = PRIMARY[dom]
        rel = RELEVANT[dom]
        irrelevant = [p for p in space.names if p not in rel]

        cand: List[List] = [[(primary, +1)]]
        cand.append([(primary, -1)])                                  # wrong direction
        cand.append([(PRIMARY[_other(dom, rng)], +1)])                # wrong resource
        cand.append([(primary, +1),
                     (str(rng.choice(irrelevant)), +1)])              # + irrelevant
        news = np.stack([_apply_moves(space, idx, c) for c in cand]
                        + [_apply_moves(space, idx, [("sa_dim", +1)]), idx])
        y_all = ev.objectives(news)                     # (rows, 2): lat, area
        # headroom: does growing the systolic array alone still help here?
        # (the corrective rule distilled from observed failure cases)
        sa_helps = bool(y_all[-2, 0] < y_all[-1, 0] * 0.999)
        y = y_all[:len(cand)]
        # ground truth: best latency; ties broken toward fewer moves and
        # lower area (an adjustment that spends area on an irrelevant
        # resource for the same latency is NOT the right answer)
        lat = np.round(y[:, 0] / y[:, 0].min(), 4)
        keys = [(lat[i], len(cand[i]), float(y[i, 1]))
                for i in range(len(cand))]
        truth = int(min(range(len(cand)), key=lambda i: keys[i]))
        perm = rng.permutation(len(cand))
        cand = [cand[i] for i in perm]
        truth = int(np.where(perm == truth)[0][0])
        out.append(MCQuery(
            task=TASK_BOTTLENECK,
            prompt=(f"Workload: {wl.name}. Design {_fmt_design(space, idx)}.\n"
                    f"{rep.as_prompt()}\n"
                    "Objective: minimize latency. Which adjustment helps most?"),
            options=[_fmt_moves(c) for c in cand],
            payload={
                "dominant_stall": dom,
                "option_params": cand,
                "relevant": {dom: rel},
                "sa_headroom": sa_helps,
            },
            answer=truth,
        ))
    return out


def generate_prediction(n: int = 127, seed: int = 1,
                        space: DesignSpace = SPACE,
                        device: DeviceLike = None) -> List[MCQuery]:
    rng = np.random.default_rng(seed)
    wl = W.gpt3_layer_prefill()
    dec = W.gpt3_layer_decode()
    ev = make_evaluator({"ttft": wl, "tpot": dec}, space=space,
                        device=device)
    out: List[MCQuery] = []
    while len(out) < n:
        ref = space.sample(rng, 1)[0]
        sens = sensitivity_analysis(ev, ref, space=space)
        metric = ("ttft", "tpot", "area")[int(rng.integers(3))]
        # perturb 1-3 params by +-1 step
        k = int(rng.integers(1, 4))
        params = rng.choice(space.n_params, size=k, replace=False)
        steps: Dict[str, int] = {}
        new = ref.copy()
        for pi in params:
            d = int(rng.choice([-1, 1]))
            tgt = np.clip(new[pi] + d, 0, space.cardinalities[pi] - 1)
            if tgt != new[pi]:
                steps[space.names[pi]] = int(tgt - new[pi])
                new[pi] = tgt
        if not steps:
            continue
        col = {"ttft": 0, "tpot": 1, "area": 2}[metric]
        y = ev.objectives(np.stack([ref, new]))       # one fused dispatch
        truth_val = float(y[1, col])
        base_val = float(y[0, col])
        lin = base_val + sum(sens.delta[p][metric] * d for p, d in steps.items())
        zero_baseline = lin - base_val        # the paper-reported failure mode
        opts = [truth_val, zero_baseline,
                base_val * (1 + 0.35 * rng.standard_normal()),
                lin * (1 + 0.4 * abs(rng.standard_normal()) + 0.1)]
        perm = rng.permutation(4)
        vals = [opts[i] for i in perm]
        truth = int(np.where(perm == 0)[0][0])
        sens_view = {p: sens.delta[p][metric] for p in steps}
        out.append(MCQuery(
            task=TASK_PREDICTION,
            prompt=(f"Area model source:\n{AREA_MODEL_SOURCE}\n"
                    f"Reference design {_fmt_design(space, ref)} has "
                    f"{metric}={base_val:.6e}.\n{sens.as_prompt()}\n"
                    f"New design changes: {steps}. Predict {metric}."),
            options=[f"{v:.6e}" for v in vals],
            payload={
                "reference_metric": base_val,
                "sensitivity": sens_view,
                "delta_steps": steps,
                "option_values": vals,
            },
            answer=truth,
        ))
    return out


def generate_tuning(n: int = 30, seed: int = 2,
                    space: DesignSpace = SPACE,
                    device: DeviceLike = None) -> List[MCQuery]:
    rng = np.random.default_rng(seed)
    wl = W.gpt3_layer_prefill()
    dec = W.gpt3_layer_decode()
    ev = make_evaluator({"ttft": wl, "tpot": dec}, space=space,
                        device=device)
    out: List[MCQuery] = []
    while len(out) < n:
        idx = space.sample(rng, 1)[0]
        rep = ev.stalls(idx).stall_report("ttft")
        dom = rep.dominant
        primary = PRIMARY[dom]
        sens = sensitivity_analysis(ev, idx, space=space)
        crit = sens.criticality("ttft")
        least = min(crit, key=crit.get)
        most = max(crit, key=crit.get)
        area_budget = rep.area * 1.02

        cand = [
            [(primary, +1), (least, -1)],        # mitigate + trade least-critical
            [(primary, +1), (most, -1)],         # trades away the critical resource
            [(least, +1)],                        # adjusts a non-critical resource
            [(primary, +1), (least, -1), (most, -1)],  # over-aggressive
        ]
        news = [_apply_moves(space, idx, c) for c in cand]
        y = ev.objectives(np.stack(news))             # one fused dispatch
        lat, area = y[:, 0], y[:, 2]
        feasible = area <= area_budget
        score = np.where(feasible, lat, lat * 100.0)
        truth = int(np.argmin(score))
        perm = rng.permutation(len(cand))
        cand = [cand[i] for i in perm]
        truth = int(np.where(perm == truth)[0][0])
        constraints_ok = [bool(feasible[i]) for i in perm]
        out.append(MCQuery(
            task=TASK_TUNING,
            prompt=(f"Initial design {_fmt_design(space, idx)}.\n{rep.as_prompt()}\n"
                    f"{sens.as_prompt()}\n"
                    f"Constraint: area <= {area_budget:.0f} mm2. "
                    "Objective: minimize TTFT. Which tuning is best?"),
            options=[_fmt_moves(c) for c in cand],
            payload={
                "dominant_stall": dom,
                "option_params": cand,
                "criticality": crit,
                "sa_headroom": _sa_headroom(space, idx),
                "constraints_ok": constraints_ok,
                "sensitivity": {p: dict(sens.delta[p]) for p in space.names},
            },
            answer=truth,
        ))
    return out


def generate_suite(n_bottleneck: int = 308, n_prediction: int = 127,
                   n_tuning: int = 30, seed: int = 0,
                   device: DeviceLike = None) -> BenchmarkSuite:
    return BenchmarkSuite(
        questions=(generate_bottleneck(n_bottleneck, seed, device=device)
                   + generate_prediction(n_prediction, seed + 1,
                                         device=device)
                   + generate_tuning(n_tuning, seed + 2, device=device)))


# ---------------------------------------------------------------------------

def _other(dom: str, rng) -> str:
    others = [c for c in STALL_CLASSES if c != dom]
    return str(rng.choice(others))


def _fmt_design(space: DesignSpace, idx) -> str:
    v = space.decode_np(np.asarray(idx))
    return "{" + ", ".join(f"{k}={int(v[k])}" for k in space.names) + "}"


def _fmt_moves(moves) -> str:
    return ", ".join(f"{p}{'+' if d > 0 else '-'}1" for p, d in moves)
