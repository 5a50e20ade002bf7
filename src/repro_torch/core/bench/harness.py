"""Accuracy harness for the DSE Benchmark (paper Table 3).

Ground truth in the scored suites comes from the unified
:mod:`repro_torch.perfmodel.evaluator` contract (the generator computes
every answer through fused evaluator dispatches), so benchmark accuracy
and the live DSE loop exercise the same evaluation path.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.core.bench.generator import BenchmarkSuite
from repro_torch.core.llm import (LLMBackend, TASK_BOTTLENECK,
                                  TASK_PREDICTION, TASK_TUNING)

TASKS = (TASK_BOTTLENECK, TASK_PREDICTION, TASK_TUNING)
TASK_LABELS = {TASK_BOTTLENECK: "Bottleneck Analysis",
               TASK_PREDICTION: "Perf/Area Prediction",
               TASK_TUNING: "Parameter Tuning"}


def evaluate_backend(backend: LLMBackend, suite: BenchmarkSuite) -> Dict[str, float]:
    """Per-task accuracy of one backend."""
    acc = {}
    for task in TASKS:
        qs = suite.by_task(task)
        if not qs:
            acc[task] = float("nan")
            continue
        correct = sum(int(backend.choose(q) == q.answer) for q in qs)
        acc[task] = correct / len(qs)
    return acc


def accuracy_table(backends: Sequence[LLMBackend],
                   suite: BenchmarkSuite) -> List[Tuple[str, str, float]]:
    """Rows of (task_label, backend_name, accuracy) — Table 3 layout."""
    rows = []
    for task in TASKS:
        for b in backends:
            acc = evaluate_backend(b, suite)[task]
            rows.append((TASK_LABELS[task], b.name, acc))
    return rows
