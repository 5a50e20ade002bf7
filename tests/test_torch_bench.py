"""The DSE Benchmark (paper Table 3) on the port against the reference's:
the generated questions, options and answers, the five backends'
accuracies, and the external-model adapter's wire format (no network)."""
import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from repro.core import llm as j_llm
from repro.core.bench import accuracy_table as j_accuracy_table
from repro.core.bench import evaluate_backend as j_evaluate_backend
from repro.core.bench import generate_suite as j_generate_suite
from repro_torch.core.bench import (BenchmarkSuite, accuracy_table,
                                    evaluate_backend, generate_bottleneck,
                                    generate_suite)
from repro_torch.core.bench.harness import TASK_LABELS, TASKS
from repro_torch.core.llm import (TASK_BOTTLENECK, DegradedOracle,
                                  ExternalLLM, MCQuery, RuleOracle)

torch.set_num_threads(1)

SIZES = (12, 8, 4)


def _backends(rule, degraded):
    """The reference bench's five backends (benchmarks/bench_dse_benchmark)."""
    return [rule(enhanced=True), rule(enhanced=False),
            degraded(0.18, seed=0, enhanced=True, name="qwen3-proxy"),
            degraded(0.30, seed=1, enhanced=True, name="phi4-proxy"),
            degraded(0.50, seed=2, enhanced=False, name="llama31-proxy")]


# QuanE's deltas are differences of fp32 objectives of neighbouring designs:
# a 1-ULP difference in an objective (area, ~6e-8 relative) moves a small
# delta by far more than 1e-6 relative (2e-5 measured on this suite).  Their
# rendered text (4 digits) and every answer taken from them are exact.
RTOL = {"sensitivity": 1e-4}


def _same_payload(a, b, rtol=1e-6):
    """Structure, ints, strings and flags equal; floats at rtol 1e-6."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_payload(a[k], b[k], RTOL.get(k, rtol))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_payload(x, y, rtol)
    elif isinstance(a, (float, np.floating)):
        assert float(a) == pytest.approx(float(b), rel=rtol, abs=1e-30)
    else:
        assert a == b


@pytest.fixture(scope="module")
def suites():
    return generate_suite(*SIZES, device="cpu"), j_generate_suite(*SIZES)


def test_suite_questions_equal_the_reference(suites):
    port, ref = suites
    assert isinstance(port, BenchmarkSuite)
    assert len(port.questions) == len(ref.questions) == sum(SIZES)
    for task, n in zip(TASKS, SIZES):
        assert len(port.by_task(task)) == n
    for a, b in zip(port.questions, ref.questions):
        assert a.task == b.task
        assert a.prompt == b.prompt
        assert a.options == b.options
        assert a.answer == b.answer
        assert a.render() == b.render()
        _same_payload(a.payload, b.payload)


def test_backend_accuracies_equal_the_reference(suites):
    port, ref = suites
    rows = accuracy_table(_backends(RuleOracle, DegradedOracle), port)
    want = j_accuracy_table(_backends(j_llm.RuleOracle, j_llm.DegradedOracle),
                            ref)
    assert rows == want
    assert [r[0] for r in rows[::5]] == [TASK_LABELS[t] for t in TASKS]
    acc = evaluate_backend(RuleOracle(enhanced=True), port)
    assert acc == j_evaluate_backend(j_llm.RuleOracle(enhanced=True), ref)
    assert all(0.0 <= v <= 1.0 for v in acc.values())


def test_generation_is_seeded_and_empty_tasks_score_nan():
    a = generate_bottleneck(3, seed=4, device="cpu")
    b = generate_bottleneck(3, seed=4, device="cpu")
    assert [q.prompt for q in a] == [q.prompt for q in b]
    assert [q.answer for q in a] == [q.answer for q in b]
    acc = evaluate_backend(RuleOracle(), BenchmarkSuite(questions=a))
    assert np.isnan(acc["perf_area_prediction"])
    assert a[0].task == TASK_BOTTLENECK


class _Answer:
    def __init__(self, text: str):
        self._body = io.BytesIO(json.dumps(
            {"choices": [{"message": {"content": text}}]}).encode())

    def __enter__(self):
        return self._body

    def __exit__(self, *exc):
        return False


# the answer's letter is read from its first 8 characters only, first
# option first: "answer: D" reads as no letter, "Answer: D" as A
@pytest.mark.parametrize("reply,want", [("C", 2), ("(B) because", 1),
                                        (" D.", 3), ("answer: D", 0),
                                        ("Answer: D", 0), ("none", 0)])
def test_external_llm_wire_format_equals_the_reference(monkeypatch, reply,
                                                       want):
    sent = []

    def fake_urlopen(req, *a, **kw):
        sent.append((req.full_url, req.data, dict(req.header_items())))
        return _Answer(reply)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    q = MCQuery(task=TASK_BOTTLENECK, prompt="Which adjustment helps most?",
                options=["sa_dim+1", "sa_dim-1", "link_count+1",
                         "mem_channels+1"], payload={})
    jq = j_llm.MCQuery(task=q.task, prompt=q.prompt, options=q.options,
                       payload={})
    url = "http://localhost:1/v1/chat/completions"
    port = ExternalLLM(url, "some-model", api_key="k")
    ref = j_llm.ExternalLLM(url, "some-model", api_key="k")
    assert port.name == ref.name == "external:some-model"
    assert port.choose(q) == ref.choose(jq) == want
    assert sent[0] == sent[1]
    body = json.loads(sent[0][1])
    assert body["model"] == "some-model"
    assert body["messages"][1]["content"] == q.render()
