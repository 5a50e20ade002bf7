"""The cost functions against counts made by hand."""
import json
from pathlib import Path

import pytest

from perfbench.costs import lm, peaks

CONF = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return json.loads((CONF / f"{name}.json").read_text())["model"]


def test_qwen2moe_prefill_is_21_1_tflop():
    # per layer: q, k, v, o 4 x 2048^2; router 2048 x 60; 4 routed experts
    # of 3 x 2048 x 1408; the shared expert 3 x 2048 x 5632; head 2048 x
    # 151936; causal attention 4 x 16 heads x 128 x 4096 x 4097 / 2
    layer = 4 * 2048 * 2048 + 2048 * 60 + 4 * 3 * 2048 * 1408 \
        + 3 * 2048 * 5632
    dense = 2 * (24 * layer + 2048 * 151936) * 4096
    attn = 4 * 16 * 128 * (4096 * 4097 // 2) * 24
    assert lm.prefill_flops(model("qwen2-moe-a2.7b"), 1, 4096) \
        == dense + attn
    assert lm.prefill_flops(model("qwen2-moe-a2.7b"), 1, 4096) / 1e12 \
        == pytest.approx(21.128, abs=1e-3)


def test_qwen25_6l_prefill_and_train():
    layer = 2 * 5120 * 5120 + 2 * 5120 * 1024 + 3 * 5120 * 13824
    dense = 2 * (6 * layer + 5120 * 152064) * 4096
    attn = 4 * 40 * 128 * (4096 * 4097 // 2) * 6
    a = model("qwen2.5-14b-6l")
    assert lm.prefill_flops(a, 1, 4096) == dense + attn
    assert lm.train_flops(a, 1, 4096) == 3 * (dense + attn)
    assert lm.prefill_flops(a, 1, 4096) / 1e12 == pytest.approx(20.938,
                                                                abs=1e-3)


def test_flash_costs_and_bounds():
    ops, nbytes = lm.flash_fwd_cost(1, 4096, 16, 16, 128, 4)
    assert ops == 4 * 16 * 128 * 4096 * 4097 // 2          # 68.7 GFLOP
    assert nbytes == (2 * 4096 * 16 * 128 * 2) * 4 + 4 * 16 * 4096
    # bound by operations at 495 TFLOP/s: 0.1389 ms
    assert peaks.bound_s(ops, nbytes) == pytest.approx(ops / 495e12)
    bops, bbytes = lm.flash_bwd_cost(1, 4096, 40, 8, 128, 4)
    assert bops == 10 * 40 * 128 * 4096 * 4097 // 2
    assert bbytes == (4 * 4096 * 40 * 128 + 4 * 4096 * 8 * 128) * 4 \
        + 4 * 40 * 4096
    assert peaks.bound_s(bops, bbytes) * 1e3 == pytest.approx(0.86788,
                                                               abs=1e-5)


def test_bytes_bound_wins_when_operations_are_few():
    assert peaks.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
