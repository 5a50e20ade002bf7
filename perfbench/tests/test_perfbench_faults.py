"""A run with the timed path broken underneath comes out not correct.
The look for a card is skipped (a CPU run at a small size); the rest of
the run is the harness's own."""
import time

import pytest
import torch

from perfbench import bench, faults
from perfbench.tests._small import CELLS, SMALL_LIMITS


def run(cell, fault=None, seed=11):
    model, mix = CELLS[cell]
    return bench.run(cell, seed, 0.05, False, time.perf_counter(),
                     device="cpu", model_override=model,
                     traffic_override=mix, fault=fault,
                     limits_override=SMALL_LIMITS.get(cell))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] is True and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in ("qwen2moe.prefill", "qwen25.prefill")
    for fault in (faults.answer_altered, faults.answer_shifted,
                  faults.answer_tail_altered)
] + [("qwen2moe.prefill", faults.route_altered)])
def test_prefill_faults(cell, fault):
    r = run(cell, fault)
    assert r["correct"] is False
    if fault is faults.route_altered:
        # the reference follows the altered routing: only the routing's
        # own check sees it
        assert not r["checks"]["route_flip_margin"]["value"] <= \
            r["checks"]["route_flip_margin"]["limit"]


def test_route_fault_leaves_the_program_as_it_was():
    from repro_torch.models import moe
    before = moe.route
    run("qwen2moe.prefill", faults.route_altered)
    assert moe.route is before


@pytest.mark.parametrize("fault", [faults.state_unchanged, faults.half_batch,
                                   faults.token_altered])
def test_train_faults(fault):
    assert run("qwen25.train", fault)["correct"] is False


@pytest.mark.parametrize("fault", [faults.sweep_state_unchanged,
                                   faults.sweep_half_chunk,
                                   faults.sweep_answer_altered])
def test_sweep_faults(fault):
    assert run("qwen2moe.dse_sweep", fault)["correct"] is False


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures the CUDA "
                    "port)")
    from perfbench import run as cli
    assert cli.main(["--workload", "qwen25.prefill", "--seed", "5",
                     "--seconds", "2", "--trace", "0"]) == 0
