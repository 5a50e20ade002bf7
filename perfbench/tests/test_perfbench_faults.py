"""A run with the timed path broken underneath comes out not correct.
The look for a card is skipped (a CPU run at a small size); the rest of
the run is the harness's own.  Each cell gets the faults of its mix's
kind, and an MoE prefill cell the altered routing too."""
import time

import pytest
import torch

from perfbench import bench, faults
from perfbench.tests._small import CELLS, cells_of, has_experts, small


def run(cell, fault=None, seed=11):
    s = small(cell)
    return bench.run(cell, seed, 0.05, False, time.perf_counter(),
                     device="cpu", model_override=s["model"],
                     traffic_override=s["traffic"], fault=fault,
                     limits_override=s["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] is True and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in cells_of("prefill")
    for fault in (faults.answer_altered, faults.answer_shifted,
                  faults.answer_tail_altered)
] + [(cell, faults.route_altered) for cell in cells_of("prefill")
     if has_experts(cell)])
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
    for cell in cells_of("train"):
        assert run(cell, fault)["correct"] is False, cell


@pytest.mark.parametrize("fault", [faults.sweep_state_unchanged,
                                   faults.sweep_half_chunk,
                                   faults.sweep_answer_altered])
def test_sweep_faults(fault):
    for cell in cells_of("sweep"):
        assert run(cell, fault)["correct"] is False, cell


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures the CUDA "
                    "port)")
    from perfbench import run as cli
    assert cli.main(["--workload", "qwen25.prefill", "--seed", "5",
                     "--seconds", "2", "--trace", "0"]) == 0
