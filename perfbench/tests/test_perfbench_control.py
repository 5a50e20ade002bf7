"""The comparison's control at a small size: the reference in the
precision below the configuration's (TF32 for fp32 with TF32 off, here
each product's inputs rounded to TF32; bfloat16 for the sweep's fp32
model) put in the program's place reads at least three times what the
program reads on one of the cell's numbers.  (On the chip, at the cells'
own sizes, the control's readings set the limits' upper ends: PERF.md.)"""
import pytest

from perfbench import bench, calibrate
from perfbench.tests._small import CELLS, small


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_reads_above_the_program(cell, seed):
    s = small(cell)
    r = calibrate.readings(cell, seed, 0.05, True, device="cpu",
                           model_override=s["model"],
                           traffic_override=s["traffic"])
    apart = [n for n in bench.limits(cell)["compare"]
             if r["control"][n] > 0
             and r["control"][n] >= 3 * r["program"][n]]
    assert apart, (r["program"], r["control"])
