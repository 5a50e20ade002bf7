"""The train step's share of the chip's fp32 peak: the model FLOPs of the
window's steps (``train_flops`` of the cost module the configuration
names: forward and backward, remat's recompute not counted) over the
window's seconds, against 495 TFLOP/s."""
from perfbench import costs
from perfbench.costs import peaks


def read(ctx):
    flops = costs.of(ctx.conf).train_flops(ctx.model, ctx.mix["batch"],
                                           ctx.mix["seq"])
    return 100.0 * flops * ctx.units / ctx.window_s / peaks.FP32_MODEL_PEAK
