"""The train step's share of the chip's fp32 peak: the model FLOPs of the
window's steps (costs.lm.train_flops: forward and backward, remat's
recompute not counted) over the window's seconds, against 495 TFLOP/s."""
from perfbench.costs import lm, peaks


def read(ctx):
    flops = lm.train_flops(ctx.model, ctx.mix["batch"], ctx.mix["seq"])
    return 100.0 * flops * ctx.units / ctx.window_s / peaks.FP32_MODEL_PEAK
