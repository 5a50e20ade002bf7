"""The prefill step's share of the chip's fp32 peak: the model FLOPs of
the window's prefills (``prefill_flops`` of the cost module the
configuration names) over the window's seconds, against 495 TFLOP/s
(TF32, the fastest route for fp32 inputs)."""
from perfbench import costs
from perfbench.costs import peaks


def read(ctx):
    flops = costs.of(ctx.conf).prefill_flops(ctx.model, ctx.mix["batch"],
                                             ctx.mix["seq"])
    return 100.0 * flops * ctx.units / ctx.window_s / peaks.FP32_MODEL_PEAK
