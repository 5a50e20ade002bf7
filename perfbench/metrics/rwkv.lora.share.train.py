"""Finch's data-dependent token shift's share of the device's busy time:
the stream seconds of the program's rwkv.lora device spans (inside each
rwkv.time_mix: the token shift, the mixes' LoRA, the five interpolations
and the decay LoRA), over the busy seconds.  Under remat a layer's forward
runs twice in a step, in the forward and again in the backward's
recompute: both runs are spans, and neither holds the backward."""
from perfbench import spans


def read(ctx):
    got = spans.attr_sums("rwkv.lora", "device_s")
    if got is None or ctx.busy_s <= 0:
        return None
    return 100.0 * got[0] / ctx.busy_s
