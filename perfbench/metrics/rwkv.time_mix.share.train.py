"""RWKV's time mix's share of the device's busy time: the stream seconds
of the program's rwkv.time_mix device spans (the whole time mix of a
layer: token shift, mixes, products, the WKV scan, the GroupNorm and the
output product, between CUDA events the program records), over the busy
seconds.  Under remat a layer's forward runs twice in a step, in the
forward and again in the backward's recompute: both runs are spans, and
neither holds the time mix's backward."""
from perfbench import spans


def read(ctx):
    got = spans.attr_sums("rwkv.time_mix", "device_s")
    if got is None or ctx.busy_s <= 0:
        return None
    return 100.0 * got[0] / ctx.busy_s
