"""The MoE dispatch's share of the device's busy time: the stream seconds
of the program's moe.dispatch device spans (route through the dispatch
buffer's index_put_, between CUDA events the program records), over the
busy seconds."""
from perfbench import spans


def read(ctx):
    got = spans.attr_sums("moe.dispatch", "device_s")
    if got is None or ctx.busy_s <= 0:
        return None
    return 100.0 * got[0] / ctx.busy_s
