"""rwkv6_scan's forward against its bound: the launches' least time
(costs.rwkv6.scan_fwd_cost at 495 TFLOP/s and 3.35 TB/s, one forward per
wkv_out launch) over the summed device time of the wkv_state and wkv_out
kernels in the trace, matched by whole function name (none of the
backward's wkv_bwd_* kernels counts).  Under remat a train step runs each
layer's forward twice: both count."""
from perfbench.costs import peaks, rwkv6


def read(ctx):
    launches, seconds = rwkv6.launches_and_seconds(
        ctx.kernels, rwkv6.FWD_KERNELS, rwkv6.FWD_COUNTED)
    if not launches or seconds <= 0:
        return None
    h, hd = rwkv6.heads(ctx.model)
    ops, nbytes = rwkv6.scan_fwd_cost(ctx.mix["batch"], ctx.mix["seq"], h,
                                      hd, 4)
    return 100.0 * launches * peaks.bound_s(ops, nbytes) / seconds
