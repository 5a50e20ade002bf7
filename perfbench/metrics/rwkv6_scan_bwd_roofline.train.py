"""rwkv6_scan's backward against its bound: the launches' least time
(costs.rwkv6.scan_bwd_cost at 495 TFLOP/s and 3.35 TB/s, one backward per
wkv_bwd_du launch) over the summed device time of the wkv_bwd_state,
wkv_bwd and wkv_bwd_du kernels in the trace, matched by whole function
name."""
from perfbench.costs import peaks, rwkv6


def read(ctx):
    launches, seconds = rwkv6.launches_and_seconds(
        ctx.kernels, rwkv6.BWD_KERNELS, rwkv6.BWD_COUNTED)
    if not launches or seconds <= 0:
        return None
    h, hd = rwkv6.heads(ctx.model)
    ops, nbytes = rwkv6.scan_bwd_cost(ctx.mix["batch"], ctx.mix["seq"], h,
                                      hd, 4)
    return 100.0 * launches * peaks.bound_s(ops, nbytes) / seconds
