"""flash_attention's forward against its bound: the launches' least time
(costs.lm.flash_fwd_cost at 495 TFLOP/s and 3.35 TB/s, each launch one
layer's causal attention of the cell's shape) over the device time of the
kernels named fa_fwd in the trace."""
from perfbench.costs import lm, peaks


def read(ctx):
    hits = [(n, t) for name, (n, t) in ctx.kernels.items()
            if "fa_fwd" in name]
    launches, seconds = sum(n for n, _ in hits), sum(t for _, t in hits)
    if not launches or seconds <= 0:
        return None
    m = ctx.model
    ops, nbytes = lm.flash_fwd_cost(ctx.mix["batch"], ctx.mix["seq"],
                                    m["n_heads"], m["n_kv_heads"],
                                    m["head_dim"], 4)
    return 100.0 * launches * peaks.bound_s(ops, nbytes) / seconds
