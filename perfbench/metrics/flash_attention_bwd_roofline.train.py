"""flash_attention's backward against its bound: the launches' least time
(costs.lm.flash_bwd_cost at 495 TFLOP/s and 3.35 TB/s, one backward per
fa_bwd_dkdv launch) over the summed device time of the fa_bwd_* kernels
in the trace."""
from perfbench.costs import lm, peaks


def read(ctx):
    hits = [(name, n, t) for name, (n, t) in ctx.kernels.items()
            if "fa_bwd" in name]
    launches = sum(n for name, n, _ in hits if "fa_bwd_dkdv" in name)
    seconds = sum(t for _, _, t in hits)
    if not launches or seconds <= 0:
        return None
    m = ctx.model
    ops, nbytes = lm.flash_bwd_cost(ctx.mix["batch"], ctx.mix["seq"],
                                    m["n_heads"], m["n_kv_heads"],
                                    m["head_dim"], 4)
    return 100.0 * launches * peaks.bound_s(ops, nbytes) / seconds
