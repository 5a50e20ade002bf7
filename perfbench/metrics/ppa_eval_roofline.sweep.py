"""ppa_eval against its bound: the bytes the window's sweeps need (each
valid design's eight fp32 parameters read once and its 8-float output row
per workload written once, and each launch's op tables read once) at
3.35 TB/s, over the device time of the kernels named ppa_eval_kernel in
the trace.  The byte bound is the larger: a design needs a few thousand
fp32 operations."""
from perfbench.costs import peaks
from perfbench.reference import dse

ROW_BYTES = 8 * 4           # a design's parameters, an output row, an op


def read(ctx):
    hits = [(n, t) for name, (n, t) in ctx.kernels.items()
            if "ppa_eval_kernel" in name]
    launches, seconds = sum(n for n, _ in hits), sum(t for _, t in hits)
    if not launches or seconds <= 0:
        return None
    m, mix = ctx.model, ctx.mix
    rows = len(dse.ops(m, mix["batch"], mix["seq"], mix["tp"], False)) \
        + len(dse.ops(m, mix["batch"], mix["seq"], mix["tp"], True,
                      mix["seq"] + mix["out_pos"]))
    nbytes = ctx.work * ROW_BYTES * (1 + 2) + launches * rows * ROW_BYTES
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / seconds
