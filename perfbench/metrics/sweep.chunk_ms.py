"""The sweep engine's own wall time per chunk step (its sweep_chunk_s
histogram, sum over count, across the window's sweeps), in ms."""


def read(ctx):
    if not getattr(ctx.job, "chunks", 0):
        return None
    return 1e3 * ctx.job.chunk_s / ctx.job.chunks
