"""The sweep engine's host time enqueuing a chunk's kernels: the host ms
of its sweep.step spans (the chunk step, which only launches) over the
window's chunks (sweep.chunk spans of the program's process tracer)."""
from perfbench import spans


def read(ctx):
    return spans.per_chunk_ms(["sweep.step"])
