"""The sweep engine's host time waiting for a chunk: the host ms of its
sweep.sync spans (pareto_reduce launched over the filter's survivors, the
host's one wait for the card, and the copy of the entering rows and the
dead incumbents' flags) over the window's chunks (sweep.chunk spans of
the program's process tracer)."""
from perfbench import spans


def read(ctx):
    return spans.per_chunk_ms(["sweep.sync"])
