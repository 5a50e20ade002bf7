"""The sweep engine's host time waiting for a chunk: the host ms of its
sweep.sync spans (torch.nonzero over the filter's survivors, where the
host waits for the card, and the survivors' copies) over the window's
chunks (sweep.chunk spans of the program's process tracer)."""
from perfbench import spans


def read(ctx):
    return spans.per_chunk_ms(["sweep.sync"])
