"""Rows a sweep chunk copies to the host: the sweep.sync spans' survivors
attr (the designs no filter row dominates) summed, over the window's
chunks (sweep.chunk spans of the program's process tracer)."""
from perfbench import spans


def read(ctx):
    got = spans.attr_sums("sweep.sync", "survivors")
    chunks = len(spans.named("sweep.chunk"))
    if got is None or not chunks:
        return None
    return got[0] / chunks
