"""Rows a sweep chunk's archive receives: the sweep.sync spans' entered
attr (the filter survivors that no other survivor and no archive row
dominates) summed, over the window's chunks (sweep.chunk spans of the
program's process tracer).  A program whose spans carry no such attr
gives nothing."""
from perfbench import spans


def read(ctx):
    got = spans.attr_sums("sweep.sync", "entered")
    chunks = len(spans.named("sweep.chunk"))
    if got is None or not chunks:
        return None
    return got[0] / chunks
