"""The sweep engine's host time in its Pareto archive: the host ms of the
sweep.filter spans (the dominance filter drawn from the host archive and
copied to the card with the archive's rows, in one copy) and the
sweep.insert spans (ParetoArchive.apply of the entering rows and the dead
flags the card's reduction found) over the window's chunks (sweep.chunk
spans of the program's process tracer)."""
from perfbench import spans


def read(ctx):
    return spans.per_chunk_ms(["sweep.filter", "sweep.insert"])
