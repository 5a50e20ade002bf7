"""The share of the expert GEMMs' rows that carry a token: the kept
assignments over the dispatch buffer's slots (G x experts with pad x
capacity), summed over the program's moe.dispatch spans of the window."""
from perfbench import spans


def read(ctx):
    got = spans.attr_sums("moe.dispatch", "kept", "slots")
    if got is None or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]
