"""The share of the router's assignments dropped past the capacity: 100 -
100 x kept over assigned, summed over the program's moe.dispatch spans of
the window."""
from perfbench import spans


def read(ctx):
    got = spans.attr_sums("moe.dispatch", "kept", "assigned")
    if got is None or got[1] <= 0:
        return None
    return 100.0 - 100.0 * got[0] / got[1]
