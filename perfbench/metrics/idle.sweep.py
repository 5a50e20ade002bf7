"""The device's idle share of the traced window: 1 - the seconds in which
an operation ran on the device (the union of their intervals) over the
window's seconds."""


def read(ctx):
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
