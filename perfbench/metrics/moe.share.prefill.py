"""The MoE block's share of the device's busy time: the stream time
between CUDA events around each call of repro_torch.models.moe.moe_block
(wrapped from outside for the window), over the busy seconds."""
RANGES = [("repro_torch.models.moe", "moe_block", "moe_block")]


def read(ctx):
    calls = ctx.ranges.get("moe_block") or []
    if not calls or ctx.busy_s <= 0:
        return None
    return 100.0 * sum(calls) / ctx.busy_s
