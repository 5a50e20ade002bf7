"""AdamW's share of the device's busy time: the stream time between CUDA
events around each call of the train step's adamw_update (wrapped from
outside in repro_torch.launch.steps for the window), over the busy
seconds."""
RANGES = [("repro_torch.launch.steps", "adamw_update", "adamw_update")]


def read(ctx):
    calls = ctx.ranges.get("adamw_update") or []
    if not calls or ctx.busy_s <= 0:
        return None
    return 100.0 * sum(calls) / ctx.busy_s
