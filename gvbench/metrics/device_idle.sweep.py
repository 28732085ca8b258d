"""The share of the profiled window in which no kernel, copy or fill ran on
the card (one minus the union of device intervals over the window), in the
sweep cells."""


def read(ctx):
    if ctx.profile is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
