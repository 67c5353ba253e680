"""Device: the share of the traced window in which no device operation
ran, 1 - busy / window, in %."""


def read(ctx):
    if ctx.busy_s <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
