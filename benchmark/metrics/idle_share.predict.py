"""The share of the traced window in which no operation ran on the card:
1 - (the union of the device intervals) / (the window)."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "predict_fps"


def read(ctx):
    if ctx.trace.window_s <= 0:
        return None
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
