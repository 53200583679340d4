"""Share of the traced window in which no kernel and no copy ran."""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "out_mps"


def read(ctx):
    if ctx.trace is None or not ctx.trace.device():
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
