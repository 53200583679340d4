"""The 95th percentile, over every frame completed in the window, of the
time from the call that sent it to its result in host memory."""
import numpy as np

LAYER = "end to end"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"


def read(ctx):
    if not ctx.latency_s:
        return None
    return float(np.percentile(ctx.latency_s, 95)) * 1e3
