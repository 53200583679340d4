"""Kernels the device ran a frame, from the profiler's rows."""
LAYER = "device"
UNIT = "count"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "out_mps"


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.frames_sent:
        return None
    return len(ctx.trace.kernels) / ctx.frames_sent
