"""Device milliseconds of copies (up, down, sets) a frame, from the
profiler's Memcpy and Memset rows."""
LAYER = "staging copies"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "out_mps"


def read(ctx):
    if ctx.trace is None or not ctx.trace.copies or not ctx.frames_sent:
        return None
    return sum(d for _, _, d in ctx.trace.copies) / 1e6 / ctx.frames_sent
