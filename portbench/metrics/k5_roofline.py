"""K5's share of its roofline: its least time a frame, counted from
shapes alone (``work/counts.py``), over its device time a frame from the
profiler's rows of kernels whose name holds ``steering_warp_kernel``."""
LAYER = "warp (ops/kernels/warp.py, K5)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "out_mps"
SYMBOLS = ('steering_warp_kernel',)


def read(ctx):
    if ctx.trace is None or "k5" not in ctx.least:
        return None
    n, seconds = ctx.trace.seconds(
        lambda name: any(s in name for s in SYMBOLS))
    if not n or not ctx.frames_sent:
        return None
    return 100.0 * ctx.least["k5"] * ctx.frames_sent / seconds
