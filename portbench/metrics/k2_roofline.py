"""K2's share of its roofline: its least time a frame, counted from
shapes alone (``work/counts.py``), over its device time a frame from the
profiler's rows of kernels whose name holds ``lut_stage_kernel`` or
``lut_rows_kernel``."""
LAYER = "LUT stages (ops/lut_pipeline.py, K2)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "out_mps"
SYMBOLS = ('lut_stage_kernel', 'lut_rows_kernel')


def read(ctx):
    if ctx.trace is None or "k2" not in ctx.least:
        return None
    n, seconds = ctx.trace.seconds(
        lambda name: any(s in name for s in SYMBOLS))
    if not n or not ctx.frames_sent:
        return None
    return 100.0 * ctx.least["k2"] * ctx.frames_sent / seconds
