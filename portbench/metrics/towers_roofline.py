"""The IMDN towers' share of their roofline: their least time a frame
(every conv's multiply-adds at the float32 peak, ``work/counts.py``) over
the device time a frame of every kernel but K1's: cuDNN's convs and the
elementwise kernels around them, with the frame's casts and layout
changes (a few per cent of them)."""
LAYER = "IMDN towers (models/imdn.py, cuDNN)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "out_mps"
OTHER = "steering_resize_kernel"


def read(ctx):
    if ctx.trace is None or "towers" not in ctx.least:
        return None
    n, seconds = ctx.trace.seconds(lambda name: OTHER not in name)
    if not n or not ctx.frames_sent:
        return None
    return 100.0 * ctx.least["towers"] * ctx.frames_sent / seconds
