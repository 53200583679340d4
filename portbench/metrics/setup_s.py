"""Seconds from the harness's first line to the window: imports, the
CUDA context, the kernel library, weights, inputs, the predictor, the
first frame and the fixed warm-up."""
LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"
BETTER = "lower"


def read(ctx):
    return ctx.setup_s
