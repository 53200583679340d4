"""Mean host milliseconds of one call into the predictor's async form
(staging the frame, enqueueing the stages, the resize or warp and the
copies), from the benchmark's span around each call."""
LAYER = "request and staging"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "out_mps"


def read(ctx):
    if not ctx.dispatch_s:
        return None
    return sum(ctx.dispatch_s) / len(ctx.dispatch_s) * 1e3
