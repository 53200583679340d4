"""The whole frame's least time on the card, counted from shapes alone
(``work/frame.py``), over the window's seconds a completed frame."""
LAYER = "the whole frame"
UNIT = "%"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "out_mps"


def read(ctx):
    if not ctx.frames_done:
        return None
    return 100.0 * ctx.frame_least_s * ctx.frames_done / ctx.seconds
