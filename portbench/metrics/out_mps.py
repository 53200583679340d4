"""Output megapixels of every frame completed in the window, over the
window's seconds (host clock)."""
LAYER = "end to end"
UNIT = "MP/s"
SOURCE = "host_clock"
BETTER = "higher"


def read(ctx):
    return ctx.frames_done * ctx.out_px / ctx.seconds / 1e6
