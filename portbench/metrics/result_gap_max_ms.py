"""The longest time between two consecutive results of the window
(benchmark clock): a stall of the stream shows here first."""
LAYER = "stream"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "frame_p95_ms"


def read(ctx):
    t = sorted(ctx.done_times)
    if len(t) < 2:
        return None
    return max(b - a for a, b in zip(t, t[1:])) * 1e3
