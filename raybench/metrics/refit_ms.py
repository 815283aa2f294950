"""Host ms per frame in the range ``raybench.move`` (the instance moves
and the refits they start, as the frame runs them, with no wait added):
the mean over the window's frames before the profiler first starts (the
first third of a traced run's window), so that it adds with the cast's
time to ``frame_ms``."""


def read(ctx):
    ms = ctx.stats.get("move_ms")
    return sum(ms) / len(ms) if ms else None
