"""95th percentile of every frame's latency in the window (host clock,
from the call to its synchronize), ms."""

import numpy as np


def read(ctx):
    return float(np.percentile(ctx.latencies, 95)) * 1e3 if ctx.units \
        else None
