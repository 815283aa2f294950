"""Kernel B1's share of its roofline on a cell of flat primary frames, %:
``b1_roofline.py``'s formula (the least time the card could take for one
cast call's work, over B1's measured ms a launch), with the work frozen in
``b1_frame_roofline.json`` beside this file, per cell, counted once when
the cell was defined (``raybench/tools/count_b1_frame_work.py``).  None
where the slice holds no B1 launch or the yardstick no such cell."""

import json
import os

from raybench.harness import load_file

_B1 = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "b1_roofline.py"), "raybench_metric_b1_roofline")


def yardstick(here: str) -> dict:
    with open(os.path.join(here, "b1_frame_roofline.json")) as f:
        return json.load(f)


def read(ctx):
    t = ctx.trace
    y = yardstick(ctx.here)
    c = y["cells"].get(ctx.cell)
    if t is None or c is None or not t.b1_us:
        return None
    ms, _ = _B1.least_ms(c, y)
    return 100.0 * ms / (t.b1_ms / len(t.b1_us))
