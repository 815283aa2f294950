"""Kernel B4's share of its roofline, %: the least time the card could
take for the traced slice's B4 work, over B4's device ms linked to its
range ``b4.launch``.

The work of one call of each mode (nearest, any-hit) is frozen in
``b4_roofline.json`` beside this file, per cell, counted once when the
cell was defined (``raybench/tools/count_b4_work.py``): bytes from shapes
(rays read once, a hit or a flag written once, the scene's triangles read
once) and per-ray 8-wide node and triangle tests, times the instructions
of one child-box slab test and of one classic Moller-Trumbore test.  One
call's least time is the larger of bytes over the HBM peak and
instructions over the float32 lane-instruction peak.

The program's counters ``b4.rays.nearest`` and ``b4.rays.any_hit`` give
the mix of the two modes; the slice's B4 launches (its ``b4.launch``
ranges) give the number of calls.  (The counters also hold the unit that
starts the profiler up, so they set the mix and not the count.)  None
where the program keeps no such counters or the slice holds no B4."""

import json
import os

RAY_BYTES = 32      # origin, direction, t_min, t_max: 8 float32
OUT_BYTES = {"nearest": 44,     # t, position, normal, u, v, prim, layers
             "any_hit": 1}      # one flag
TRI_BYTES = 36      # 3 vertices, float32


def yardstick(here: str) -> dict:
    with open(os.path.join(here, "b4_roofline.json")) as f:
        return json.load(f)


def call_bytes(mode: str, c: dict, scene_triangles: int) -> float:
    return (c["rays_per_call"] * (RAY_BYTES + OUT_BYTES[mode])
            + scene_triangles * TRI_BYTES)


def call_instructions(c: dict, instr: dict) -> float:
    return c["rays_per_call"] * (
        c["nodes_per_ray"] * c["children_per_node"] * instr["child_box"]
        + c["tri_tests_per_ray"] * instr["triangle"])


def least_ms(mode: str, cell: dict, y: dict) -> tuple[float, str]:
    """One call's least ms in ``mode`` and what bounds it."""
    c = cell["modes"][mode]
    t_bytes = (call_bytes(mode, c, cell["scene_triangles"])
               / y["peaks"]["hbm_bytes_per_s"] * 1e3)
    t_ops = (call_instructions(c, y["instructions"])
             / y["peaks"]["f32_lane_instructions_per_s"] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def read(ctx):
    t = ctx.trace
    y = yardstick(ctx.here)
    cell = y["cells"].get(ctx.cell)
    if t is None or cell is None or not t.count("b4.launch"):
        return None
    b4_ms = t.device_ms("b4.launch")
    try:
        from messyerraytracer_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    got = counters()
    calls = {m: got.get(f"b4.rays.{m}", 0) / c["rays_per_call"]
             for m, c in cell["modes"].items()}
    total = sum(calls.values())
    if not b4_ms or total <= 0:
        return None
    per_call = sum(calls[m] / total * least_ms(m, cell, y)[0] for m in calls)
    return 100.0 * t.count("b4.launch") * per_call / b4_ms
