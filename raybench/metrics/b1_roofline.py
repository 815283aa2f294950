"""Kernel B1's share of its roofline, %: the least time the card could
take for one cast call's work, over B1's measured ms per launch.

The work is frozen in ``b1_roofline.json`` beside this file, per
cell, counted once when the cell was defined (never from the run's
counters): bytes from shapes (rays read once, hits written once, the
scene's triangles and instance transforms read once) and per-ray node and
triangle tests, times the instructions of one child-box slab test and of
one triangle test.  The least time is the larger of bytes over the HBM
peak and instructions over the float32 lane-instruction peak."""

import json
import os

RAY_BYTES = 32      # origin, direction, t_min, t_max: 8 float32
HIT_BYTES = 44      # t, position, normal, u, v, prim_id, hit_layers
TRI_BYTES = 36      # 3 vertices, float32
XFORM_BYTES = 48    # a 3x4 float32 instance transform


def yardstick(here: str) -> dict:
    with open(os.path.join(here, "b1_roofline.json")) as f:
        return json.load(f)


def call_bytes(c: dict) -> float:
    return (c["rays_per_call"] * (RAY_BYTES + HIT_BYTES)
            + c["scene_triangles"] * TRI_BYTES
            + c["instances"] * XFORM_BYTES)


def call_instructions(c: dict, instr: dict) -> float:
    return c["rays_per_call"] * (
        c["nodes_per_ray"] * c["children_per_node"] * instr["child_box"]
        + c["tri_tests_per_ray"] * instr["triangle"])


def least_ms(c: dict, y: dict) -> tuple[float, str]:
    t_bytes = call_bytes(c) / y["peaks"]["hbm_bytes_per_s"] * 1e3
    t_ops = (call_instructions(c, y["instructions"])
             / y["peaks"]["f32_lane_instructions_per_s"] * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def read(ctx):
    t = ctx.trace
    y = yardstick(ctx.here)
    c = y["cells"].get(ctx.cell)
    if t is None or c is None or not t.b1_us:
        return None
    ms, _ = least_ms(c, y)
    return 100.0 * ms / (t.b1_ms / len(t.b1_us))
