"""Count the work of kernel B1 on the terrain cell's frames once, for the
frozen yardstick of ``metrics/b1_frame_roofline.json``:

    python3 -m raybench.tools.count_b1_frame_work [--frames 36] [--out FILE]

Per ray, the wide-BVH nodes opened and the triangles tested by the port's
frontier backend (per-ray exact: every (ray, node) pair whose slab test
passes, level by level, on the flat scene of the cell's triangles), on
the cell's own rays: its orbit's frames at evenly spaced yaws, k * 360 /
frames degrees.  The peaks and instruction counts are those of
``metrics/b1_roofline.json``.  Prints the whole yardstick as one JSON
object, and writes it to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import torch

CELL = "terrain_2m.primary_1024x768"


def main(argv=None) -> int:
    from messyerraytracer_tpu_torch.accel.frontier import cast_rays_frontier
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    from raybench import harness
    from raybench.kinds import block_perm, frame_rays, world_tris_np
    from raybench.kinds.primary_frames import orbit

    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--out")
    a = p.parse_args(argv)
    dev = torch.device("cuda")
    root = os.path.dirname(harness.HERE)
    spec = harness.load_json(root, "BENCHMARK.json")
    cell = harness.cell_spec(spec, CELL)
    cfg = harness.load_json(harness.HERE, "configs", cell["config"] + ".json")
    tr = harness.load_json(harness.HERE, "traffic", cell["traffic"] + ".json")
    inputs = importlib.import_module(
        f"raybench.scenes.{cfg['recipe']}").make(cfg["scene"])
    world = world_tris_np(inputs)
    scene = build_scene_from_tri_array(world, device=dev)
    perm = block_perm(tr["width"], tr["height"], tr["block"], dev)
    nodes = tris = rays_n = 0
    t0 = time.time()
    for k in range(a.frames):
        eye = orbit(cfg["camera"]["eye"], k * 360.0 / a.frames)
        rays = frame_rays(cfg["camera"], eye, tr["width"], tr["height"],
                          perm, dev)
        _, st, _ = cast_rays_frontier(rays, scene.frontier, scene.tris)
        nodes += int(st.bvh_nodes_visited)
        tris += int(st.tri_tests)
        rays_n += rays.count
    print(f"{CELL}: {time.time() - t0} s", file=sys.stderr, flush=True)
    base = harness.load_json(harness.HERE, "metrics", "b1_roofline.json")
    out = {"peaks": base["peaks"], "instructions": base["instructions"],
           "cells": {CELL: {
               "rays_per_call": tr["width"] * tr["height"],
               "nodes_per_ray": nodes / rays_n,
               "tri_tests_per_ray": tris / rays_n,
               "children_per_node": 8,
               "scene_triangles": int(world.shape[0]),
               "instances": 0,
               "counted": (f"frontier backend, {a.frames} frames of the orbit "
                           f"at yaws k * {360.0 / a.frames} deg, {rays_n} "
                           f"rays, on the flat scene of the {world.shape[0]} "
                           f"triangles; counted once on "
                           f"{torch.cuda.get_device_name(dev)} ("
                           f"{harness.card_power_limit()}) with "
                           f"raybench/tools/count_b1_frame_work.py when the "
                           f"cell was defined"),
           }}}
    text = json.dumps(out, indent=2)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
