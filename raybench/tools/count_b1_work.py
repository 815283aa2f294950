"""Count the work of kernel B1's cells once, for the frozen yardstick of
``metrics/b1_roofline.json``:

    python3 -m raybench.tools.count_b1_work [--frames 36] [--batches 2]

Per ray, the wide-BVH nodes opened and the triangles tested by the port's
frontier backend (per-ray exact: every (ray, node) pair whose slab test
passes, level by level, on the flat scene of the same world triangles),
on the cell's own rays: the orbit's frames at evenly spaced yaws for the
primary frames, pool batches for the service.  Prints one JSON object to
paste into the yardstick.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def main(argv=None) -> int:
    from messyerraytracer_tpu_torch.accel.frontier import cast_rays_frontier
    from messyerraytracer_tpu_torch.core.types import Rays
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    from raybench import harness
    from raybench.kinds import block_perm, frame_rays, world_tris_np
    from raybench.kinds.primary_frames import orbit
    from raybench.kinds.service_batches import ray_pool
    from raybench.scenes import composite, headline

    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--batches", type=int, default=2)
    a = p.parse_args(argv)
    dev = torch.device("cuda")

    def count(scene, rays):
        _, st, _ = cast_rays_frontier(rays, scene.frontier, scene.tris)
        return int(st.bvh_nodes_visited), int(st.tri_tests)

    def world_tris_count(inputs):
        return sum(inputs["meshes"][m].shape[0]
                   for m, _ in inputs["instances"])

    def flat(inputs):
        return build_scene_from_tri_array(world_tris_np(inputs), device=dev)

    out = {}
    spec_cfg = harness.load_json(harness.HERE, "configs", "instanced_1m.json")
    tr = harness.load_json(harness.HERE, "traffic", "primary_1080p.json")
    inputs = headline.make(spec_cfg["scene"])
    scene = flat(inputs)
    perm = block_perm(tr["width"], tr["height"], tr["block"], dev)
    nodes = tris = rays_n = 0
    t0 = time.time()
    for k in range(a.frames):
        eye = orbit(spec_cfg["camera"]["eye"], k * 360.0 / a.frames)
        rays = frame_rays(spec_cfg["camera"], eye, tr["width"], tr["height"],
                          perm, dev)
        n, t = count(scene, rays)
        nodes, tris, rays_n = nodes + n, tris + t, rays_n + rays.count
    out["instanced_1m.primary_1080p"] = {
        "rays_per_call": tr["width"] * tr["height"],
        "nodes_per_ray": nodes / rays_n, "tri_tests_per_ray": tris / rays_n,
        "children_per_node": 8,
        "scene_triangles": sum(m.shape[0] for m in inputs["meshes"]),
        "instances": len(inputs["instances"]),
        "counted": (f"frontier backend, {a.frames} frames of the orbit at "
                    f"yaws k * {360.0 / a.frames} deg, {rays_n} rays, on the "
                    f"flat scene of the {world_tris_count(inputs)} world "
                    f"triangles"),
    }
    print(f"primary: {time.time() - t0} s", file=sys.stderr, flush=True)
    del scene

    cfg = harness.load_json(harness.HERE, "configs", "composite_99k.json")
    tr = harness.load_json(harness.HERE, "traffic", "service_random_512k.json")
    inputs = composite.make(cfg["scene"])
    scene = flat(inputs)
    nodes = tris = rays_n = 0
    for b in range(a.batches):
        pool = ray_pool(dict(tr, pool_batches=1), 1000 + b, dev)
        rays = Rays(*(x[0] for x in pool))
        n, t = count(scene, rays)
        nodes, tris, rays_n = nodes + n, tris + t, rays_n + rays.count
    out["composite_99k.service_random_512k"] = {
        "rays_per_call": tr["rays"],
        "nodes_per_ray": nodes / rays_n, "tri_tests_per_ray": tris / rays_n,
        "children_per_node": 8,
        "scene_triangles": sum(m.shape[0] for m in inputs["meshes"]),
        "instances": 0,
        "counted": (f"frontier backend, {a.batches} pool batches of seeds "
                    f"1000..{999 + a.batches}, {rays_n} rays, on the flat "
                    f"scene of the {world_tris_count(inputs)} triangles"),
    }
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
