"""Count the work of kernel B4's cell once, for the frozen yardstick of
``metrics/b4_roofline.json``:

    python3 -m raybench.tools.count_b4_work [--batches 2]

On the cell's own rays (pool batches of seeds 1000.., made as the cell
makes them) over the flat scene of the configuration's world triangles,
per ray:

  * nearest: the 8-wide nodes opened and the triangles tested by the
    port's frontier backend (per-ray exact: every (ray, node) pair whose
    slab test passes, level by level), as ``count_b1_work.py`` counts B1's
    cells;
  * any-hit: kernel B4's own counters in any-hit mode (internal-node pops
    and triangle tests per ray), since the least work of an any-hit query
    depends on the order the nodes are visited in.

Prints one JSON object to paste into the yardstick's ``cells``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

CELL = "flat_1m_wide.service_mixed_512k"


def main(argv=None) -> int:
    from messyerraytracer_tpu_torch.accel.frontier import cast_rays_frontier
    from messyerraytracer_tpu_torch.core.types import Rays
    from messyerraytracer_tpu_torch.kernels.traverse_pallas import wide_cast
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    from raybench import harness
    from raybench.kinds import world_tris_np
    from raybench.kinds.mixed_service_batches import sight_pool
    from raybench.kinds.service_batches import ray_pool
    from raybench.scenes import headline

    p = argparse.ArgumentParser()
    p.add_argument("--batches", type=int, default=2)
    a = p.parse_args(argv)
    dev = torch.device("cuda")
    spec = harness.load_json(harness.HERE, "..", "BENCHMARK.json")
    cell = harness.cell_spec(spec, CELL)
    cfg = harness.load_json(harness.HERE, "configs", cell["config"] + ".json")
    tr = harness.load_json(harness.HERE, "traffic",
                           cell["traffic"] + ".json")
    inputs = headline.make(cfg["scene"])
    world = world_tris_np(inputs)
    scene = build_scene_from_tri_array(world, backend="pallas", device=dev)
    one = dict(tr, pool_batches=1)
    seeds = list(range(1000, 1000 + a.batches))
    out = {"scene_triangles": int(world.shape[0]), "modes": {}}
    t0 = time.time()
    nodes = tris = rays_n = 0
    for s in seeds:
        rays = Rays(*(x[0] for x in ray_pool(one, s, dev)))
        _, st, _ = cast_rays_frontier(rays, scene.frontier, scene.tris)
        nodes += int(st.bvh_nodes_visited)
        tris += int(st.tri_tests)
        rays_n += rays.count
    out["modes"]["nearest"] = {
        "rays_per_call": tr["rays"], "nodes_per_ray": nodes / rays_n,
        "tri_tests_per_ray": tris / rays_n, "children_per_node": 8,
        "counted": (f"frontier backend, {a.batches} nearest pool batches "
                    f"of seeds {seeds[0]}..{seeds[-1]}, {rays_n} rays, on "
                    f"the flat scene of the {world.shape[0]} world "
                    f"triangles")}
    print(f"nearest: {time.time() - t0} s", file=sys.stderr, flush=True)
    nodes = tris = rays_n = 0
    for s in seeds:
        rays = Rays(*(x[0] for x in sight_pool(one, s, dev)))
        _, iout, counters = wide_cast(rays, scene.wide, any_hit=True)
        nodes += int(counters[0])
        tris += int(iout[1].sum(dtype=torch.int64))
        rays_n += rays.count
    out["modes"]["any_hit"] = {
        "rays_per_call": tr["rays"], "nodes_per_ray": nodes / rays_n,
        "tri_tests_per_ray": tris / rays_n, "children_per_node": 8,
        "counted": (f"kernel B4's counters in any-hit mode, {a.batches} "
                    f"line-of-sight pool batches of seeds "
                    f"{seeds[0]}..{seeds[-1]}, {rays_n} rays, on the 8-wide "
                    f"tables of the same scene")}
    print(json.dumps({CELL: out}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
