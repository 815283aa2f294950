"""The instanced headline scene (the JAX package's ``bench.py:118-167``,
frozen): a tiled height-field terrain, two sphere meshes and a box,
instanced from the recipe's seed."""

from __future__ import annotations

import numpy as np

from . import meshes


def xform(tx, ty, tz, s=1.0) -> np.ndarray:
    """4x4 float32 uniform scale then translation."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    m[:3, 3] = (tx, ty, tz)
    return m


def make(p: dict) -> dict:
    """{"meshes": [(T, 3, 3) float32 object-space arrays], "instances":
    [(mesh index, 4x4 float32 transform)]} in the recipe's order."""
    terrain = meshes.plane(p["terrain_size"], y=0.0,
                           subdiv=p["terrain_subdiv"])
    terrain[:, :, 1] = (np.sin(terrain[:, :, 0] * 0.9)
                        * np.cos(terrain[:, :, 2] * 0.8))
    mesh_list = [terrain,
                 meshes.uv_sphere(1.6, p["sphere_hi"], p["sphere_hi"]),
                 meshes.uv_sphere(1.0, p["sphere_lo"], p["sphere_lo"]),
                 meshes.box((1.4, 1.0, 1.2))]
    rng = np.random.default_rng(p["seed"])
    g, step, ext = p["terrain_tiles"], p["tile_spacing"], p["spread"]
    inst = [(0, xform((gx - (g - 1) / 2) * step, 0.0,
                      (gz - (g - 1) / 2) * step))
            for gx in range(g) for gz in range(g)]
    for _ in range(p["sphere_hi_count"]):
        c = rng.uniform(-ext, ext, 2)
        inst.append((1, xform(c[0], rng.uniform(1.5, 4.0), c[1],
                              s=rng.uniform(0.6, 1.4))))
    for _ in range(p["sphere_lo_count"]):
        c = rng.uniform(-ext, ext, 2)
        inst.append((2, xform(c[0], rng.uniform(0.8, 2.5), c[1],
                              s=rng.uniform(0.5, 1.5))))
    for _ in range(p["box_count"]):
        c = rng.uniform(-ext, ext, 2)
        inst.append((3, xform(c[0], 0.5, c[1])))
    return {"meshes": mesh_list, "instances": inst}
