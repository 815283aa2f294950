"""The composite ~99K-triangle scene (the JAX package's
``bench.py:246-282``, frozen): a height-field ground, a sphere and random
boxes from the recipe's seed, as one flat mesh."""

from __future__ import annotations

import numpy as np

from . import meshes


def make(p: dict) -> dict:
    """{"meshes": [(T, 3, 3) float32], "instances": [(0, identity)]}."""
    g = meshes.plane(p["ground_size"], y=0.0, subdiv=p["ground_subdiv"])
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.6) * np.cos(g[:, :, 2] * 0.5)) * 1.5
    sph = meshes.uv_sphere(4.0, p["sphere"], p["sphere"], center=(0, 6, 0))
    rng = np.random.default_rng(p["seed"])
    boxes = []
    for _ in range(p["boxes"]):
        c = rng.uniform(-p["box_spread"], p["box_spread"], 2)
        hgt = rng.uniform(0.5, 4.0)
        boxes.append(meshes.box(
            (rng.uniform(0.5, 2), hgt, rng.uniform(0.5, 2)),
            center=(c[0], hgt / 2, c[1])))
    tris = np.concatenate([g, sph] + boxes)
    return {"meshes": [tris], "instances": [(0, np.eye(4, dtype=np.float32))]}
