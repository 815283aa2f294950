"""The 2M-triangle height-field terrain (the JAX package's
``bench.py:284-288``, the 2M capacity tier, frozen): one plane of
``2 * subdiv^2`` triangles whose height is
``sin(x * freq_x) * cos(z * freq_z) * amplitude``, as one flat mesh."""

from __future__ import annotations

import numpy as np

from . import meshes


def make(p: dict) -> dict:
    """{"meshes": [(T, 3, 3) float32], "instances": [(0, identity)]}."""
    g = meshes.plane(p["size"], y=0.0, subdiv=p["subdiv"])
    g[:, :, 1] = (np.sin(g[:, :, 0] * p["freq_x"])
                  * np.cos(g[:, :, 2] * p["freq_z"])) * p["amplitude"]
    return {"meshes": [g], "instances": [(0, np.eye(4, dtype=np.float32))]}
