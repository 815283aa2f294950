"""World triangles re-derived from a scene's meshes and transforms."""

from __future__ import annotations

import numpy as np
import torch


def world_triangles(meshes, instances, transforms=None, device="cpu",
                    dtype=torch.float64) -> torch.Tensor:
    """(F, 3, 3) world triangles in the flattened numbering: instance by
    instance, each mesh's triangles in order.  ``transforms`` (I, 4, 4)
    overrides the instances' own."""
    out = []
    for i, (mesh_id, xf) in enumerate(instances):
        m = np.asarray(xf if transforms is None else transforms[i],
                       np.float64)
        v = torch.as_tensor(np.asarray(meshes[mesh_id], np.float64),
                            device=device)
        r = torch.as_tensor(m[:3, :3], device=device)
        t = torch.as_tensor(m[:3, 3], device=device)
        out.append(torch.einsum("ij,fvj->fvi", r, v) + t)
    return torch.cat(out).to(dtype)


def instance_boxes(meshes, instances, transforms, ids,
                   device="cpu") -> torch.Tensor:
    """(len(ids), 2, 3) float64 world bounds (least, greatest corner) of
    the instances ``ids`` under ``transforms`` (I, 4, 4)."""
    out = []
    for k in ids:
        m = np.asarray(transforms[k], np.float64)
        v = np.asarray(meshes[instances[k][0]], np.float64).reshape(-1, 3)
        w = v @ m[:3, :3].T + m[:3, 3]
        out.append(np.stack([w.min(0), w.max(0)]))
    return torch.as_tensor(np.stack(out), device=device)
