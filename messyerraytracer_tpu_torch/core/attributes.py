"""Per-triangle vertex attributes: UVs, smooth normals, tangents.

PyTorch counterpart of the JAX package's core/attributes.py: one SoA
struct indexed by prim_id, with batched barycentric interpolation —
``result = (1-u-v)*a0 + u*a1 + v*a2`` (the Moller-Trumbore weights for
v1/v2) — over whole hit batches, and the normal-map perturbation via the
TBN basis (``bitangent = cross(normal, tangent) * sign``, tangents as
xyz + bitangent sign).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class TriangleAttributes:
    """Parallel per-triangle vertex attributes, indexed by prim_id.

    uv:      (T, 3, 2) float32 — UVs at the 3 vertices ((0,0) top-left)
    normal:  (T, 3, 3) float32 — vertex normals; when absent, filled with
             the face normal (flat shading)
    tangent: (T, 3, 4) float32 — xyz + bitangent sign; all-zero = absent
    """

    uv: torch.Tensor
    normal: torch.Tensor
    tangent: torch.Tensor

    @property
    def count(self) -> int:
        return self.uv.shape[0]

    def replace(self, **kw) -> "TriangleAttributes":
        return dataclasses.replace(self, **kw)


def make_attributes(num_tris: int, uv=None, normals=None, tangents=None,
                    face_normals=None,
                    device=DEFAULT_DEVICE) -> TriangleAttributes:
    """Build the attribute table on ``device``; missing channels get safe
    defaults."""
    if uv is None:
        uv = np.zeros((num_tris, 3, 2), np.float32)
        uv[:, 1, 0] = 1.0
        uv[:, 2, 1] = 1.0  # degenerate-but-usable (0,0)/(1,0)/(0,1) chart
    if normals is None:
        if face_normals is not None:
            normals = np.repeat(
                np.asarray(face_normals, np.float32)[:, None, :], 3, axis=1)
        else:
            normals = np.zeros((num_tris, 3, 3), np.float32)
            normals[:, :, 1] = 1.0
    if tangents is None:
        tangents = np.zeros((num_tris, 3, 4), np.float32)
    return attributes_from_jax(uv=uv, normal=normals, tangent=tangents,
                               device=device)


def attributes_from_jax(*, uv, normal, tangent,
                        device=DEFAULT_DEVICE) -> TriangleAttributes:
    """The port's table from the fields of a JAX ``TriangleAttributes``
    (numpy arrays)."""
    def put(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return TriangleAttributes(uv=put(uv), normal=put(normal),
                              tangent=put(tangent))


def _bary(a, u, v):
    """Batched barycentric blend of (N,3,K) vertex attrs by (N,) u/v."""
    w = (1.0 - u - v)[:, None]
    return a[:, 0] * w + a[:, 1] * u[:, None] + a[:, 2] * v[:, None]


def _rows(table: torch.Tensor, prim_id) -> torch.Tensor:
    return table[prim_id.clamp_min(0).long()]


def _unit(x: torch.Tensor) -> torch.Tensor:
    ln = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(ln > 0.0, ln, torch.ones_like(ln))


def interpolate_uv(attrs: TriangleAttributes, prim_id, u, v) -> torch.Tensor:
    """(N,2) interpolated texture UVs."""
    return _bary(_rows(attrs.uv, prim_id), u, v)


def interpolate_normal(attrs: TriangleAttributes, prim_id, u,
                       v) -> torch.Tensor:
    """(N,3) smooth shading normals, normalized."""
    return _unit(_bary(_rows(attrs.normal, prim_id), u, v))


def interpolate_tangent(attrs: TriangleAttributes, prim_id, u, v):
    """((N,3) tangent, (N,) sign, (N,) has_tangent)."""
    a = _rows(attrs.tangent, prim_id)
    t = _bary(a[..., :3], u, v)
    len_sq = (t * t).sum(dim=-1)
    has = len_sq >= 1e-8
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=t.device)
    t = torch.where(has[:, None],
                    t / torch.sqrt(torch.clamp_min(len_sq, 1e-8))[:, None],
                    x_axis)
    s = _bary(a[..., 3:4], u, v)[:, 0]
    sign = torch.where(s >= 0.0, 1.0, -1.0)
    return t, sign, has


def perturb_normal(normal, tangent, sign, normal_sample, normal_scale=1.0):
    """Apply a tangent-space normal-map sample via the TBN basis.

    ``normal_sample`` is the decoded (N,3) map value in [-1,1];
    ``normal_scale`` a Python scalar or an (N,1) per-pixel strength."""
    bitangent = torch.linalg.cross(normal, tangent) * sign[:, None]
    ns = torch.cat([normal_sample[:, :2] * normal_scale,
                    normal_sample[:, 2:3]], dim=1)
    out = (tangent * ns[:, 0:1] + bitangent * ns[:, 1:2]
           + normal * ns[:, 2:3])
    return _unit(out)
