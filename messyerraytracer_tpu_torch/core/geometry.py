"""Vectorized intersection math: Moller-Trumbore and the slab AABB test.

Tensor building blocks shared by the brute-force oracle and the plain
version of the cluster traversal.  Everything broadcasts: rays and
triangles may carry leading batch dimensions as long as they are mutually
broadcastable.

``triangle_fields`` re-derives triangle edges and normals on a device
(the refits): every float32 expression is written out, one operation at a
time, in the order of the numpy build (``types.triangle_fields_np``), so
the card, the CPU and the build agree bit for bit.

Semantics (the JAX package's core/geometry.py):
  * Moller-Trumbore: reject |det| < 1e-8, u in [0,1], v >= 0, u+v <= 1,
    t in [t_min, t_max].
  * Slab test: division-free via the precomputed inverse direction, hit
    iff tmax >= max(tmin, 0) and the entry tmin <= the ray's t_max.
"""

from __future__ import annotations

import torch

from .types import MT_DET_EPS, T_MAX_DEFAULT


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def triangle_fields(v0, v1, v2):
    """(v0, e1, e2, unit normal) of (T, 3) float32 vertex tensors, on
    their device, bit-equal to ``types.triangle_fields_np``: the cross
    product as separate multiplies and subtractions, the squared norm
    summed as ((x² + y²) + z²), its square root taken in float64 and
    rounded to float32 (correctly rounded on both devices, which
    PyTorch's float32 CPU sqrt is not), and IEEE division."""
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = _cross(e1, e2)
    sq = nrm * nrm
    n2 = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
    nl = torch.sqrt(n2.double()).float()  # lint: off: correctly rounded sqrt
    nl = torch.where(nl > 0.0, nl, torch.ones_like(nl))[:, None]
    return v0, e1, e2, nrm / nl


def moller_trumbore(origin, direction, t_min, t_max, v0, edge1, edge2):
    """Batched Moller-Trumbore ray/triangle test.

    Returns (valid, t, u, v): ``valid`` is a bool tensor, hit inside the
    triangle and inside [t_min, t_max]; t/u/v are garbage where invalid.
    """
    pvec = _cross(direction, edge2)
    det = _dot(edge1, pvec)
    parallel = det.abs() < MT_DET_EPS
    one = torch.ones_like(det)
    inv_det = one / torch.where(parallel, one, det)

    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, edge1)
    v = _dot(direction, qvec) * inv_det
    t = _dot(edge2, qvec) * inv_det

    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return valid, t, u, v


def slab_test(origin, inv_direction, t_max, box_min, box_max):
    """Batched division-free slab ray/AABB test, clipped against the
    ray's current ``t_max``.  Returns (hit, tentry)."""
    t1 = (box_min - origin) * inv_direction
    t2 = (box_max - origin) * inv_direction
    tnear = torch.minimum(t1, t2)
    tfar = torch.maximum(t1, t2)
    tmin = tnear.amax(dim=-1)
    tmax = tfar.amin(dim=-1)
    hit = (tmax >= tmin.clamp_min(0.0)) & (tmin <= t_max)
    return hit, tmin


def closest_select(valid, t, tie_idx):
    """Pick the winning candidate along the last axis: the lowest
    ``tie_idx`` among those with the minimal valid t (the serial
    strictly-closer loop).  Returns (any_valid, argbest)."""
    t_masked = torch.where(valid, t, torch.full_like(t, T_MAX_DEFAULT))
    best_t = t_masked.amin(dim=-1, keepdim=True)
    is_best = valid & (t_masked <= best_t)
    big = torch.iinfo(torch.int32).max
    tie = torch.as_tensor(tie_idx, device=t.device).to(torch.int64)
    idx_masked = torch.where(is_best, tie, torch.full_like(tie, big))
    arg = idx_masked.argmin(dim=-1)
    return valid.any(dim=-1), arg


def aabb_of_triangles(v0, v1, v2):
    """Per-triangle AABB."""
    mn = torch.minimum(torch.minimum(v0, v1), v2)
    mx = torch.maximum(torch.maximum(v0, v1), v2)
    return mn, mx


def centroid_of_triangles(v0, v1, v2):
    """Triangle centroid for SAH binning: (v0 + v1 + v2) * (1/3)."""
    return (v0 + v1 + v2) * (1.0 / 3.0)
