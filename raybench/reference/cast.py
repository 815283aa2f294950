"""Closest-hit and any-hit casts of every ray against every triangle.

The reference runs in float64 (``dtype``); the control runs the same code
in bfloat16.  Each (ray, triangle) pair is one column of a matrix product:
a ray's features ``[d, o x d, o, 1]`` against a triangle's columns give
the plane's denominator ``d . n``, its numerator ``n . (v0 - o)`` and the
three edge sides (permuted inner products of the ray with the edges, the
Pluecker test).  A pair hits where the three sides share a sign, the
denominator is not 0 and ``t`` lies in ``[t_min, t_max]``; the least
``t`` wins and the lowest triangle index wins exact ties.  TF32 is off
for the products.
"""

from __future__ import annotations

import contextlib

import torch

RAY_CHUNK = 2048
TRI_CHUNK = 32768


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def triangle_columns(tris: torch.Tensor) -> torch.Tensor:
    """(10, 5T) columns of ``tris`` (T, 3, 3): blocks den, num, side0..2
    (side k is the edge opposite vertex k)."""
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    t = tris.shape[0]
    w = torch.zeros((10, 5, t), dtype=tris.dtype, device=tris.device)
    w[0:3, 0] = n.T
    w[6:9, 1] = -n.T
    w[9, 1] = (n * v0).sum(-1)
    for k, (a, b) in enumerate(((v1, v2), (v2, v0), (v0, v1))):
        w[0:3, 2 + k] = torch.linalg.cross(a, b).T
        w[3:6, 2 + k] = (b - a).T
    return w.reshape(10, 5 * t)


def ray_features(origin: torch.Tensor, direction: torch.Tensor):
    one = torch.ones_like(origin[:, :1])
    return torch.cat([direction, torch.linalg.cross(origin, direction),
                      origin, one], dim=1)


def _pairs(feat, cols, t_min, t_max):
    """(R, T) t of each pair and whether it hits."""
    s = (feat @ cols).reshape(feat.shape[0], 5, -1)
    den, num = s[:, 0], s[:, 1]
    sides = s[:, 2:]
    inside = ((sides.amin(dim=1) >= 0) | (sides.amax(dim=1) <= 0)) & (den != 0)
    t = num / torch.where(den != 0, den, torch.ones_like(den))
    ok = inside & (t >= t_min[:, None]) & (t <= t_max[:, None])
    return t, ok


def cast(origin, direction, t_min, t_max, tris, dtype=torch.float64,
         any_hit=False):
    """Cast rays (float32 tensors, any device) against ``tris`` (T, 3, 3).

    Returns (t, prim): the closest t (``inf`` on a miss) and triangle index
    (-1 on a miss) in ``dtype``; with ``any_hit``, an (N,) bool."""
    dev = origin.device
    o, d = origin.to(dtype), direction.to(dtype)
    tmin, tmax = t_min.to(dtype), t_max.to(dtype)
    tris = tris.to(device=dev, dtype=dtype)
    n = o.shape[0]
    best_t = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    feat = ray_features(o, d)
    with no_tf32():
        for s in range(0, tris.shape[0], TRI_CHUNK):
            cols = triangle_columns(tris[s:s + TRI_CHUNK])
            for r in range(0, n, RAY_CHUNK):
                sl = slice(r, r + RAY_CHUNK)
                t, ok = _pairs(feat[sl], cols, tmin[sl], tmax[sl])
                if any_hit:
                    occluded[sl] |= ok.any(dim=1)
                    continue
                tv, arg = torch.where(ok, t, float("inf")).min(dim=1)
                better = tv < best_t[sl]
                best_t[sl] = torch.where(better, tv, best_t[sl])
                best_p[sl] = torch.where(better, arg + s, best_p[sl])
    return occluded if any_hit else (best_t, best_p)


def crosses_boxes(origin, direction, t_min, t_max, boxes,
                  pad=1e-6) -> torch.Tensor:
    """(N,) bool: the ray's span [t_min, t_max] meets one of ``boxes``
    (K, 2, 3), each widened by ``pad``; a float64 slab test."""
    o, d = origin.double(), direction.double()
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-300), d)
    lo_t, hi_t = t_min.double(), t_max.double()
    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for lo, hi in boxes.to(device=o.device, dtype=torch.float64):
        t1, t2 = (lo - pad - o) * inv, (hi + pad - o) * inv
        near = torch.maximum(torch.minimum(t1, t2).amax(-1), lo_t)
        far = torch.minimum(torch.maximum(t1, t2).amin(-1), hi_t)
        out |= near <= far
    return out


def moller_trumbore(o, d, tris):
    """Per-ray (t, u, v) of each ray against its own triangle (N, 3, 3), in
    the inputs' precision; u and v weigh the second and third vertex."""
    v0 = tris[:, 0]
    e1, e2 = tris[:, 1] - v0, tris[:, 2] - v0
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum(-1)
    inv = 1.0 / torch.where(det != 0, det, torch.ones_like(det))
    tv = o - v0
    u = (tv * p).sum(-1) * inv
    q = torch.linalg.cross(tv, e1)
    v = (d * q).sum(-1) * inv
    t = (e2 * q).sum(-1) * inv
    return t, u, v, det != 0


def face_normal(tris):
    """Unit ``(v1 - v0) x (v2 - v0)`` of each triangle (N, 3, 3)."""
    n = torch.linalg.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    ln = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return n / torch.where(ln > 0, ln, torch.ones_like(ln))
