"""Frozen copies of the procedural meshes the scene recipes use
(``plane``, ``uv_sphere``, ``box``): (T, 3, 3) float32 vertex arrays,
vertex for vertex those of the port's ``utils/meshes.py`` when this
benchmark was defined."""

from __future__ import annotations

import numpy as np


def uv_sphere(radius=1.0, rings=16, segments=32, center=(0.0, 0.0, 0.0)):
    """UV sphere; the poles are triangle fans."""
    c = np.asarray(center, np.float32)
    ring = np.linspace(0.0, np.pi, rings + 1)
    seg = np.linspace(0.0, 2.0 * np.pi, segments + 1)
    sin_r, cos_r = np.sin(ring)[:, None], np.cos(ring)[:, None]
    sin_s, cos_s = np.sin(seg)[None, :], np.cos(seg)[None, :]
    grid = np.stack([radius * sin_r * cos_s,
                     radius * cos_r * np.ones_like(sin_s),
                     radius * sin_r * sin_s], axis=-1).astype(np.float32) + c
    tris = []
    for r in range(rings):
        for s in range(segments):
            a, b = grid[r, s], grid[r + 1, s]
            cc, d = grid[r + 1, s + 1], grid[r, s + 1]
            if r > 0:
                tris.append([a, d, b])
            if r < rings - 1:
                tris.append([b, d, cc])
    return np.asarray(tris, np.float32)


def _quad(p0, p1, p2, p3):
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return [[p0, p1, p2], [p0, p2, p3]]


def plane(size=10.0, y=0.0, subdiv=1):
    """Horizontal plane of 2 * subdiv^2 triangles, normal +Y."""
    h = size * 0.5
    xs = np.linspace(-h, h, subdiv + 1)
    tris = []
    for i in range(subdiv):
        for j in range(subdiv):
            tris.extend(_quad((xs[i], y, xs[j]), (xs[i], y, xs[j + 1]),
                              (xs[i + 1], y, xs[j + 1]),
                              (xs[i + 1], y, xs[j])))
    return np.asarray(tris, np.float32)


def box(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)):
    """Axis-aligned box, 12 triangles, outward normals."""
    sx, sy, sz = (s * 0.5 for s in size)
    cx, cy, cz = center
    lo = np.array([cx - sx, cy - sy, cz - sz], np.float32)
    hi = np.array([cx + sx, cy + sy, cz + sz], np.float32)
    v = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                  [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                  [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                  [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]], np.float32)
    tris = []
    for a, b, c, d in ((4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6),
                       (0, 4, 7, 3), (7, 6, 2, 3), (0, 1, 5, 4)):
        tris.extend(_quad(v[a], v[b], v[c], v[d]))
    return np.asarray(tris, np.float32)
