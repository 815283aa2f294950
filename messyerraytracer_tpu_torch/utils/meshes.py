"""Procedural test meshes and a minimal OBJ loader.

Replaces the reference's Godot scene-tree mesh extraction
(src/godot/raytracer_server.cpp:413-610) and its procedural demo-asset
generator (tools/generate_demo_assets.py: sphere / plane / room) with
framework-native sources: numpy vertex arrays fed straight into
``make_triangles``.  All outputs are (T, 3, 3) float32 vertex arrays.
"""

from __future__ import annotations

import numpy as np


def uv_sphere(radius=1.0, rings=16, segments=32, center=(0.0, 0.0, 0.0)):
    """UV sphere triangles, (T, 3, 3). Poles use triangle fans."""
    c = np.asarray(center, np.float32)
    ring_angles = np.linspace(0.0, np.pi, rings + 1)
    seg_angles = np.linspace(0.0, 2.0 * np.pi, segments + 1)
    # vertex grid (rings+1, segments+1, 3)
    sin_r = np.sin(ring_angles)[:, None]
    cos_r = np.cos(ring_angles)[:, None]
    sin_s = np.sin(seg_angles)[None, :]
    cos_s = np.cos(seg_angles)[None, :]
    x = radius * sin_r * cos_s
    y = radius * cos_r * np.ones_like(sin_s)
    z = radius * sin_r * sin_s
    grid = np.stack([x, y, z], axis=-1).astype(np.float32) + c

    tris = []
    for r in range(rings):
        for s in range(segments):
            a = grid[r, s]
            b = grid[r + 1, s]
            cc = grid[r + 1, s + 1]
            d = grid[r, s + 1]
            if r > 0:
                tris.append([a, d, b])
            if r < rings - 1:
                tris.append([b, d, cc])
    return np.asarray(tris, np.float32)


def quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (counter-clockwise)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    return np.asarray([[p0, p1, p2], [p0, p2, p3]], np.float32)


def plane(size=10.0, y=0.0, subdiv=1):
    """Horizontal plane of 2*subdiv^2 triangles, normal +Y."""
    h = size * 0.5
    xs = np.linspace(-h, h, subdiv + 1)
    tris = []
    for i in range(subdiv):
        for j in range(subdiv):
            p0 = (xs[i], y, xs[j])
            p1 = (xs[i], y, xs[j + 1])
            p2 = (xs[i + 1], y, xs[j + 1])
            p3 = (xs[i + 1], y, xs[j])
            tris.extend(quad(p0, p1, p2, p3))
    return np.asarray(tris, np.float32)


def box(size=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0)):
    """Axis-aligned box, 12 triangles, outward normals."""
    sx, sy, sz = (s * 0.5 for s in size)
    cx, cy, cz = center
    lo = np.array([cx - sx, cy - sy, cz - sz], np.float32)
    hi = np.array([cx + sx, cy + sy, cz + sz], np.float32)
    v = np.array(
        [
            [lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
            [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
            [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
            [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]],
        ],
        np.float32,
    )
    quads = [
        (4, 5, 6, 7),  # +Z
        (1, 0, 3, 2),  # -Z
        (5, 1, 2, 6),  # +X
        (0, 4, 7, 3),  # -X
        (7, 6, 2, 3),  # +Y
        (0, 1, 5, 4),  # -Y
    ]
    tris = []
    for a, b, c, d in quads:
        tris.extend(quad(v[a], v[b], v[c], v[d]))
    return np.asarray(tris, np.float32)


def cornell_room(size=4.0):
    """Open Cornell-style room: floor, ceiling, back, left, right walls.

    Inward-facing normals; the camera looks down -Z into the open front.
    Mirrors the gi_comparison demo geometry role (project/demos/).
    """
    h = size * 0.5
    tris = []
    # floor (+Y normal)
    tris.append(quad((-h, -h, -h), (-h, -h, h), (h, -h, h), (h, -h, -h)))
    # ceiling (-Y normal)
    tris.append(quad((-h, h, -h), (h, h, -h), (h, h, h), (-h, h, h)))
    # back wall (+Z normal, at z=-h)
    tris.append(quad((-h, -h, -h), (h, -h, -h), (h, h, -h), (-h, h, -h)))
    # left wall (+X normal, at x=-h)
    tris.append(quad((-h, -h, h), (-h, -h, -h), (-h, h, -h), (-h, h, h)))
    # right wall (-X normal, at x=h)
    tris.append(quad((h, -h, -h), (h, -h, h), (h, h, h), (h, h, -h)))
    return np.concatenate(tris, axis=0)


def random_soup(n_tris: int, extent=10.0, tri_size=0.2, seed=0):
    """Random triangle soup for stress/perf tests (uniform in a cube)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-extent, extent, size=(n_tris, 1, 3)).astype(np.float32)
    offs = rng.uniform(-tri_size, tri_size, size=(n_tris, 3, 3)).astype(np.float32)
    return c + offs


def load_obj(path: str):
    """Minimal OBJ triangle loader (v / f lines; fans polygons).

    Replaces the Godot surface-array extraction as the framework's external
    mesh input path.  Returns (T, 3, 3) float32.
    """
    verts = []
    faces = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) for p in line.split()[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    return v[f]
