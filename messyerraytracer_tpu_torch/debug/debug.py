"""Debug draw modes, per-ray cost heatmaps, BVH wireframes and stats.

PyTorch counterpart of the JAX package's debug/debug.py: each of the
reference's 7 draw modes becomes a per-ray color array over the debug
grid, and the BVH wireframe an array of line segments.  Colors, counts
and segments are tensors on the device of the scene they were cast over;
each color is computed in the JAX package's dtype (float64 where its
numpy widens, float32 elsewhere, IEEE division) and returned as float32.

Per-ray costs come from kernel B1's own per-ray counters on a cluster
scene (``return_per_ray=True``) and from the frontier cast's
traversal-exact counters (``accel/frontier.py``) on any other
``RayScene``, as in the JAX package; a scene-like object without frontier
tables falls back to the mean.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core.types import DEFAULT_DEVICE, Hits, Rays
from ..render.camera import debug_grid_rays

DRAW_RAYS = 0
DRAW_NORMALS = 1
DRAW_DISTANCE = 2
DRAW_HEATMAP = 3
DRAW_OVERHEAT = 4
DRAW_BVH = 5
DRAW_LAYERS = 6

_HIT_GREEN = (0.2, 1.0, 0.2)
_MISS_GREY = (0.4, 0.4, 0.4)


@dataclasses.dataclass
class DebugCastResult:
    """What ``cast_debug_rays`` produces: the rays, their hits, per-ray
    colors (N, 3) float32 in [0, 1] for the selected mode, the cast's
    summary and its wall time (after the device finished)."""

    rays: Rays
    hits: Hits
    colors: torch.Tensor
    tri_tests_per_ray: float
    nodes_per_ray: float
    hit_rate: float
    elapsed_ms: float
    grid: tuple                 # (w, h)


def _pick(mask: torch.Tensor, yes, no) -> torch.Tensor:
    """(N, 3) float64 rows: ``yes`` where ``mask``, else ``no``."""
    dev = mask.device
    # float64, as the JAX package's numpy widens these colors
    yes = torch.as_tensor(yes, dtype=torch.float64, device=dev)  # lint: off
    no = torch.as_tensor(no, dtype=torch.float64, device=dev)  # lint: off
    return torch.where(mask[:, None], yes, no)


def _heat_color(t: torch.Tensor) -> torch.Tensor:
    """Blue -> green -> red heat ramp for cost visualization, in the dtype
    of ``t`` (float32 from the callers here)."""
    t = t.clamp(0.0, 1.0)
    r = (2.0 * t - 1.0).clamp(0.0, 1.0)
    g = 1.0 - (2.0 * t - 1.0).abs()
    b = (1.0 - 2.0 * t).clamp(0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


def _over(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x / scale`` as numpy divides an array by a Python float: a true
    division by the scale in ``x``'s dtype (a tensor, since CUDA divides
    by a Python scalar through its reciprocal)."""
    return x / torch.tensor(scale, dtype=x.dtype, device=x.device)


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cast_debug_rays(scene, origin, forward, grid_w: int = 16,
                    grid_h: int = 12, fov_degrees: float = 60.0,
                    draw_mode: int = DRAW_RAYS, heatmap_max: float = 64.0,
                    overheat_threshold: float = 32.0,
                    device=DEFAULT_DEVICE) -> DebugCastResult:
    """Generate the camera-basis ray grid on ``device``, cast it through
    ``scene`` with stats, and map the results to per-ray colors for
    ``draw_mode`` (the JAX package's BASELINE config #1 / #5 entry)."""
    rays = debug_grid_rays(origin, forward, grid_w, grid_h, fov_degrees,
                           device=device)
    dev = rays.origin.device
    _wait(dev)
    t0 = time.perf_counter()
    hits, stats = scene.cast_rays(rays)
    _wait(dev)
    elapsed = (time.perf_counter() - t0) * 1e3

    hit = hits.hit
    tri_per_ray = float(stats.avg_tri_tests_per_ray())
    if draw_mode == DRAW_NORMALS:
        colors = torch.where(hit[:, None], hits.normal * 0.5 + 0.5,
                             torch.zeros_like(hits.normal))
    elif draw_mode == DRAW_DISTANCE:
        t = hits.t
        tmax = (float(t[hit].max()) if bool(hit.any()) else 1.0)
        d = 1.0 - _over(t, max(tmax, 1e-6)).clamp(0.0, 1.0)
        colors = torch.where(hit, d, torch.zeros_like(d))[:, None].expand(
            -1, 3)
    elif draw_mode in (DRAW_HEATMAP, DRAW_OVERHEAT):
        tt = _per_ray_tri_tests(scene, rays)
        if tt is None:      # no per-ray counters for this scene
            tt = torch.full((rays.count,), tri_per_ray, dtype=torch.float32,
                            device=dev)
        if draw_mode == DRAW_HEATMAP:
            colors = _heat_color(_over(tt, heatmap_max))
        else:
            colors = _pick(tt > overheat_threshold, (1.0, 0.1, 0.1),
                           (0.2, 0.8, 0.2))
    elif draw_mode == DRAW_LAYERS:
        # (layers * 2654435761) & 0xFFFFFF in uint32: the low 24 bits of
        # a product need only the low 24 bits of its operands
        h = ((hits.hit_layers.long() & 0xFFFFFF)
             * (2654435761 & 0xFFFFFF)) & 0xFFFFFF
        # float64, as the JAX package's numpy widens the byte colors
        rgb = torch.stack([h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF],
                          dim=-1).double()  # lint: off
        colors = _over(rgb, 255.0) * hit[:, None]
    else:   # DRAW_RAYS; DRAW_BVH draws ray colors too (see bvh_wireframe)
        colors = _pick(hit, _HIT_GREEN, _MISS_GREY)

    return DebugCastResult(
        rays=rays, hits=hits, colors=colors.to(torch.float32).contiguous(),
        tri_tests_per_ray=tri_per_ray,
        nodes_per_ray=float(stats.avg_nodes_per_ray()),
        hit_rate=float(stats.hit_rate()), elapsed_ms=elapsed,
        grid=(grid_w, grid_h))


def _frontier_per_ray(scene, rays: Rays):
    """The frontier cast's per-ray counters over ``scene``'s frontier
    tables."""
    from ..accel.frontier import cast_rays_frontier

    _, _, _, per_ray = cast_rays_frontier(rays, scene.frontier, scene.tris,
                                          return_per_ray_stats=True)
    return per_ray


def _per_ray_tri_tests(scene, rays: Rays):
    """Per-ray triangle-test counts (float32): kernel B1's own counters
    when ``scene`` runs the cluster backend, else the frontier cast's;
    None for a scene without frontier tables (no ``RayScene``)."""
    if (getattr(scene, "backend", None) == "cluster"
            and getattr(scene, "cluster", None) is not None):
        from ..kernels.cluster_v2 import cast_rays_cluster_v2

        _, _, _, per_ray = cast_rays_cluster_v2(rays, scene.cluster,
                                                return_per_ray=True)
        return per_ray["tri_tests"].to(torch.float32)
    if not hasattr(scene, "frontier"):
        return None
    return _frontier_per_ray(scene, rays)["tri_tests"].to(torch.float32)


def per_ray_cost_heatmap(scene, rays: Rays, heatmap_max: float = 64.0,
                         backend: str | None = None):
    """Per-ray cost colors from per-ray counters.

    Returns (colors (N, 3) f32, tri_tests (N,) f32, node_visits (N,) f32).
    ``backend`` "cluster" (or None on a cluster scene) reads kernel B1's
    counters from the cluster tables; "frontier" (or None on any other
    scene) the frontier cast's over ``scene.frontier``."""
    use_cluster = backend == "cluster" or (
        backend is None and getattr(scene, "backend", None) == "cluster"
        and getattr(scene, "cluster", None) is not None)
    if use_cluster:
        from ..kernels.cluster_v2 import cast_rays_cluster_v2

        _, _, _, per_ray = cast_rays_cluster_v2(rays, scene.cluster,
                                                return_per_ray=True)
        nodes = per_ray["node_visits"]
    else:
        per_ray = _frontier_per_ray(scene, rays)
        nodes = per_ray["nodes_visited"]
    tt = per_ray["tri_tests"].to(torch.float32)
    return _heat_color(_over(tt, heatmap_max)), tt, nodes.to(torch.float32)


# the 12 box edges between the 8 corners, corner k = (cx, cy, cz) bits
# (4, 2, 1) of k
_EDGES = ((0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
          (0, 4), (1, 5), (2, 6), (3, 7))


def bvh_wireframe(bvh, max_depth: int | None = None,
                  leaves_only: bool = False):
    """BVH node boxes as line segments, on the BVH's device: returns
    (segments (S, 2, 3) f32, depth (S,) i32), 12 edges per selected node
    tagged with its tree depth (from ``bvh.levels``).  ``leaves_only``
    selects the leaves, ``max_depth`` the nodes down to that depth."""
    amin, amax = bvh.aabb_min, bvh.aabb_max
    dev = amin.device
    depth = torch.zeros(amin.shape[0], dtype=torch.int32, device=dev)
    for d, li in enumerate(bvh.levels):
        depth[li.long()] = d
    if leaves_only:
        sel = torch.nonzero(bvh.count > 0)[:, 0]
    elif max_depth is not None:
        sel = torch.nonzero(depth <= max_depth)[:, 0]
    else:
        sel = torch.arange(amin.shape[0], device=dev)
    mn, mx = amin[sel], amax[sel]
    corners = torch.stack(
        [torch.stack([(mx if cx else mn)[:, 0], (mx if cy else mn)[:, 1],
                      (mx if cz else mn)[:, 2]], dim=-1)
         for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)], dim=1)
    a = torch.tensor([e[0] for e in _EDGES], device=dev)
    b = torch.tensor([e[1] for e in _EDGES], device=dev)
    segs = torch.stack([corners[:, a], corners[:, b]], dim=2)  # (n,12,2,3)
    return (segs.reshape(-1, 2, 3),
            depth[sel].repeat_interleave(len(_EDGES)))


def stats_summary(stats) -> dict:
    """Script-facing stats dict of a ``RayStats`` (plain Python numbers)."""
    return {
        "rays_cast": int(stats.rays_cast),
        "tri_tests": int(stats.tri_tests),
        "bvh_nodes_visited": int(stats.bvh_nodes_visited),
        "hits": int(stats.hits),
        "avg_tri_tests_per_ray": float(stats.avg_tri_tests_per_ray()),
        "avg_nodes_per_ray": float(stats.avg_nodes_per_ray()),
        "hit_rate": float(stats.hit_rate()),
    }
