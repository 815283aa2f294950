"""Debug helpers.

PyTorch counterpart of the JAX package's debug/debug.py; only the stats
summary is ported so far (the draw modes and heatmaps wait for ROADMAP
A.9).
"""

from __future__ import annotations


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
