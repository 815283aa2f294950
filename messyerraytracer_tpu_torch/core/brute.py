"""Brute-force O(N*T) cast — the port's validation oracle.

Every (ray, triangle) pair is tested by a dense Moller-Trumbore, chunked
over rays x triangles so memory stays O(ray_chunk * chunk): a 4096-ray
subsample against a 1M-triangle scene fits on the card.  Same hit
semantics as the JAX package's core/brute.py: strictly-closer update over
triangle chunks visited in index order, lowest index wins exact ties,
layer-mask filtering during iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from .geometry import closest_select, moller_trumbore
from .types import (
    ALL_LAYERS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    Triangles,
    make_miss,
)


def _i64(x, device) -> torch.Tensor:
    return torch.tensor(int(x), dtype=torch.int64, device=device)


def _chunk_valid(rays, tris, r0, r1, s, e, query_mask):
    valid, t, u, v = moller_trumbore(
        rays.origin[r0:r1, None, :], rays.direction[r0:r1, None, :],
        rays.t_min[r0:r1, None], rays.t_max[r0:r1, None],
        tris.v0[None, s:e], tris.edge1[None, s:e], tris.edge2[None, s:e],
    )
    valid = valid & ((tris.layers[None, s:e] & query_mask) != 0)
    return valid, t, u, v


def cast_rays_brute(rays: Rays, tris: Triangles,
                    query_mask: int = ALL_LAYERS, chunk: int = 2048,
                    ray_chunk: int = 4096) -> tuple[Hits, RayStats]:
    """Closest-hit cast of every ray against every triangle.

    Returns (hits, stats).  ``chunk`` triangles by ``ray_chunk`` rays are
    tested per step."""
    n = rays.count
    dev = rays.origin.device
    query_mask = int(query_mask)
    if tris.count == 0:
        z = _i64(0, dev)
        return make_miss(n, dev), RayStats(
            rays_cast=_i64(n, dev), tri_tests=z, bvh_nodes_visited=z,
            hits=z.clone(), stack_drops=z.clone())

    best_t = torch.full((n,), T_MAX_DEFAULT, dtype=torch.float32, device=dev)
    best_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    for r0 in range(0, n, ray_chunk):
        r1 = min(r0 + ray_chunk, n)
        bt, bs = best_t[r0:r1], best_slot[r0:r1]
        bu, bv = best_u[r0:r1], best_v[r0:r1]
        for s in range(0, tris.count, chunk):
            e = min(s + chunk, tris.count)
            valid, t, u, v = _chunk_valid(rays, tris, r0, r1, s, e,
                                          query_mask)
            local = torch.arange(e - s, device=dev)[None, :]
            any_valid, arg = closest_select(valid, t, local)
            a = arg[:, None]
            cand_t = torch.where(any_valid, t.gather(1, a)[:, 0],
                                 torch.full_like(bt, T_MAX_DEFAULT))
            better = cand_t < bt        # strict: earlier chunk wins ties
            bt.copy_(torch.where(better, cand_t, bt))
            bs.copy_(torch.where(better, s + arg, bs))
            bu.copy_(torch.where(better, u.gather(1, a)[:, 0], bu))
            bv.copy_(torch.where(better, v.gather(1, a)[:, 0], bv))

    hit = best_slot >= 0
    slot = best_slot.clamp_min(0)
    zero = torch.zeros_like(best_t)
    hits = Hits(
        t=torch.where(hit, best_t, torch.full_like(best_t, T_MAX_DEFAULT)),
        position=torch.where(hit[:, None],
                             rays.origin + rays.direction * best_t[:, None],
                             zero[:, None]),
        normal=torch.where(hit[:, None], tris.normal[slot], zero[:, None]),
        u=torch.where(hit, best_u, zero),
        v=torch.where(hit, best_v, zero),
        prim_id=torch.where(hit, tris.prim_id[slot],
                            torch.full_like(tris.prim_id[slot], NO_HIT)),
        hit_layers=torch.where(hit, tris.layers[slot],
                               torch.zeros_like(tris.layers[slot])),
    )
    masked_tris = ((tris.layers & query_mask) != 0).sum()
    stats = RayStats(
        rays_cast=_i64(n, dev),
        tri_tests=n * masked_tris,
        bvh_nodes_visited=_i64(0, dev),
        hits=hit.sum(),
        stack_drops=_i64(0, dev),
    )
    return hits, stats


TIE_RTOL = 4e-6   # ~8 ulps at f32: formulation noise, not geometry


def parity(hits: Hits, oracle: Hits, rtol: float = 1e-5,
           atol: float = 1e-8) -> bool:
    """t + prim_id parity against the oracle (the JAX package's
    ``bench.py::parity`` rule).

    Every ray's t must agree to ``rtol`` (plus ``atol``, numpy's default
    as in bench.py; a caller whose rays start next to surfaces passes the
    few ulps of the scene's coordinates that anchored arithmetic adds to
    t).  prim_id must be equal, except
    on shared-edge ties: the oracle breaks ties by lowest index, a
    traversal by visit order, and the two evaluate the edge with
    different (anchored vs classic) Moller-Trumbore arithmetic — so a prim
    mismatch passes where t agrees within TIE_RTOL."""
    ps, pb = hits.prim_id.cpu().numpy(), oracle.prim_id.cpu().numpy()
    ts, tb = hits.t.cpu().numpy(), oracle.t.cpu().numpy()
    tie = np.abs(ts - tb) <= TIE_RTOL * np.maximum(np.abs(tb), 1.0)
    return bool(np.all((ps == pb) | tie)) and bool(
        np.allclose(ts, tb, rtol=rtol, atol=atol))


def any_hit_brute(rays: Rays, tris: Triangles,
                  query_mask: int = ALL_LAYERS, chunk: int = 2048,
                  ray_chunk: int = 4096) -> torch.Tensor:
    """(N,) bool occlusion query — does each ray hit *anything*?"""
    n = rays.count
    dev = rays.origin.device
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    for r0 in range(0, n, ray_chunk):
        r1 = min(r0 + ray_chunk, n)
        for s in range(0, tris.count, chunk):
            e = min(s + chunk, tris.count)
            valid, _, _, _ = _chunk_valid(rays, tris, r0, r1, s, e,
                                          int(query_mask))
            occluded[r0:r1] |= valid.any(dim=-1)
    return occluded
