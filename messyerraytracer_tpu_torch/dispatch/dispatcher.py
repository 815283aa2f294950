"""RayDispatcher — the batched cast pipeline with coherence scheduling.

PyTorch counterpart of the JAX package's dispatch/dispatcher.py:

  * incoherent batches >= MIN_BATCH_FOR_SORTING are Morton-sorted, cast
    and unshuffled; the ``coherent`` hint skips the sort
  * ``windows``: the distance-windowed multi-pass cast (exact composition)
  * ``proxy``: the two-pass cast with conservative caps from a triangle
    subset (exact composition, with a rescue pass)

Both multi-pass casts are off by default, as in the JAX package.  Three
faults of the reference are kept out: the two-pass destination key is
built in int64 (its uint32 form overflows), the per-scene caches hold the
BVH by weak reference (an ``id()`` key can be recycled by a later scene),
and two-pass stats count hits from the merged result.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..core.types import ALL_LAYERS, Hits, Rays, RayStats
from ..scene.scene import RayScene
from ..utils.trace import span
from .morton import (
    _octant,
    ray_position_morton,
    sort_rays_6d,
    sort_rays_by_direction,
    unshuffle_flags,
    unshuffle_hits,
)

MIN_BATCH_FOR_SORTING = 256
PROXY_MIN_BATCH = 65536      # two-pass cast only pays off at frame scale
PROXY_DECIM = 8              # 1/8 triangle subset for the proxy pass
PROXY_SLACK = 1.001          # cap = proxy t x slack (>> kernel t rtol 1e-5)
RESCUE_BATCH = 8192          # lost rays re-cast uncapped in one sub-batch


def destination_keys(rays: Rays, ph_t, ph_hit, lo, hi, diag: float):
    """Pass-2 caps and sort keys of the two-pass cast: a proxy hit caps
    t_max at its t x PROXY_SLACK; the key is the destination's Morton code
    (origin + direction x (proxy t, else min(t_max, diag))) shifted above
    the 3-bit direction octant, in int64.  Returns (cap, keys)."""
    cap = torch.where(ph_hit, ph_t * PROXY_SLACK, rays.t_max)
    dest_t = torch.where(ph_hit, ph_t,
                         torch.clamp_max(rays.t_max, float(diag)))
    dest = rays.origin + rays.direction * dest_t[:, None]
    okey = ray_position_morton(dest, lo, hi).to(torch.int64)
    return cap, (okey << 3) | _octant(rays.direction)


def _merge_hits(hits: Hits, sub: Hits, idx: torch.Tensor,
                take: torch.Tensor) -> Hits:
    """``hits`` with rows ``idx[take]`` replaced by ``sub``'s rows
    ``take``."""
    dst = idx[take]
    out = []
    for f in ("t", "position", "normal", "u", "v", "prim_id", "hit_layers"):
        a = getattr(hits, f).clone()
        a[dst] = getattr(sub, f)[take]
        out.append(a)
    return Hits(*out)


class _PerScene:
    """Values cached per BVH object, held by weak reference: an entry dies
    with its BVH, so a later scene can never read a dead scene's value."""

    def __init__(self):
        self._values = weakref.WeakKeyDictionary()

    def get(self, bvh, make):
        if bvh not in self._values:
            self._values[bvh] = make()
        return self._values[bvh]

    def __len__(self) -> int:
        return len(self._values)


@dataclasses.dataclass
class RayDispatcher:
    """Owns a scene and routes batched casts through the coherence pipeline.

    ``backend``: "auto" (the scene's own backend), "cluster", "pallas",
    "jnp" or "brute".  ``sort`` picks the incoherent-batch coherence key:
    "6d" (octant-major, the default), "6d-origin" (origin-major) or
    "direction" (the reference's direction-only key).  ``windows``:
    ascending scene-diagonal fractions for the distance-windowed cast
    (empty = one full-range cast), applied to sorted batches only.
    ``proxy``: the two-pass cast for sorted batches >= PROXY_MIN_BATCH.
    """

    scene: RayScene
    backend: str = "auto"
    sort: str = "6d"
    windows: tuple = ()
    proxy: bool = False

    def __post_init__(self):
        self._bounds_cache = _PerScene()
        self._diag_cache = _PerScene()
        self._proxy_cache = _PerScene()

    def _scene_for(self) -> RayScene:
        if self.backend == "auto":
            return self.scene
        return dataclasses.replace(self.scene, backend=self.backend)

    def _scene_bounds(self, scene):
        """(lo, hi) of the scene's BVH root, the device rows of its boxes
        (current after a refit), once per BVH."""
        def make():
            return scene.bvh.aabb_min[0], scene.bvh.aabb_max[0]
        return self._bounds_cache.get(scene.bvh, make)

    def _scene_diag(self, scene) -> float:
        """Scene-AABB diagonal, once per BVH."""
        def make():
            lo, hi = (b.cpu().numpy() for b in self._scene_bounds(scene))
            return float(np.linalg.norm(hi - lo))
        return self._diag_cache.get(scene.bvh, make)

    def _sorted(self, rays: Rays):
        if self.sort in ("6d", "6d-origin") and \
                getattr(self.scene, "bvh", None) is not None:
            lo, hi = self._scene_bounds(self.scene)
            return sort_rays_6d(rays, lo, hi,
                                octant_major=self.sort == "6d")
        return sort_rays_by_direction(rays)

    def cast_rays(self, rays: Rays, query_mask=ALL_LAYERS,
                  coherent: bool = False) -> tuple[Hits, RayStats]:
        """Closest-hit batch cast, inside the span ``dispatch.cast``."""
        with span("dispatch.cast"):
            scene = self._scene_for()
            if coherent or rays.count < MIN_BATCH_FOR_SORTING:
                return scene.cast_rays(rays, query_mask)
            with span("dispatch.sort"):
                sorted_rays, perm = self._sorted(rays)
            with span("dispatch.scene"):
                if self.windows and getattr(scene, "bvh", None) is not None:
                    hits, stats = self._cast_windowed(scene, sorted_rays,
                                                      query_mask)
                elif (self.proxy and rays.count >= PROXY_MIN_BATCH
                        and self._proxy_scene(scene) is not None):
                    hits, stats, perm = self._cast_two_pass(
                        scene, sorted_rays, perm, query_mask)
                else:
                    hits, stats = scene.cast_rays(sorted_rays, query_mask,
                                                  incoherent=True)
            return unshuffle_hits(hits, perm), stats

    # ---- two-pass incoherent cast (proxy caps + destination sort) -----
    def _proxy_scene(self, scene):
        """1/PROXY_DECIM triangle-subset scene for the cap pass, built once
        per BVH.  The subset keeps real scene triangles (with their
        layers), so any proxy hit t is an upper bound on the ray's true
        closest t: the caps are conservative and the composition exact."""
        if getattr(scene, "bvh", None) is None or \
                getattr(scene, "tris", None) is None:
            return None

        def make():
            from ..scene.scene import build_scene

            def host(x):
                return x[::PROXY_DECIM].cpu().numpy()

            v0, e1, e2 = (host(scene.tris.v0), host(scene.tris.edge1),
                          host(scene.tris.edge2))
            if v0.shape[0] < 64:
                return None     # tiny scene: the proxy pass is pure loss
            return build_scene(v0, v0 + e1, v0 + e2,
                               layers=host(scene.tris.layers),
                               backend="cluster",
                               device=scene.tris.v0.device)
        return self._proxy_cache.get(scene.bvh, make)

    def _cast_two_pass(self, scene, sorted_rays, perm, query_mask):
        """Two-pass incoherent cast.  Pass 1 casts the sorted rays against
        the triangle-subset proxy; every proxy hit caps the ray's t_max and
        estimates its destination.  Pass 2 re-sorts by destination Morton
        key + direction octant and casts the full scene with the caps.  A
        ray the proxy hit but the capped pass missed (an edge-on hit the
        proxy's arithmetic accepted) is re-cast uncapped, so the result
        equals the single-pass cast."""
        proxy = self._proxy_scene(scene)
        ph, pstats = proxy.cast_rays(sorted_rays, query_mask,
                                     incoherent=True)
        lo, hi = self._scene_bounds(scene)
        cap, keys = destination_keys(sorted_rays, ph.t, ph.hit, lo, hi,
                                     self._scene_diag(scene))
        p2 = torch.sort(keys, stable=True).indices
        rays2 = Rays(sorted_rays.origin, sorted_rays.direction,
                     sorted_rays.t_min, cap).take(p2)
        hits, stats = scene.cast_rays(rays2, query_mask, incoherent=True)

        lost = ph.hit[p2] & ~hits.hit
        nlost = int(lost.sum())
        tmax_p2 = sorted_rays.t_max[p2]
        if nlost > RESCUE_BATCH:     # pathological: the caps were useless
            full = Rays(rays2.origin, rays2.direction, rays2.t_min, tmax_p2)
            hits, stats2 = scene.cast_rays(full, query_mask,
                                           incoherent=True)
            stats = stats + stats2
        elif nlost:
            sel = torch.nonzero(lost).squeeze(1)
            sub = Rays(rays2.origin[sel], rays2.direction[sel],
                       rays2.t_min[sel], tmax_p2[sel])
            hr, stats2 = scene.cast_rays(sub, query_mask, incoherent=True)
            stats = stats + stats2
            hits = _merge_hits(hits, hr, sel,
                               torch.ones_like(sel, dtype=torch.bool))
        stats = RayStats(
            rays_cast=torch.tensor(sorted_rays.count, dtype=torch.int64,
                                   device=hits.t.device),   # N once
            tri_tests=stats.tri_tests + pstats.tri_tests,
            bvh_nodes_visited=(stats.bvh_nodes_visited
                               + pstats.bvh_nodes_visited),
            hits=hits.hit.sum(),            # of the merged result
            stack_drops=stats.stack_drops + pstats.stack_drops,
        )
        return hits, stats, perm[p2]

    def _cast_windowed(self, scene, rays: Rays, query_mask):
        """Ascending-window multi-pass cast over pre-sorted rays.

        Window k covers per-ray t in [max(t_min, R_{k-1}), min(t_max,
        R_k)]; a closest hit found inside a window is the global closest
        (every earlier window was searched and empty), so the composition
        is exact.  Survivors are compacted to the front (stable, keeping
        the coherence sort) and padded to the next power of two."""
        n = rays.count
        diag = self._scene_diag(scene)
        fracs = sorted({float(f) for f in self.windows})
        if not all(f > 0.0 for f in fracs):
            raise ValueError(f"window fractions must be > 0, got "
                             f"{self.windows}")
        radii = [diag * f for f in fracs] + [float("inf")]
        o, d = rays.origin, rays.direction
        tmin0, tmax0 = rays.t_min, rays.t_max

        merged = stats = live = None
        r_prev = 0.0
        for r in radii:
            if merged is None:  # pass 1: all rays, no compaction
                sub = Rays(o, d, tmin0, torch.clamp_max(tmax0, r))
                merged, stats = scene.cast_rays(sub, query_mask,
                                                incoherent=True)
                live = ~merged.hit & (tmax0 > r)
            else:
                nlive = int(live.sum())
                if nlive == 0:
                    break
                order = torch.sort((~live).to(torch.uint8),
                                   stable=True).indices
                m = min(n, max(2048, 1 << (nlive - 1).bit_length()))
                sel = order[:m]
                t_lo = torch.clamp_min(tmin0[sel], r_prev)
                t_hi = torch.clamp_max(tmax0[sel], r)
                ok = live[sel] & (t_lo <= t_hi)
                sub = Rays(o[sel], d[sel], t_lo,
                           torch.where(ok, t_hi, torch.full_like(t_hi,
                                                                 -1.0)))
                h, st = scene.cast_rays(sub, query_mask, incoherent=True)
                stats = stats + st
                newly = h.hit
                merged = _merge_hits(merged, h, sel, newly)
                retired = newly | (tmax0[sel] <= r)
                live = live.clone()
                live[sel] = live[sel] & ~retired
            r_prev = r
        # rays_cast would multi-count re-cast survivors; report N once
        stats = RayStats(
            rays_cast=torch.tensor(n, dtype=torch.int64,
                                   device=merged.t.device),
            tri_tests=stats.tri_tests,
            bvh_nodes_visited=stats.bvh_nodes_visited,
            hits=stats.hits,
            stack_drops=stats.stack_drops,
        )
        return merged, stats

    def any_hit_rays(self, rays: Rays, query_mask=ALL_LAYERS,
                     coherent: bool = False) -> torch.Tensor:
        """Occlusion batch cast, inside the span ``dispatch.cast``."""
        with span("dispatch.cast"):
            scene = self._scene_for()
            if coherent or rays.count < MIN_BATCH_FOR_SORTING:
                return scene.any_hit_rays(rays, query_mask)
            with span("dispatch.sort"):
                sorted_rays, perm = self._sorted(rays)
            with span("dispatch.scene"):
                occ = scene.any_hit_rays(sorted_rays, query_mask,
                                         incoherent=True)
            return unshuffle_flags(occ, perm)

