"""Flat scene container — build triangles + BVH + cast tables, cast rays.

PyTorch counterpart of ``messyerraytracer_tpu/scene/scene.py``: owns the
SoA triangle tensors (in BVH slot order), the BVH and the tables of its
backend, and exposes closest-hit / any-hit casts.  Backends: ``cluster``
(the default; kernel B1 on CUDA), ``pallas`` (the wide-node tables; kernel
B4 on CUDA), ``frontier`` / ``frontier_q`` (the level-by-level cast of
``accel/frontier.py``, exact or 8-bit quantized boxes, plain PyTorch),
``jnp`` (the per-ray binary-BVH traversal in plain PyTorch) and ``brute``
(the oracle).

The frontier tables are built lazily on first use and cached in a holder
that ``dataclasses.replace`` shares between a scene and its copies (the
dispatcher switches backends that way), each entry used only while the
scene's BVH and triangles are the ones it was built from (a copy given
other ones, by ``replace`` or a move to another device, builds them anew).  A
refit starts a new holder, so that the refit scene's tables do not evict
those of the scene it came from.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import BVH, _bvh_host, build_bvh, refit_bvh
from ..accel.frontier import (
    FrontierScene,
    build_frontier_scene,
    cast_rays_frontier,
)
from ..accel.traverse import cast_rays_bvh
from ..core.brute import any_hit_brute, cast_rays_brute
from ..core.geometry import aabb_of_triangles, triangle_fields
from ..core.types import (
    ALL_LAYERS,
    DEFAULT_DEVICE,
    Hits,
    Rays,
    RayStats,
    Triangles,
    triangle_fields_np,
)
from ..kernels.cluster import (
    ClusterScene,
    build_cluster_scene,
    cluster_tcap_for,
    refresh_cluster_scene,
)
from ..kernels.cluster_v2 import cast_rays_cluster_v2
from ..kernels.traverse_pallas import cast_rays_wide
from ..kernels.wide import (
    WideScene,
    build_wide8_scene,
    build_wide_scene,
    refresh_wide_scene,
)
from ..utils.trace import span

BACKENDS = ("cluster", "pallas", "frontier", "frontier_q", "jnp", "brute")


@dataclasses.dataclass
class RayScene:
    """Flat (single-level) scene: reordered triangles + BVH.

    ``tris`` is in BVH slot order; ``tris.prim_id`` carries the original
    triangle ids so hits report stable ids across rebuilds.
    """

    tris: Triangles
    bvh: BVH
    wide: WideScene | None = None
    cluster: ClusterScene | None = None
    use_bvh: bool = True       # False = brute-force validation mode
    backend: str = "cluster"
    # {quantize: (bvh, tris, FrontierScene)}, see the module docstring
    _frontier_cache: dict = dataclasses.field(default_factory=dict,
                                              repr=False)

    @property
    def num_tris(self) -> int:
        return self.tris.count

    def _frontier_tables(self, quantize: bool) -> FrontierScene:
        hit = self._frontier_cache.get(quantize)
        if hit is None or hit[0] is not self.bvh or hit[1] is not self.tris:
            hit = (self.bvh, self.tris,
                   build_frontier_scene(self.bvh, self.tris, quantize))
            self._frontier_cache[quantize] = hit
        return hit[2]

    @property
    def frontier(self) -> FrontierScene:
        """Frontier-backend tables, built lazily on first use."""
        return self._frontier_tables(False)

    @property
    def frontier_q(self) -> FrontierScene:
        """Quantized (8-bit child boxes) frontier tables, built lazily."""
        return self._frontier_tables(True)

    def _frontier_for_backend(self) -> FrontierScene:
        return (self.frontier_q if self.backend == "frontier_q"
                else self.frontier)

    def cast_rays(self, rays: Rays, query_mask=ALL_LAYERS,
                  incoherent: bool = False) -> tuple[Hits, RayStats]:
        """Batched closest-hit cast.  ``incoherent`` is the JAX package's
        knob-routing hint; the port has one kernel configuration."""
        del incoherent
        if not self.use_bvh or self.backend == "brute":
            return cast_rays_brute(rays, self.tris, query_mask)
        if self.backend in ("frontier", "frontier_q"):
            hits, stats, _ = cast_rays_frontier(
                rays, self._frontier_for_backend(), self.tris,
                int(query_mask))
            return hits, stats
        if self.backend == "cluster" and self.cluster is not None:
            hits, stats, _ = cast_rays_cluster_v2(rays, self.cluster,
                                                  int(query_mask))
            return hits, stats
        if self.backend == "pallas" and self.wide is not None:
            hits, stats, _ = cast_rays_wide(rays, self.wide, int(query_mask))
            return hits, stats
        hits, stats, _ = cast_rays_bvh(rays, self.tris, self.bvh, query_mask)
        return hits, stats

    def any_hit_rays(self, rays: Rays, query_mask=ALL_LAYERS,
                     incoherent: bool = False) -> torch.Tensor:
        """Batched occlusion query."""
        del incoherent
        if not self.use_bvh or self.backend == "brute":
            return any_hit_brute(rays, self.tris, query_mask)
        if self.backend in ("frontier", "frontier_q"):
            _, _, occluded = cast_rays_frontier(
                rays, self._frontier_for_backend(), self.tris,
                int(query_mask), any_hit=True)
            return occluded
        if self.backend == "cluster" and self.cluster is not None:
            _, _, occluded = cast_rays_cluster_v2(
                rays, self.cluster, int(query_mask), any_hit=True)
            return occluded
        if self.backend == "pallas" and self.wide is not None:
            _, _, occluded = cast_rays_wide(rays, self.wide,
                                            int(query_mask), any_hit=True)
            return occluded
        _, _, occluded = cast_rays_bvh(rays, self.tris, self.bvh,
                                       query_mask, any_hit=True)
        return occluded

    def refit(self, v0, v1, v2) -> "RayScene":
        """Refit to moved vertices (same topology and slot order), on the
        device the tables live on.

        ``v0`` / ``v1`` / ``v2`` are (T, 3) arrays or tensors in the
        ORIGINAL triangle order; they go to the tables' device, are put in
        slot order by ``tri_order``, the triangles are re-derived, the BVH
        refit and the backend's tables refreshed.  Returns a new scene;
        the old one stays valid and unchanged, and the new one builds
        its frontier tables anew."""
        dev = self.tris.v0.device
        perm = self.bvh.tri_order.long()
        slot = [torch.as_tensor(v if isinstance(v, torch.Tensor)
                                else np.asarray(v, np.float32),
                                dtype=torch.float32, device=dev)[perm]
                for v in (v0, v1, v2)]
        return _refit_slots(self, *slot)


def _refit_slots(scene: RayScene, v0, v1, v2) -> RayScene:
    """``scene`` refit to slot-ordered vertex tensors on its device: the
    triangles re-derived (``triangle_fields``), their boxes taken from
    v0, v0 + e1 and v0 + e2 as the JAX package does, the BVH refit, then
    the wide and cluster tables refreshed, the frontier tables left to be
    built anew.  Nothing of ``scene`` is written."""
    with span("refit.scene"):
        v0, e1, e2, nrm = triangle_fields(v0, v1, v2)
        tris = Triangles(v0=v0, edge1=e1, edge2=e2, normal=nrm,
                         prim_id=scene.tris.prim_id,
                         layers=scene.tris.layers)
        bvh = refit_bvh(scene.bvh, *aabb_of_triangles(tris.v0, tris.v1,
                                                      tris.v2))
        wide = (refresh_wide_scene(scene.wide, bvh, tris)
                if scene.wide is not None else None)
        cluster = (refresh_cluster_scene(scene.cluster, bvh, tris)
                   if scene.cluster is not None else None)
        # a holder of its own: the refit scene's tables must not evict
        # those of ``scene``, which stays usable as in the JAX package
        return dataclasses.replace(scene, tris=tris, bvh=bvh, wide=wide,
                                   cluster=cluster, _frontier_cache={})


def build_scene(v0, v1, v2, layers=None, prim_id=None, use_bvh=True,
                backend="cluster", branching=8,
                device=DEFAULT_DEVICE) -> RayScene:
    """Build a flat scene from (T,3) vertex arrays on ``device``.

    The BVH build and the table layout run on the host; the returned
    tensors live on ``device``.  ``branching`` (8 or 2) picks the wide
    layout of the ``pallas`` backend."""
    from .. import _tune_malloc

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend == "pallas" and branching not in (2, 8):
        raise ValueError(f"branching must be 2 or 8, got {branching}")
    _tune_malloc()  # lazy, once: large-buffer heap reuse for this build
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    bvh = build_bvh(v0, v1, v2, device=device)
    perm = _bvh_host(bvh, "tri_order")
    prim_id = (np.arange(t, dtype=np.int32) if prim_id is None
               else np.asarray(prim_id, np.int32))
    layers = (np.full((t,), ALL_LAYERS, np.int32) if layers is None
              else np.asarray(layers, np.int32))
    pv0, e1, e2, nrm = triangle_fields_np(v0[perm], v1[perm], v2[perm])
    host = (pv0, e1, e2, nrm, prim_id[perm], layers[perm])
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    tris = Triangles(*(put(a) for a in host))
    cluster = wide = None
    if backend == "cluster":
        cluster = build_cluster_scene(bvh, tris, _np=host,
                                      tcap=cluster_tcap_for(t),
                                      device=device)
    elif backend == "pallas":
        builder = build_wide8_scene if branching == 8 else build_wide_scene
        fit = _wide_vmem_fit(bvh, branching)
        wide = builder(bvh, tris, _np=host, stream_leaves=fit != "resident",
                       stream_nodes=fit == "stream_all", device=device)
    return RayScene(tris=tris, bvh=bvh, wide=wide, cluster=cluster,
                    use_bvh=use_bvh, backend=backend)


# The JAX package's VMEM fit of the wide layout on a TPU v5e (its
# scene.py:281-308): it decides the scene's stream_leaves / stream_nodes
# flags, which the port carries so its scenes record the same flags.  They
# change nothing on the card, where one kernel reads the scene from device
# memory either way.
_WIDE_VMEM_BUDGET = 96 * 1024 * 1024


def _wide_vmem_fit(bvh: BVH, branching: int = 8) -> str:
    # 'resident' | 'stream' | 'stream_all' -- how much of the layout fits
    count = _bvh_host(bvh, "count")
    num_internal = int((count == 0).sum()) + 1
    num_leaf = int((count > 0).sum()) + 1
    if branching == 8:
        nw = num_internal // 5 + 2
        node_bytes = -(-nw // 2) * 512         # 2 nodes per 512B row
    else:
        node_bytes = -(-num_internal // 8) * 512  # 8 nodes per 512B row
    leaf_bytes = -(-num_leaf // 2) * 512       # 2 leaves per 512B row
    if node_bytes + leaf_bytes <= _WIDE_VMEM_BUDGET:
        return "resident"
    if node_bytes <= _WIDE_VMEM_BUDGET - 1024 * 1024:
        return "stream"
    return "stream_all"


def build_scene_from_tri_array(tri_array, **kw) -> RayScene:
    """Convenience: build from a (T, 3, 3) vertex array."""
    tri_array = np.asarray(tri_array, np.float32)
    return build_scene(tri_array[:, 0], tri_array[:, 1], tri_array[:, 2],
                       **kw)
