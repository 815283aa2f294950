"""Binned-SAH BVH: host build (native C++ or numpy) + tensors on a device.

PyTorch counterpart of ``messyerraytracer_tpu/accel/bvh.py``; the same
documented semantics:

  * binned SAH, 12 candidate split planes per axis   (BVH_BINS = 12)
  * MAX_LEAF_SIZE = 4 triangles
  * DFS-ordered node array: left child is implicitly ``node + 1``;
    internal nodes store the *right* child index in ``left_first``
  * leaf nodes: ``left_first`` = first triangle slot, ``count`` > 0

The build runs on the host; ``BVH.host`` keeps the numpy arrays (every
build-time consumer reads those) and the tensor fields hold copies on the
chosen device.  ``refit_bvh`` recomputes the node boxes on that device, a
level-synchronous bottom-up sweep over ``BVH.levels``; the BVH it returns
has ``host=None``, since the build's copies no longer hold its boxes, and
every consumer reads host arrays through ``_bvh_host``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..core.geometry import centroid_of_triangles
from ..core.types import DEFAULT_DEVICE
from ..utils.trace import span

BVH_BINS = 12
MAX_LEAF_SIZE = 4
STACK_DEPTH = 64     # the traversal stack's depth cap (accel/traverse.py)


@dataclasses.dataclass(eq=False)
class BVH:
    """SoA BVH node arrays; compared and hashed by identity (so per-scene
    caches can hold it by weak reference).

    aabb_min / aabb_max: (M, 3) float32
    left_first:          (M,)   int32 — internal: right child; leaf: first slot
    count:               (M,)   int32 — 0 for internal nodes
    tri_order:           (N,)   int32 — tri slot -> original triangle index
    split_axis:          (M,)   int32 — SAH split axis per internal node
    levels:              tuple of (M_d,) int32 node-index tensors, one per
                         tree depth, root level first (the refit's sweep)
    host:                dict of the same arrays in numpy as the build made
                         them; None after a refit
    """

    aabb_min: torch.Tensor
    aabb_max: torch.Tensor
    left_first: torch.Tensor
    count: torch.Tensor
    tri_order: torch.Tensor
    split_axis: torch.Tensor
    levels: tuple
    host: dict | None

    @property
    def num_nodes(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def num_tris(self) -> int:
        return self.tri_order.shape[0]


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              use_native: bool = True, device=DEFAULT_DEVICE) -> BVH:
    """Build a binned-SAH BVH over triangles given by vertex arrays (N,3).

    The caller applies ``tri_order`` to its triangle SoA so leaf ranges
    are contiguous."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    if use_native:
        from ..native import native_build_bvh

        res = native_build_bvh(v0, v1, v2)
        if res is not None:
            return _finalize_bvh(*res[:7], device=device)
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = centroid_of_triangles(v0, v1, v2)
    # as in the JAX package, this still tries the native AABB builder
    return build_bvh_over_aabbs(tri_min, tri_max, centroid, device=device)


def _bvh_host(bvh: BVH, name: str) -> np.ndarray:
    """A build array of ``bvh`` in numpy: the build's host copy when there
    is one, else read back from the device (a refit BVH has none)."""
    if bvh.host is not None:
        return bvh.host[name]
    return getattr(bvh, name).cpu().numpy()


def _depth_levels(depth: np.ndarray) -> list:
    """Per-depth node index arrays, root level first: a stable argsort by
    depth, as the JAX package orders them."""
    depth = np.asarray(depth)
    max_depth = int(depth.max()) if depth.size else 0
    sort_key = np.argsort(depth, kind="stable").astype(np.int32)
    offsets = np.concatenate(
        [[0], np.cumsum(np.bincount(depth, minlength=max_depth + 1))])
    return [sort_key[offsets[d]:offsets[d + 1]] for d in range(max_depth + 1)]


def _finalize_bvh(node_min, node_max, left_first, count, depth, axis,
                  order, device=DEFAULT_DEVICE) -> BVH:
    host = {
        "aabb_min": node_min.astype(np.float32),
        "aabb_max": node_max.astype(np.float32),
        "left_first": left_first.astype(np.int32),
        "count": count.astype(np.int32),
        "tri_order": order.astype(np.int32),
        "split_axis": axis.astype(np.int32),
    }
    put = lambda k: torch.as_tensor(host[k], device=device)  # noqa: E731
    return BVH(aabb_min=put("aabb_min"), aabb_max=put("aabb_max"),
               left_first=put("left_first"), count=put("count"),
               tri_order=put("tri_order"), split_axis=put("split_axis"),
               levels=tuple(torch.as_tensor(lv, device=device)
                            for lv in _depth_levels(depth)),
               host=host)


def build_bvh_over_aabbs(tri_min, tri_max, centroid,
                         max_leaf_size: int = MAX_LEAF_SIZE,
                         use_native: bool = True,
                         device=DEFAULT_DEVICE) -> BVH:
    """Binned-SAH build over arbitrary primitive AABBs + centroids (the
    cluster-TLAS pair tree uses ``max_leaf_size=1``).

    Routes through the native builder when available; the numpy body
    below is the readable specification and the no-compiler fallback.
    """
    tri_min = np.asarray(tri_min, np.float32)
    tri_max = np.asarray(tri_max, np.float32)
    centroid = np.asarray(centroid, np.float32)
    n = tri_min.shape[0]
    if n == 0:
        raise ValueError("build_bvh: cannot build over 0 primitives")

    if use_native:
        from ..native import native_build_bvh_aabbs

        res = native_build_bvh_aabbs(tri_min, tri_max, centroid,
                                     max_leaf_size)
        if res is not None:
            return _finalize_bvh(*res[:7], device=device)

    order = np.arange(n, dtype=np.int32)  # tri slots -> original index

    max_nodes = max(2 * n - 1, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    left_first = np.zeros(max_nodes, np.int32)
    count = np.zeros(max_nodes, np.int32)
    depth_arr = np.zeros(max_nodes, np.int32)
    axis_arr = np.zeros(max_nodes, np.int32)
    num_nodes = 0

    def surface_area(bmin, bmax):
        d = np.maximum(bmax - bmin, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    def emit(start, end, depth):
        """Emit the subtree over tri slots [start, end) in DFS order."""
        nonlocal num_nodes
        node = num_nodes
        num_nodes += 1
        idx = order[start:end]
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        node_min[node] = bmin
        node_max[node] = bmax
        depth_arr[node] = depth
        cnt = end - start

        if cnt <= max_leaf_size:
            left_first[node] = start
            count[node] = cnt
            return node

        cent = centroid[idx]
        cmin = cent.min(axis=0)
        cmax = cent.max(axis=0)
        extent = cmax - cmin
        best_cost = np.inf
        best_axis = -1
        best_bin = -1

        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            scale = BVH_BINS / extent[axis]
            bins = np.minimum(
                ((cent[:, axis] - cmin[axis]) * scale).astype(np.int32),
                BVH_BINS - 1,
            )
            bin_counts = np.bincount(bins, minlength=BVH_BINS)
            bin_min = np.full((BVH_BINS, 3), np.inf, np.float32)
            bin_max = np.full((BVH_BINS, 3), -np.inf, np.float32)
            np.minimum.at(bin_min, bins, tri_min[idx])
            np.maximum.at(bin_max, bins, tri_max[idx])

            lcnt = np.cumsum(bin_counts)[:-1]
            rcnt = cnt - lcnt
            lmin = np.minimum.accumulate(bin_min, axis=0)[:-1]
            lmax = np.maximum.accumulate(bin_max, axis=0)[:-1]
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1][1:]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1][1:]

            valid = (lcnt > 0) & (rcnt > 0)
            cost = np.where(
                valid,
                lcnt * surface_area(lmin, lmax)
                + rcnt * surface_area(rmin, rmax),
                np.inf,
            )
            k = int(np.argmin(cost))
            if cost[k] < best_cost:
                best_cost = cost[k]
                best_axis = axis
                best_bin = k

        if best_axis < 0:
            # Degenerate centroids: median split on the longest AABB axis.
            best_axis = int(np.argmax(bmax - bmin))
            axis_arr[node] = best_axis
            key = cent[:, best_axis]
            mid_local = cnt // 2
            part = np.argpartition(key, mid_local)
            order[start:end] = idx[part]
            mid = start + mid_local
        else:
            scale = BVH_BINS / extent[best_axis]
            bins = np.minimum(
                ((cent[:, best_axis] - cmin[best_axis]) * scale
                 ).astype(np.int32),
                BVH_BINS - 1,
            )
            go_left = bins <= best_bin
            order[start:end] = np.concatenate([idx[go_left], idx[~go_left]])
            mid = start + int(go_left.sum())
            if mid == start or mid == end:  # never emit an empty child
                mid_local = cnt // 2
                part = np.argpartition(cent[:, best_axis], mid_local)
                order[start:end] = idx[part]
                mid = start + mid_local

        count[node] = 0
        axis_arr[node] = best_axis
        emit(start, mid, depth + 1)                     # left child = node+1
        right = emit(mid, end, depth + 1)
        left_first[node] = right                        # store right child
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 1000))
    try:
        emit(0, n, 0)
    finally:
        sys.setrecursionlimit(old_limit)

    return _finalize_bvh(
        node_min[:num_nodes], node_max[:num_nodes], left_first[:num_nodes],
        count[:num_nodes], depth_arr[:num_nodes], axis_arr[:num_nodes],
        order, device=device,
    )


def sah_cost(bvh: BVH) -> float:
    """Total SAH cost of the tree (diagnostic; lower = better culling)."""
    ext = bvh.aabb_max - bvh.aabb_min
    area = 2.0 * (torch.roll(ext, 1, dims=-1) * ext).sum(dim=-1)
    w = torch.where(bvh.count > 0, bvh.count.to(torch.float32),
                    torch.ones_like(area))
    return float((area * w).sum() / area[0].clamp_min(1e-30))


def refit_bvh(bvh: BVH, tri_min: torch.Tensor,
              tri_max: torch.Tensor) -> BVH:
    """Recompute the node boxes for moved primitives, on the device of the
    BVH's tensors: each leaf's box from its slot window of MAX_LEAF_SIZE,
    then the internal nodes level by level from the deepest up, each a
    few gathers and a ``torch.minimum`` / ``maximum``.  Min and max are
    exact, so the boxes are the same on any device.

    ``tri_min`` / ``tri_max`` are per-SLOT primitive boxes (already in
    ``tri_order``).  The topology is unchanged; a new ``BVH`` is returned
    (``host=None``) and no tensor of the old one is written."""
    m, dev = bvh.num_nodes, bvh.aabb_min.device
    with span("bvh.leaves"):
        offs = torch.arange(MAX_LEAF_SIZE, dtype=torch.int32, device=dev)
        window = (bvh.left_first[:, None] + offs).clamp(0, bvh.num_tris - 1)
        valid = (offs < bvh.count[:, None])[..., None]        # (M, k, 1)
        inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
        w = window.long()
    with span("bvh.leaves"):
        leaf_min = torch.where(valid, tri_min[w], inf).amin(dim=1)
        leaf_max = torch.where(valid, tri_max[w], -inf).amax(dim=1)
        is_leaf = (bvh.count > 0)[:, None]
        amin = torch.where(is_leaf, leaf_min, inf)
        amax = torch.where(is_leaf, leaf_max, -inf)
    for li in reversed(bvh.levels):
        with span("bvh.level"):
            li = li.long()
            internal = (bvh.count[li] == 0)[:, None]
            lc = (li + 1).clamp_max(m - 1)
            rc = bvh.left_first[li].long().clamp(0, m - 1)
        with span("bvh.min"):
            amin[li] = torch.where(internal,
                                   torch.minimum(amin[lc], amin[rc]),
                                   amin[li])
        with span("bvh.max"):
            amax[li] = torch.where(internal,
                                   torch.maximum(amax[lc], amax[rc]),
                                   amax[li])
    return dataclasses.replace(bvh, aabb_min=amin, aabb_max=amax, host=None)
