"""Cluster layout — host-side build of the tables the cluster cast reads.

PyTorch counterpart of the host half of
``messyerraytracer_tpu/kernels/cluster.py``.  The design is the same
two-level structure:

  * The binary SAH BVH is cut at maximal subtrees of <= T triangles
    ("clusters", T = 32 or 64 by scene density).  The upper tree over the
    clusters is collapsed 8-wide and traversed with a stack.
  * A cluster visit intersects the ray with its <= T triangles by the
    anchored Plucker form of Moller-Trumbore: per triangle 16 precomputed
    fields, with v0 taken relative to the cluster's anchor (its AABB
    center) so the operands stay O(cluster size) and t keeps ~1e-7
    relative accuracy.

    det   = e1.(d x e2)        = -d.n
    u_num = (o-v0).(d x e2)    = e2.m + d.(v0 x e2)
    v_num = d.((o-v0) x e1)    = -e1.m - d.(v0 x e1)
    t_num = (o-v0).n           = o.n - v0.n        (n = e1 x e2, m = o x d)

The JAX package stores all of this as 128-lane float slabs, with integers
as exact floats, because that is what a TPU DMA and vector unit want.  The
port keeps dense tables instead (``ClusterScene``): int32 child codes, an
explicit absent-child code, int32 prim ids and layer masks.  The numbers
in them are produced by the same numpy operations as the JAX package's
``_host_refresh``, so they are bit-identical to the converted JAX tables
(``cluster_scene_from_jax``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import _bvh_host
from ..core.geometry import _cross
# KSTACK stays a name of this module, as in the JAX package's cluster.py
from ..core.types import DEFAULT_DEVICE, KSTACK  # noqa: F401
from ..native import check_tables
from .wide import (
    ABSENT,
    NODE8_STRIDE,
    WIDE8_CAP,
    _child_boxes,
    _put,
    _upper_node_tables,
)

TCAP_DEFAULT = 64       # triangles per cluster
LOCAL_BITS = 13         # instanced leaf payload: gid = inst << 13 | local
LOCAL_MASK = (1 << LOCAL_BITS) - 1   # => <= 8192 clusters/mesh


def cluster_tcap_for(num_tris: int) -> int:
    """Density-routed cluster size of the JAX package: T=32 up to ~300K
    triangles, T=64 above (its routing, measured on a TPU; re-measuring
    it on the H100 is open work)."""
    return 32 if num_tris <= 300_000 else 64


# ---------------------------------------------------------------------------
# cluster cut over the binary DFS BVH
# ---------------------------------------------------------------------------

def _tree_levels(lf: np.ndarray, cnt: np.ndarray):
    """Per-depth node index lists for the DFS binary tree (children of
    internal preorder node i are i+1 and lf[i])."""
    is_leaf = cnt > 0
    levels = []
    frontier = np.array([0], np.int64)
    while frontier.size:
        levels.append(frontier)
        f_int = frontier[~is_leaf[frontier]]
        frontier = (np.concatenate([f_int + 1, lf[f_int]])
                    if f_int.size else np.empty(0, np.int64))
    return levels, is_leaf


def cluster_cut(lf: np.ndarray, cnt: np.ndarray, tcap: int):
    """Cut the tree at maximal subtrees holding <= tcap triangles.

    Returns (roots, first, count): cluster root node ids in DFS order and
    each cluster's contiguous triangle-slot range.
    """
    m = len(cnt)
    levels, is_leaf = _tree_levels(lf, cnt)
    sub_cnt = np.where(is_leaf, cnt, 0).astype(np.int64)
    sub_first = np.where(is_leaf, lf, 0).astype(np.int64)
    for lvl in reversed(levels):
        li = lvl[~is_leaf[lvl]]
        if li.size:
            sub_cnt[li] = sub_cnt[li + 1] + sub_cnt[lf[li]]
            sub_first[li] = sub_first[li + 1]
    par = np.full(m, -1, np.int64)
    internal = np.nonzero(~is_leaf)[0]
    par[internal + 1] = internal
    par[lf[internal]] = internal
    mark = sub_cnt <= tcap
    root_flag = mark.copy()
    root_flag[1:] &= ~mark[par[1:]]
    roots = np.nonzero(root_flag)[0]
    return (roots.astype(np.int64), sub_first[roots].astype(np.int64),
            sub_cnt[roots].astype(np.int64))


# ---------------------------------------------------------------------------
# the port's tables
# ---------------------------------------------------------------------------

def _refresh_table():
    # keyword-only, so subclasses may add fields without defaults
    return dataclasses.field(default=None, kw_only=True)


@dataclasses.dataclass
class ClusterScene:
    """Tables of the cluster cast, on one device.

    node_box    (NW, 8, 6) f32 — child k's box [min.xyz, max.xyz]; NaN for
                an absent child (never read: its code says absent)
    node_child  (NW, 8) i32 — 2*ptr + is_cluster; ptr = wide node index
                or cluster id (instanced: gid = inst << 13 | local);
                ABSENT (-1) for an empty slot
    node_axis   (NW,) i32 — the axis the children are sorted along
    tri         (C, T, 16) f32 — per triangle: -n, v0'xe2, e2, -(v0'xe1),
                -e1, -v0'.n (v0' relative to the cluster anchor); zero
                rows pad a cluster to T
    tri_prim    (C, T) i32 — prim id (0 on pad rows)
    tri_layers  (C, T) i32 — layer mask (0 on pad rows)
    cl_anchor   (C, 3) f32, cl_count (C,) i32, cl_aabb (C, 6) f32
    dummy_enc   2 * NW — the JAX package's never-hit dummy node code,
                kept as the scene's identity for conversions
    stack_need  build-time worst-case traversal stack depth

    The refresh after a refit (``refresh_cluster_scene``) reads four more
    tables, which tables converted from the JAX package lack (None):
    child_node (NW, 8) i32 — the binary BVH node each child slot holds,
                -1 if absent
    croots      (C,) i32 — each cluster's root node in the binary BVH
    slot_map    (C, T) i32 — the triangle slot of each row (0 on pad rows)
    cvalid      (C, T) bool — the row holds a triangle

    Construction checks the tables kernel B1 reads (``check_tables``).
    """

    node_box: torch.Tensor
    node_child: torch.Tensor
    node_axis: torch.Tensor
    tri: torch.Tensor
    tri_prim: torch.Tensor
    tri_layers: torch.Tensor
    cl_anchor: torch.Tensor
    cl_count: torch.Tensor
    cl_aabb: torch.Tensor
    tcap: int
    dummy_enc: int
    num_clusters: int
    stack_need: int
    child_node: torch.Tensor | None = _refresh_table()
    croots: torch.Tensor | None = _refresh_table()
    slot_map: torch.Tensor | None = _refresh_table()
    cvalid: torch.Tensor | None = _refresh_table()

    def __post_init__(self):
        # B1 reads node_box, node_child and tri in 16-byte words
        check_tables(type(self).__name__, self._kernel_tables(),
                     ("node_box", "node_child", "tri"))

    def _kernel_tables(self) -> list:
        """(name, tensor, dtype, shape) of each table the kernels read."""
        f32, i32 = torch.float32, torch.int32
        nw, c, t = self.node_child.shape[0], self.num_clusters, self.tcap
        return [("node_box", self.node_box, f32, (nw, 8, 6)),
                ("node_child", self.node_child, i32, (nw, 8)),
                ("node_axis", self.node_axis, i32, (nw,)),
                ("tri", self.tri, f32, (c, t, 16)),
                ("tri_prim", self.tri_prim, i32, (c, t)),
                ("tri_layers", self.tri_layers, i32, (c, t)),
                ("cl_anchor", self.cl_anchor, f32, (c, 3)),
                ("cl_count", self.cl_count, i32, (c,))]


def _cluster_tables_np(amin, amax, lf, cnt, _np, tcap: int, collapsed=None):
    """All tables of one cluster scene in numpy.

    ``_np`` = (v0, e1, e2, normal, prim_id, layers) in BVH slot order;
    ``collapsed`` as for ``_upper_node_tables``.
    Returns (tables, meta): numpy arrays keyed like ``ClusterScene``'s
    tensor fields, and its metadata."""
    pv0, pe1, pe2 = (np.asarray(a, np.float32) for a in _np[:3])
    pid = np.asarray(_np[4], np.int32)
    lay = np.asarray(_np[5], np.int32)
    t = int(pid.shape[0])
    if pid.max(initial=0) >= (1 << 24):
        # the JAX package stores prim ids as exact floats; the port keeps
        # its contract so the two stay interchangeable
        raise ValueError("prim ids >= 2^24 not exactly representable in "
                         "the cluster slab metadata lanes")
    m = amin.shape[0]
    roots, cfirst, ccnt = cluster_cut(lf, cnt, tcap)
    if ccnt.max(initial=0) > tcap:
        raise ValueError("cluster_cut produced an oversized cluster")
    c = len(roots)
    is_cluster = np.zeros(m, bool)
    is_cluster[roots] = True
    cluster_of = np.full(m, -1, np.int32)
    cluster_of[roots] = np.arange(c, dtype=np.int32)
    node_box, node_child, node_axis, nw, stack_need, kids = \
        _upper_node_tables(amin, amax, lf, cnt, is_cluster, cluster_of,
                           collapsed)

    # padded slot tables: slot = c*tcap + k (the JAX _host_refresh math)
    ks = np.arange(tcap, dtype=np.int64)[None, :]
    slots = np.clip(cfirst[:, None] + ks, 0, max(t - 1, 0))   # (C, T)
    valid = ks < ccnt[:, None]
    anchors = (0.5 * (amin[roots] + amax[roots])).astype(np.float32)
    vmask = valid.reshape(c, tcap, 1)
    v0 = np.where(vmask, pv0[slots], 0.0).astype(np.float32)
    e1 = np.where(vmask, pe1[slots], 0.0).astype(np.float32)
    e2 = np.where(vmask, pe2[slots], 0.0).astype(np.float32)
    v0c = v0 - anchors[:, None, :]
    n = np.cross(e1, e2)
    tri = np.concatenate(
        [-n, np.cross(v0c, e2), e2, -np.cross(v0c, e1), -e1,
         -np.sum(v0c * n, axis=-1, keepdims=True)], axis=-1,
    ).astype(np.float32)                                      # (C, T, 16)
    tables = {
        "child_node": kids,
        "croots": roots.astype(np.int32),
        "slot_map": np.where(valid, slots, 0).astype(np.int32),
        "cvalid": valid,
        "node_box": node_box,
        "node_child": node_child,
        "node_axis": node_axis,
        "tri": tri,
        "tri_prim": np.where(valid, pid[slots], 0).astype(np.int32),
        "tri_layers": np.where(valid, lay[slots], 0).astype(np.int32),
        "cl_anchor": anchors,
        "cl_count": valid.sum(axis=1).astype(np.int32),
        "cl_aabb": np.concatenate([amin[roots], amax[roots]],
                                  axis=1).astype(np.float32),
    }
    meta = {"tcap": tcap, "dummy_enc": 2 * nw, "num_clusters": c,
            "stack_need": stack_need}
    return tables, meta


def build_cluster_scene(bvh, tris, _np=None, tcap: int = TCAP_DEFAULT,
                        device=None, collapsed=None) -> ClusterScene:
    """Build the cluster tables from a binary BVH + slot-ordered triangles.

    Every table is arranged in numpy on the host (the JAX package's
    ``host_arrange`` path, at every size) and put on ``device`` (default:
    the device of ``tris``, else ``DEFAULT_DEVICE``).  ``_np`` optionally gives host
    copies (v0, e1, e2, normal, prim_id, layers) in slot order;
    ``collapsed`` keeps an earlier grouping of the upper tree
    (``_upper_node_tables``)."""
    if _np is None:
        _np = tuple(x.cpu().numpy() for x in (
            tris.v0, tris.edge1, tris.edge2, tris.normal, tris.prim_id,
            tris.layers))
    if device is None:
        device = tris.v0.device if tris is not None else DEFAULT_DEVICE
    tables, meta = _cluster_tables_np(
        *(_bvh_host(bvh, k) for k in ("aabb_min", "aabb_max", "left_first",
                                      "count")), _np, tcap, collapsed)
    return ClusterScene(**_put(tables, device), **meta)


def _anchored_fields(v0, e1, e2, anchors):
    """(C, T, 16) per-triangle fields of the anchored Plucker test from
    (C, T, 3) tensors and (C, 3) anchors: -n, v0'xe2, e2, -(v0'xe1), -e1,
    -v0'.n with v0' = v0 - anchor and n = e1 x e2.  Each float32 operation
    is one op, in the order of ``_cluster_tables_np``'s numpy, so the
    result is bit-equal to the build's on any device."""
    v0c = v0 - anchors[:, None, :]
    n = _cross(e1, e2)
    p = v0c * n
    # numpy's sum starts from +0: ((0 + x) + y) + z (a sum of -0s is +0)
    dot = ((0.0 + p[..., 0]) + p[..., 1]) + p[..., 2]
    return torch.cat([-n, _cross(v0c, e2), e2, -_cross(v0c, e1), -e1,
                      -dot[..., None]], dim=-1)


def refresh_cluster_scene(cs: ClusterScene, bvh, tris) -> ClusterScene:
    """The cluster tables after a refit, on their device: child boxes
    regathered from the refit ``bvh``, each cluster's anchor (its root
    box's center) and box, and the 16 anchored fields of its triangles
    from the re-derived slot-ordered ``tris``.  Prim ids, layers, counts,
    codes, axes and the stack bound keep (the topology is unchanged).
    Returns a new ``ClusterScene``; the old one's tensors are not
    written."""
    if cs.croots is None:
        raise ValueError("refresh_cluster_scene: these tables were "
                         "converted from the JAX package and carry no "
                         "refresh tables; build them with the port's "
                         "builders")
    roots = cs.croots.long()
    cmin, cmax = bvh.aabb_min[roots], bvh.aabb_max[roots]
    anchors = 0.5 * (cmin + cmax)
    slots = cs.slot_map.long()
    vm = cs.cvalid[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=slots.device)
    v0, e1, e2 = (torch.where(vm, x[slots], zero)
                  for x in (tris.v0, tris.edge1, tris.edge2))
    return dataclasses.replace(
        cs, node_box=_child_boxes(cs.child_node, bvh),
        tri=_anchored_fields(v0, e1, e2, anchors), cl_anchor=anchors,
        cl_aabb=torch.cat([cmin, cmax], dim=1))


# ---------------------------------------------------------------------------
# conversion from the JAX package's scene state
# ---------------------------------------------------------------------------

def _nodes_from_jax(nodes, dummy_enc: int) -> dict:
    """Dense node tables from JAX wide8 rows (2 nodes per 128 lanes)."""
    nw = int(dummy_enc) // 2
    rows = np.asarray(nodes, np.float32).reshape(-1, NODE8_STRIDE)[:nw]
    enc = rows[:, 48:48 + WIDE8_CAP]
    return {
        "node_box": np.ascontiguousarray(
            rows[:, :6 * WIDE8_CAP].reshape(nw, WIDE8_CAP, 6)),
        # absent children carry the dummy node's enc
        "node_child": np.where(enc == dummy_enc, ABSENT,
                               enc.astype(np.int32)).astype(np.int32),
        "node_axis": rows[:, 56].astype(np.int32),
    }


def _clusters_from_jax(slabs: np.ndarray, tcap: int) -> dict:
    """Dense cluster tables from JAX slabs ((C, T+8, 128) f32: lanes
    0-15 fields, 16 prim id, 17/18 layer mask halves; meta row T =
    anchor, count, AABB)."""
    lay = (slabs[:, :tcap, 17].astype(np.uint32)
           | (slabs[:, :tcap, 18].astype(np.uint32) << np.uint32(16)))
    meta = slabs[:, tcap]
    return {
        "tri": np.ascontiguousarray(slabs[:, :tcap, :16]),
        "tri_prim": slabs[:, :tcap, 16].astype(np.int32),
        "tri_layers": lay.view(np.int32),
        "cl_anchor": np.ascontiguousarray(meta[:, 0:3]),
        "cl_count": meta[:, 3].astype(np.int32),
        "cl_aabb": np.ascontiguousarray(meta[:, 4:10]),
    }


def cluster_scene_from_jax(nodes, ablocks, *, tcap: int, dummy_enc: int,
                           num_clusters: int, stack_need: int,
                           device=DEFAULT_DEVICE) -> ClusterScene:
    """The port's tables from the numpy arrays of a JAX ``ClusterScene``
    (its ``nodes`` and ``ablocks`` plus metadata), so both packages can
    cast over the same scene state."""
    slabs = np.asarray(ablocks, np.float32).reshape(-1, tcap + 8, 128)
    tables = {**_nodes_from_jax(nodes, dummy_enc),
              **_clusters_from_jax(slabs[:num_clusters], tcap)}
    return ClusterScene(**_put(tables, device), tcap=tcap,
                        dummy_enc=int(dummy_enc),
                        num_clusters=int(num_clusters),
                        stack_need=int(stack_need))


# ---------------------------------------------------------------------------
# the v1 cast entry point, on kernel B1
# ---------------------------------------------------------------------------

def cast_rays_cluster(rays, cs: ClusterScene, query_mask: int = -1,
                      any_hit: bool = False, interpret=None, srows=None,
                      qd=None, inner=None, gr=None, probe: str = "",
                      return_per_ray: bool = False):
    """The JAX package's v1 cluster cast, on kernel B1.

    The JAX v2 kernel is bit-identical to v1 by construction (its
    cluster_v2.py:18-22), so the port serves both with one kernel.
    Returns (hits, stats, occluded[, {"tri_tests"}]) as JAX v1 does.  The
    TPU schedule knobs (interpret, srows, qd, inner, gr) are accepted and
    ignored; ``probe`` timing modes raise."""
    # lazy: cluster_v2 imports this module, and the JAX package's module
    # layout keeps the v1 entry point here
    from .cluster_v2 import cast_rays_cluster_v2

    del interpret, srows, qd, inner, gr
    out = cast_rays_cluster_v2(rays, cs, query_mask, any_hit, probe=probe,
                               return_per_ray=return_per_ray)
    if return_per_ray:
        hits, stats, found, per_ray = out
        return hits, stats, found, {"tri_tests": per_ray["tri_tests"]}
    return out
