"""Instanced two-level (TLAS/BLAS) tables for the cluster cast.

PyTorch counterpart of ``messyerraytracer_tpu/kernels/cluster_tlas.py``
(its build half).  The memory contract is the reference's native TLAS:

  * Per (mesh, instance layer mask) group: object-space cluster tables,
    SHARED by every instance of the group, so memory ~ meshes.
  * One WORLD-SPACE upper tree over all (instance, cluster) pairs: each
    pair's box is the object cluster AABB pushed through the instance
    transform (8 corners), built with the binned-SAH builder over AABBs
    with singleton leaves; a leaf's payload is gid = inst << 13 | local
    cluster (<= 1024 instances x <= 8192 clusters per mesh).
  * The cast traverses in world space and moves the ray into object
    space at each cluster visit (no renormalization, so t stays in world
    units); the hit normal goes back through the inverse-transpose.

``set_transforms`` moves instances: the host redoes the float64 inverse of
the instances whose transform changed and uploads every instance's rows in
one copy; on a card one launch of ``csrc/tlas_refit.cu`` then pushes the
pair boxes through the new transforms, refits the pair tree and regathers
the node boxes (``refit_pairs_cuda``), on the CPU the plain PyTorch version
does the same (``_refit_pairs_plain``).  The object-space cluster tables
stay as they are.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools

import numpy as np
import torch

from ..accel.bvh import BVH, build_bvh, build_bvh_over_aabbs, refit_bvh
from ..core.types import ALL_LAYERS, DEFAULT_DEVICE
from ..native import CudaLibrary, check, cuda_device
from ..utils.trace import count, span
from .cluster import (
    LOCAL_BITS,
    LOCAL_MASK,
    TCAP_DEFAULT,
    ClusterScene,
    _clusters_from_jax,
    _cluster_tables_np,
    _nodes_from_jax,
)
from .wide import _child_boxes, _put, _upper_node_tables

MAX_INSTANCES = 1 << (23 - LOCAL_BITS)   # 1024
ROW = 33    # an instance's host row: forward [R | t] 12, iinv 12, ifwd 9


@dataclasses.dataclass
class ClusterTLAS(ClusterScene):
    """Tables of the instanced cluster cast: the ``ClusterScene`` fields
    (world-space upper tree; per-group object-space clusters
    concatenated) plus per-instance tables.

    inst_cbase (Ni,) i32 — first cluster of the instance's group
    iprim      (Ni,) i32 — global prim-id base (the flattened numbering)
    iinv       (Ni, 12) f32 — world->object rows [R^-1 | -R^-1 t]
    ifwd       (Ni, 9) f32 — normal matrix (R^-1)^T, row-major

    What ``set_transforms`` reads (None for tables converted from the JAX
    package, which have no pair tree):
    pair_bvh   BVH over the (instance, cluster) pairs' world boxes, on
               the tables' device; ``child_node`` maps child slots to its
               nodes
    pair_obj_min / pair_obj_max (P, 3) f32 — each pair's object-space
               cluster box;  pair_inst (P,) i32 — its instance
    pair_parent (M,) i32 — each pair-tree node's parent, -1 at the root
    pair_slot  (M,) i32 — the flat index into ``child_node`` of the slot
               that holds the node, -1 where none does
    pair_arrivals (M,) i32 — the refit kernel's arrival counters, all 0
               between launches (shared by the tables ``set_transforms``
               derives from these: launches on them run in stream order)
    inst_mat   (Ni, 12) float64 host array — the transforms [R | t] the
               rows below were computed from (what ``set_transforms``
               compares: two float64 transforms that round to the same
               float32 rows still have different inverses)
    inst_rows  (Ni, ROW) float32 host array — per instance the forward
               rows, ``iinv`` and ``ifwd``, as uploaded

    Construction also checks the refit kernel's tables.
    """

    inst_cbase: torch.Tensor
    iprim: torch.Tensor
    iinv: torch.Tensor
    ifwd: torch.Tensor
    n_inst: int
    num_pairs: int
    pair_bvh: BVH | None = None
    pair_obj_min: torch.Tensor | None = None
    pair_obj_max: torch.Tensor | None = None
    pair_inst: torch.Tensor | None = None
    pair_parent: torch.Tensor | None = None
    pair_slot: torch.Tensor | None = None
    pair_arrivals: torch.Tensor | None = None
    inst_mat: np.ndarray | None = None
    inst_rows: np.ndarray | None = None

    def _kernel_tables(self) -> list:
        f32, i32 = torch.float32, torch.int32
        ni, bvh = self.n_inst, self.pair_bvh
        out = super()._kernel_tables() + [
            ("inst_cbase", self.inst_cbase, i32, (ni,)),
            ("iprim", self.iprim, i32, (ni,)),
            ("iinv", self.iinv, f32, (ni, 12)),
            ("ifwd", self.ifwd, f32, (ni, 9))]
        if bvh is None:
            return out
        p, m = bvh.num_tris, bvh.num_nodes
        return out + [
            ("pair_obj_min", self.pair_obj_min, f32, (p, 3)),
            ("pair_obj_max", self.pair_obj_max, f32, (p, 3)),
            ("pair_inst", self.pair_inst, i32, (p,)),
            ("pair_bvh.tri_order", bvh.tri_order, i32, (p,)),
            ("pair_bvh.left_first", bvh.left_first, i32, (m,)),
            ("pair_bvh.count", bvh.count, i32, (m,)),
            ("pair_parent", self.pair_parent, i32, (m,)),
            ("pair_slot", self.pair_slot, i32, (m,)),
            ("child_node", self.child_node, i32,
             (self.node_child.shape[0], 8)),
            ("pair_arrivals", self.pair_arrivals, i32, (m,))]

    @property
    def pair_bounds(self) -> tuple | None:
        """(lo, hi) world AABB of the pair tree's root, on the tables'
        device (None without a pair tree)."""
        if self.pair_bvh is None:
            return None
        return self.pair_bvh.aabb_min[0], self.pair_bvh.aabb_max[0]


def _to_mat34(t) -> np.ndarray:
    """Accept a (3,4), (4,4), or (3,3)+implicit-0 transform -> (3,4), or a
    stack of one of them -> (..., 3, 4)."""
    t = np.asarray(t, np.float64)  # lint: off: host-side inverse precision
    if t.shape[-2:] == (4, 4):
        return t[..., :3, :]
    if t.shape[-2:] == (3, 4):
        return t
    if t.shape[-2:] == (3, 3):
        return np.concatenate([t, np.zeros(t.shape[:-1] + (1,))], axis=-1)
    raise ValueError(f"transform shape {t.shape} unsupported")


def _mat34s(transforms: list) -> np.ndarray:
    """(Ni, 12) float64 [R | t] rows of the transforms, each as
    ``_to_mat34`` reads it; one stacking call when they share a shape."""
    shapes = {getattr(t, "shape", None) for t in transforms}
    if len(shapes) == 1 and None not in shapes:     # arrays of one shape
        # float64, as _to_mat34 reads each: the host inverse's precision
        mats = _to_mat34(np.asarray(transforms, np.float64))  # lint: off
    else:
        mats = np.stack([_to_mat34(t) for t in transforms])
    return np.ascontiguousarray(mats.reshape(len(transforms), 12))


def _inst_tables(transforms: list):
    """(iinv (Ni, 16), ifwd (Ni, 9)) f32 as the JAX package lays them out
    (iinv lanes 12-15 unused)."""
    ni = len(transforms)
    iinv = np.zeros((ni, 16), np.float32)
    ifwd = np.zeros((ni, 9), np.float32)
    for i, t in enumerate(transforms):
        m = _to_mat34(t)
        r = m[:, :3]
        rinv = np.linalg.inv(r)
        tinv = -rinv @ m[:, 3]
        iinv[i, :12] = np.concatenate(
            [rinv[0], [tinv[0]], rinv[1], [tinv[1]], rinv[2], [tinv[2]]]
        ).astype(np.float32)
        # normals transform by the inverse-transpose basis
        ifwd[i] = rinv.T.reshape(-1).astype(np.float32)
    return iinv, ifwd


def _pair_world_aabbs_np(obj_min, obj_max, fwd_rows):
    """8-corner transform of object AABBs -> world AABBs (numpy, the JAX
    package's build-path twin; same f32 operations)."""
    obj_min = np.asarray(obj_min, np.float32)
    obj_max = np.asarray(obj_max, np.float32)
    m = np.asarray(fwd_rows, np.float32)
    wmin = np.full_like(obj_min, np.inf)
    wmax = np.full_like(obj_min, -np.inf)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                c = np.stack(
                    [obj_max[:, 0] if cx else obj_min[:, 0],
                     obj_max[:, 1] if cy else obj_min[:, 1],
                     obj_max[:, 2] if cz else obj_min[:, 2]], axis=-1)
                w = np.stack(
                    [m[:, 0] * c[:, 0] + m[:, 1] * c[:, 1]
                     + m[:, 2] * c[:, 2] + m[:, 3],
                     m[:, 4] * c[:, 0] + m[:, 5] * c[:, 1]
                     + m[:, 6] * c[:, 2] + m[:, 7],
                     m[:, 8] * c[:, 0] + m[:, 9] * c[:, 1]
                     + m[:, 10] * c[:, 2] + m[:, 11]], axis=-1)
                wmin = np.minimum(wmin, w)
                wmax = np.maximum(wmax, w)
    return wmin.astype(np.float32), wmax.astype(np.float32)


def _pair_world_aabbs(obj_min, obj_max, m):
    """``_pair_world_aabbs_np`` in torch, on the device of its (P, 3)
    boxes and (P, 12) forward rows: the same float32 operations in the
    same order, so the same bounds."""
    with span("refit.rows"):
        wmin = torch.full_like(obj_min, float("inf"))
        wmax = torch.full_like(obj_min, -float("inf"))
        lo, hi, col = obj_min.unbind(1), obj_max.unbind(1), m.unbind(1)
    for cx, cy, cz in itertools.product((0, 1), repeat=3):
        with span("refit.corner"):
            c = (hi[0] if cx else lo[0], hi[1] if cy else lo[1],
                 hi[2] if cz else lo[2])
            w = torch.stack(
                [col[4 * r] * c[0] + col[4 * r + 1] * c[1]
                 + col[4 * r + 2] * c[2] + col[4 * r + 3]
                 for r in range(3)], dim=-1)
            wmin = torch.minimum(wmin, w)
            wmax = torch.maximum(wmax, w)
    return wmin, wmax


def _fwd_rows(transforms: list) -> np.ndarray:
    """(Ni, 12) float32 forward [R | t] rows of the instance transforms."""
    return _mat34s(transforms).astype(np.float32)


def _inst_rows(transforms: list, mat: np.ndarray) -> np.ndarray:
    """(Ni, ROW) float32 host rows [forward | iinv | ifwd] of the
    transforms, whose ``_mat34s`` is ``mat``: ``_fwd_rows`` and
    ``_inst_tables``, side by side."""
    iinv, ifwd = _inst_tables(transforms)
    return np.concatenate([mat.astype(np.float32), iinv[:, :12], ifwd],
                          axis=1)


def _update_rows(ct: "ClusterTLAS", transforms: list) -> tuple:
    """(inst_mat, inst_rows) of ``transforms``: ``ct``'s rows, redone by
    ``_inst_rows`` only where a transform's float64 bits changed, so the
    table equals a full recompute bit for bit.  ``ct``'s arrays are not
    written."""
    mat = _mat34s(transforms)
    changed = np.flatnonzero(
        (mat.view(np.uint64) != ct.inst_mat.view(np.uint64)).any(axis=1))
    rows = ct.inst_rows.copy()
    if changed.size:
        rows[changed] = _inst_rows([transforms[i] for i in changed],
                                   mat[changed])
    count("refit.inverse_rows", changed.size)
    return mat, rows


def _pair_refit_tables(lf, cnt, kids) -> tuple:
    """(parent (M,), slot (M,)) int32 of a pair tree in DFS order (left
    child ``node + 1``, right ``lf[node]`` of an internal node) and its
    (W, 8) child-slot table ``kids``: each node's parent (-1 at the root)
    and the flat index of the slot that holds it (-1 where none does).
    Raises if a node sits in two slots: the refit kernel writes one."""
    m = len(cnt)
    inner = np.flatnonzero(cnt == 0)
    parent = np.full(m, -1, np.int32)
    parent[inner + 1] = inner
    parent[lf[inner]] = inner
    flat = kids.reshape(-1)
    present = np.flatnonzero(flat >= 0)
    if present.size and np.bincount(flat[present], minlength=m).max() > 1:
        raise ValueError("a pair-tree node sits in two child slots")
    slot = np.full(m, -1, np.int32)
    slot[flat[present]] = present
    return parent, slot


def build_cluster_tlas(mesh_tris: list, instances: list,
                       tcap: int = TCAP_DEFAULT,
                       mesh_layers: list | None = None,
                       inst_layers: list | None = None,
                       device=DEFAULT_DEVICE) -> ClusterTLAS:
    """Build the instanced tables.

    mesh_tris: list of (T, 3, 3) float vertex arrays (object space).
    instances: list of (mesh_id, transform) with transform (3,4)/(4,4).
    mesh_layers: optional per-mesh (T,) int32 per-triangle layer masks
    (original triangle order); inst_layers: optional per-instance masks.
    A triangle's effective layers = tri_layers & instance_layers; each
    distinct (mesh, instance mask) pair gets its own cluster group.
    """
    ni = len(instances)
    if ni == 0 or ni > MAX_INSTANCES:
        raise ValueError(f"instances must be 1..{MAX_INSTANCES}")
    mesh_ids = [int(m) for m, _ in instances]
    transforms = [t for _, t in instances]
    if inst_layers is None:
        inst_layers = [ALL_LAYERS] * ni
    inst_layers = [int(m) for m in inst_layers]

    group_of = {}
    group_inst = []            # group index per instance
    for key in zip(mesh_ids, inst_layers):
        group_inst.append(group_of.setdefault(key, len(group_of)))

    groups = []                # per-group numpy tables
    cbases = []
    total_c = 0
    for mesh_id, g_ilayers in group_of:
        tri = np.asarray(mesh_tris[mesh_id], np.float32)
        v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
        host = build_bvh(v0, v1, v2, device=device).host
        perm = host["tri_order"]
        pv0, pv1, pv2 = v0[perm], v1[perm], v2[perm]
        e1, e2 = pv1 - pv0, pv2 - pv0
        if mesh_layers is None or mesh_layers[mesh_id] is None:
            tl = np.full(len(v0), ALL_LAYERS, np.int32)
        else:
            tl = np.asarray(mesh_layers[mesh_id], np.int32)
        eff_layers = (tl & np.int32(g_ilayers))[perm]
        tables, meta = _cluster_tables_np(
            host["aabb_min"], host["aabb_max"], host["left_first"],
            host["count"],
            (pv0, e1, e2, None,
             np.arange(len(v0), dtype=np.int32)[perm], eff_layers),
            tcap)
        if meta["num_clusters"] > LOCAL_MASK + 1:
            raise ValueError(
                f"mesh has {meta['num_clusters']} clusters > "
                f"{LOCAL_MASK + 1}; use the flat path for huge meshes")
        groups.append(tables)
        cbases.append(total_c)
        total_c += meta["num_clusters"]

    inst_mat = _mat34s(transforms)
    inst_rows = _inst_rows(transforms, inst_mat)
    count("refit.inverse_rows", ni)
    fwd_rows = inst_rows[:, :12]
    # flattened-scene global prim-id base per instance
    iprim = np.cumsum([0] + [len(mesh_tris[m]) for m in mesh_ids[:-1]]
                      ).astype(np.int32)

    # ---- (instance, cluster) pairs + world AABBs ----------------------
    pobj, pinst, pgid = [], [], []
    for i, g in enumerate(group_inst):
        ca = groups[g]["cl_aabb"]
        pobj.append(ca)
        pinst.append(np.full(len(ca), i, np.int32))
        pgid.append((i << LOCAL_BITS) + np.arange(len(ca), dtype=np.int32))
    pobj = np.concatenate(pobj)
    pinst = np.concatenate(pinst)
    pgid = np.concatenate(pgid)

    wmin, wmax = _pair_world_aabbs_np(pobj[:, 0:3], pobj[:, 3:6],
                                      fwd_rows[pinst])
    pair_bvh = build_bvh_over_aabbs(wmin, wmax, (wmin + wmax) * 0.5,
                                    max_leaf_size=1, device=device)
    host = pair_bvh.host
    lf, cnt = host["left_first"], host["count"]
    is_leaf = cnt > 0
    gid_of_node = np.zeros(len(cnt), np.int32)
    gid_of_node[is_leaf] = pgid[host["tri_order"][lf[is_leaf]]]
    node_box, node_child, node_axis, nw, stack_need, kids = \
        _upper_node_tables(host["aabb_min"], host["aabb_max"], lf, cnt,
                           is_leaf, gid_of_node)
    parent, slot = _pair_refit_tables(lf, cnt, kids)

    tables = {k: np.concatenate([g[k] for g in groups])
              for k in ("tri", "tri_prim", "tri_layers", "cl_anchor",
                        "cl_count", "cl_aabb")}
    tables.update(
        node_box=node_box, node_child=node_child, node_axis=node_axis,
        inst_cbase=np.asarray([cbases[g] for g in group_inst], np.int32),
        iprim=iprim, iinv=inst_rows[:, 12:24], ifwd=inst_rows[:, 24:],
        child_node=kids, pair_obj_min=pobj[:, 0:3],
        pair_obj_max=pobj[:, 3:6], pair_inst=pinst, pair_parent=parent,
        pair_slot=slot, pair_arrivals=np.zeros(len(cnt), np.int32))
    return ClusterTLAS(**_put(tables, device), tcap=tcap,
                       dummy_enc=2 * nw, num_clusters=total_c,
                       stack_need=stack_need, n_inst=ni,
                       num_pairs=len(pgid), pair_bvh=pair_bvh,
                       inst_mat=inst_mat, inst_rows=inst_rows)


def set_transforms(ct: ClusterTLAS, transforms: list) -> ClusterTLAS:
    """Move the instances to ``transforms`` (one per instance, (3,4) /
    (4,4) / (3,3)), on the device of the tables.  On the host, the
    inverse and normal matrices of each instance whose transform changed
    are recomputed (float64 inverse, as at build; the counter
    ``refit.inverse_rows`` counts them) and every instance's rows go to the
    device in one copy.  There each pair's object box goes through its
    instance's new forward rows (8 corners), the pair BVH is refit and the
    node boxes regathered, so ``pair_bounds`` follows too: one launch of
    the refit kernel on CUDA tables (``refit_pairs_cuda``), the plain
    PyTorch version on CPU tables.  The object-space cluster tables stay
    as they are.  Returns a new ``ClusterTLAS``; the old one's tables are
    not written."""
    if ct.pair_bvh is None:
        raise ValueError("set_transforms: these tables were converted from "
                         "the JAX package and carry no pair tree; build "
                         "them with build_cluster_tlas")
    if len(transforms) != ct.n_inst:
        raise ValueError(f"set_transforms: {len(transforms)} transforms "
                         f"for {ct.n_inst} instances")
    dev = ct.node_box.device
    if dev.type == "cuda":
        refit = refit_pairs_cuda
    elif dev.type == "cpu":
        refit = _refit_pairs_plain
    else:
        raise ValueError(f"set_transforms: no refit for device {dev}")
    with span("refit.set_transforms"):
        with span("refit.inverse"):
            mat, rows = _update_rows(ct, transforms)
        bvh, node_box, iinv, ifwd = refit(
            ct, torch.as_tensor(rows, device=dev))
        return dataclasses.replace(
            ct, node_box=node_box, pair_bvh=bvh, iinv=iinv, ifwd=ifwd,
            inst_mat=mat, inst_rows=rows)


def _refit_pairs_plain(ct: ClusterTLAS, rows: torch.Tensor) -> tuple:
    """The plain PyTorch version of the refit kernel, on the device of
    the tables: from the (Ni, ROW) instance rows, (pair BVH, node_box,
    iinv, ifwd) of the moved instances (each pair's box through its
    instance's forward rows, ``refit_bvh``, the child-slot regather)."""
    with span("refit.rows"):
        fwd = rows[:, :12][ct.pair_inst.long()]
    wmin, wmax = _pair_world_aabbs(ct.pair_obj_min, ct.pair_obj_max, fwd)
    with span("refit.slots"):
        perm = ct.pair_bvh.tri_order.long()  # refit takes per-slot boxes
        wmin, wmax = wmin[perm], wmax[perm]
    bvh = refit_bvh(ct.pair_bvh, wmin, wmax)
    with span("refit.nodes"):
        return (bvh, _child_boxes(ct.child_node, bvh),
                rows[:, 12:24].contiguous(), rows[:, 24:].contiguous())


# ---------------------------------------------------------------------------
# the refit kernel (csrc/tlas_refit.cu): build, bind, launch
# ---------------------------------------------------------------------------

_p, _i = ctypes.c_void_p, ctypes.c_int
cuda_library = CudaLibrary("tlas_refit.cu", "libmrt_tlas_refit.so", {
    "mrt_tlas_refit": (
        [_p, _i, _p, _p, _p, _p]        # rows, Ni, pairs
        + [_p, _p, _p, _p, _i]          # tree, M
        + [_p, _i, _p]                  # child slots, W*8, arrivals
        + [_p, _p, _p, _p, _p, _p])})   # outputs, stream


def _refit_kernel_args(ct: ClusterTLAS, rows: torch.Tensor) -> tuple:
    """Check the refit kernel's per-call input, the (Ni, ROW) ``rows`` on
    the tables' device (``ClusterTLAS`` checked its tables), and allocate
    its outputs: (the C entry's arguments up to the stream, (aabb_min,
    aabb_max, node_box, iinv, ifwd))."""
    dev = cuda_device(rows.device, "refit_pairs_cuda")
    bvh = ct.pair_bvh
    ni, m, nw = ct.n_inst, bvh.num_nodes, ct.child_node.shape[0]
    f32 = torch.float32
    check(rows, "rows", f32, (ni, ROW), ct.node_box.device)
    outs = (torch.empty((m, 3), dtype=f32, device=dev),
            torch.empty((m, 3), dtype=f32, device=dev),
            torch.empty((nw, 8, 6), dtype=f32, device=dev),
            torch.empty((ni, 12), dtype=f32, device=dev),
            torch.empty((ni, 9), dtype=f32, device=dev))
    args = [rows.data_ptr(), ni, ct.pair_obj_min.data_ptr(),
            ct.pair_obj_max.data_ptr(), ct.pair_inst.data_ptr(),
            bvh.tri_order.data_ptr(), bvh.left_first.data_ptr(),
            bvh.count.data_ptr(), ct.pair_parent.data_ptr(),
            ct.pair_slot.data_ptr(), m, ct.child_node.data_ptr(), nw * 8,
            ct.pair_arrivals.data_ptr(), *(t.data_ptr() for t in outs)]
    return args, outs


def refit_pairs_cuda(ct: ClusterTLAS, rows: torch.Tensor) -> tuple:
    """``_refit_pairs_plain`` as one launch of the refit kernel, on CUDA
    tables: the same (pair BVH, node_box, iinv, ifwd), bit for bit, in
    new tensors.  Launches on the current stream without synchronizing;
    raises if the launch is refused.  The arrival counters it uses come
    back to 0 at the launch's end."""
    args, (amin, amax, node_box, iinv, ifwd) = _refit_kernel_args(ct, rows)
    cuda_library.launch("mrt_tlas_refit", args, rows.device, "refit.kernel")
    return (dataclasses.replace(ct.pair_bvh, aabb_min=amin, aabb_max=amax,
                                host=None), node_box, iinv, ifwd)


def cluster_tlas_from_jax(nodes, ablocks, islab, iprim, iinv, ifwd, *,
                          tcap: int, dummy_enc: int, stack_need: int,
                          num_pairs: int = 0,
                          device=DEFAULT_DEVICE) -> ClusterTLAS:
    """The port's instanced tables from the numpy arrays of a JAX
    ``ClusterTLAS``.  Its slabs hold one trailing all-zero dummy cluster
    per group; a real cluster always holds >= 1 triangle, so the dummies
    are the slabs whose count lane is 0, and they are dropped."""
    br = tcap + 8
    slabs = np.asarray(ablocks, np.float32).reshape(-1, br, 128)
    real = slabs[:, tcap, 3] > 0
    port_index = np.cumsum(real) - real           # slab -> port cluster
    islab = np.asarray(islab, np.int64).reshape(-1)
    tables = {**_nodes_from_jax(nodes, dummy_enc),
              **_clusters_from_jax(slabs[real], tcap)}
    tables.update(
        inst_cbase=port_index[islab // br].astype(np.int32),
        iprim=np.asarray(iprim, np.int32).reshape(-1),
        iinv=np.asarray(iinv, np.float32)[:, :12],
        ifwd=np.asarray(ifwd, np.float32))
    return ClusterTLAS(**_put(tables, device), tcap=tcap,
                       dummy_enc=int(dummy_enc),
                       num_clusters=int(real.sum()),
                       stack_need=int(stack_need), n_inst=len(islab),
                       num_pairs=int(num_pairs))


def cast_rays_cluster_tlas(rays, ct: ClusterTLAS, query_mask: int = -1,
                           any_hit: bool = False, interpret=None,
                           srows=None, qd=None):
    """The JAX package's v1 instanced cast, on kernel B1 (see
    ``cluster.cast_rays_cluster``).  Returns (hits, stats, occluded,
    instance_id); the TPU knobs (interpret, srows, qd) are accepted and
    ignored."""
    # lazy: cluster_v2 imports this module, and the JAX package's module
    # layout keeps the v1 entry point here
    from .cluster_v2 import cast_rays_cluster_tlas_v2

    del interpret, srows, qd
    return cast_rays_cluster_tlas_v2(rays, ct, query_mask, any_hit)
