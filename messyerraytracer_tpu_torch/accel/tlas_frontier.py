"""Scalable two-level (TLAS/BLAS) cast on the frontier machinery.

PyTorch counterpart of ``messyerraytracer_tpu/accel/tlas_frontier.py``
(plain ``jnp`` there, plain PyTorch here, on the device of the rays):

  Phase A — a level-by-level descent (``accel/frontier.py``) of a wide
  TLAS built over the instances' world AABBs; each TLAS leaf expands to
  per-instance AABB tests, giving (ray, instance) pairs.

  Phase B — each pair moves its ray to object space (the direction NOT
  renormalized, so t stays world-parameterized) and descends the BLAS
  *forest*: every registered mesh's wide tree lives once in concatenated
  tables, so memory scales with meshes, not instances.  The per-ray best
  t caps every pair of the ray at the next level.

The winner is a lexicographic (t, instance, slot) scatter-min, so results
are deterministic; prim ids are in the flattened scene's numbering
(instance base + mesh-local id), comparable with the flat twin.  As in
``accel/frontier.py``, the pair lists are compacted to their exact size,
the JAX package's cap factors are accepted and ignored, and batches of
more than ``RAY_CHUNK`` rays are cast in chunks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import (
    ALL_LAYERS,
    DEFAULT_DEVICE,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    as_int32,
    safe_inv_direction,
)
from ..utils.trace import span
from .bvh import _bvh_host, build_bvh_over_aabbs
from .frontier import (
    _BIG,
    _IMAX,
    RAY_CHUNK,
    _Best,
    _compact,
    _compact_children,
    _from_np,
    _leaf_slots,
    _moller_trumbore,
    _norm,
    _slab_flat,
    collapse_tables,
)


@dataclasses.dataclass
class FrontierTLAS:
    """Two-level frontier tables, tensors on one device.

    TLAS: a wide tree over the instances; its leaf slots map to instance
    ids.  Forest: every mesh's wide tree concatenated (node, leaf and
    triangle indices global).  Instances carry the world -> object [R|t]
    rows, their BLAS root, layer mask and flat-scene prim-id base."""

    tlas_box: tuple               # 6 x (8Wt,) f32 (min xyz, max xyz)
    tlas_enc: torch.Tensor        # (8Wt,) int32
    tlas_leaf_inst: torch.Tensor  # (4Lt,) int32 instance id (-1 pad)
    inst_box: tuple               # 6 x (I,) f32 world AABBs
    inst_inv: tuple               # 12 x (I,) f32 world->object [R|t] rows
    inst_root: torch.Tensor       # (I,) int32 forest wide-node root
    inst_layers: torch.Tensor     # (I,) int32
    inst_prim_base: torch.Tensor  # (I,) int32 flat-scene prim id base
    forest_box: tuple             # 6 x (8Wf,) f32
    forest_enc: torch.Tensor      # (8Wf,) int32 (global ids)
    leaf_first: torch.Tensor      # (Lf,) int32 global tri slot
    leaf_count: torch.Tensor      # (Lf,) int32
    tri: tuple                    # 9 x (F,) f32 object-space v0/e1/e2
    tri_prim: torch.Tensor        # (F,) int32 mesh-local original prim id
    tri_layers: torch.Tensor      # (F,) int32
    tri_normal: torch.Tensor      # (F, 3) f32 object-space normals
    tlas_depth: int = 1
    blas_depth: int = 1


def build_frontier_tlas(tlas) -> FrontierTLAS:
    """Two-level tables of a ``SceneTLAS`` (host index math, the JAX
    package's), on the TLAS's device.  Forest memory scales with the
    registered meshes; instances add a handful of scalars each."""
    meshes, instances = tlas.meshes, tlas.instances
    if not instances:
        raise ValueError("build_frontier_tlas: no instances")

    # ---- BLAS forest ---------------------------------------------------
    fmin, fmax, fenc, ffirst, fcount = [], [], [], [], []
    roots, node_off, leaf_off, tri_off = [], 0, 0, 0
    tri_parts, mesh_tris = [], []
    blas_depth = 1
    for mesh in meshes:
        bvh = mesh.scene.bvh
        lf = _bvh_host(bvh, "left_first")
        cnt = _bvh_host(bvh, "count")
        cmin, cmax, enc, leaves, depth = collapse_tables(
            _bvh_host(bvh, "aabb_min"), _bvh_host(bvh, "aabb_max"), lf, cnt)
        blas_depth = max(blas_depth, depth)
        # globalize: internal ptr += node_off, leaf ptr += leaf_off
        is_leaf_enc = (enc & 1) == 1
        gptr = (enc >> 1) + np.where(is_leaf_enc, leaf_off, node_off)
        fenc.append((2 * gptr + is_leaf_enc).astype(np.int32).reshape(-1))
        fmin.append(cmin.reshape(-1, 3))
        fmax.append(cmax.reshape(-1, 3))
        ffirst.append((lf[leaves] + tri_off).astype(np.int32))
        fcount.append(cnt[leaves].astype(np.int32))
        roots.append(node_off)
        node_off += enc.shape[0]
        leaf_off += len(leaves)
        tri_parts.append(mesh.scene.tris)
        mesh_tris.append(mesh.num_tris)
        tri_off += mesh.num_tris

    dev = tlas.device
    tri = tuple(
        torch.cat([getattr(t, f)[:, a] for t in tri_parts]).to(dev)
        for f in ("v0", "edge1", "edge2") for a in range(3))

    # ---- instances ------------------------------------------------------
    n_inst = len(instances)
    inv = np.stack([i.inv_transform for i in instances])     # (I,3,4)
    ibox_min = np.zeros((n_inst, 3), np.float32)
    ibox_max = np.zeros((n_inst, 3), np.float32)
    prim_base = np.zeros(n_inst, np.int32)
    base = 0
    for i, inst in enumerate(instances):
        omn, omx = meshes[inst.blas_id].object_bounds()
        ibox_min[i], ibox_max[i] = inst.world_aabb(omn, omx)
        prim_base[i] = base
        base += mesh_tris[inst.blas_id]

    # ---- TLAS wide tree over instance AABBs -----------------------------
    cent = (ibox_min + ibox_max) * 0.5
    tbvh = build_bvh_over_aabbs(ibox_min, ibox_max, cent, device="cpu")
    tlf = _bvh_host(tbvh, "left_first")
    tcnt = _bvh_host(tbvh, "count")
    torder = _bvh_host(tbvh, "tri_order")    # instance permutation
    cmin, cmax, enc, leaves, tlas_depth = collapse_tables(
        _bvh_host(tbvh, "aabb_min"), _bvh_host(tbvh, "aabb_max"), tlf, tcnt)
    # leaf slots -> instance ids (4 per leaf, -1 pad)
    leaf_inst = np.full((len(leaves), 4), -1, np.int32)
    for k in range(4):
        slot = np.clip(tlf[leaves] + k, 0, n_inst - 1)
        leaf_inst[:, k] = np.where(k < tcnt[leaves], torder[slot], -1)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return FrontierTLAS(
        tlas_box=tuple(put(arr[:, :, a].reshape(-1))
                       for arr in (cmin, cmax) for a in range(3)),
        tlas_enc=put(enc.reshape(-1)),
        tlas_leaf_inst=put(leaf_inst.reshape(-1)),
        inst_box=tuple(put(arr[:, a]) for arr in (ibox_min, ibox_max)
                       for a in range(3)),
        inst_inv=tuple(put(inv[:, i, j]) for i in range(3) for j in range(4)),
        inst_root=put(np.asarray(roots, np.int32)[
            np.asarray([i.blas_id for i in instances], np.int32)]),
        inst_layers=put(np.asarray([i.layers for i in instances], np.int32)),
        inst_prim_base=put(prim_base),
        forest_box=tuple(put(np.concatenate(arrs)[:, a])
                         for arrs in (fmin, fmax) for a in range(3)),
        forest_enc=put(np.concatenate(fenc)),
        leaf_first=put(np.concatenate(ffirst)),
        leaf_count=put(np.concatenate(fcount)),
        tri=tri,
        tri_prim=torch.cat([t.prim_id for t in tri_parts]).to(dev),
        tri_layers=torch.cat([t.layers for t in tri_parts]).to(dev),
        tri_normal=torch.cat([t.normal for t in tri_parts]).to(dev),
        tlas_depth=tlas_depth,
        blas_depth=blas_depth,
    )


def frontier_tlas_from_jax(*, device=DEFAULT_DEVICE, **fields) -> FrontierTLAS:
    """The port's tables from the fields of a JAX ``FrontierTLAS`` (numpy
    arrays, tuples of them and the two depths)."""
    return FrontierTLAS(**{k: _from_np(v, device)
                           for k, v in fields.items()})


def _boxes8(box: tuple, pn: torch.Tensor):
    """(P, 8) child boxes [lo x, hi x, lo y, hi y, lo z, hi z] of the
    wide nodes ``pn`` from 6 flat (min xyz, max xyz) component tables."""
    return [box[k].view(-1, 8)[pn] for k in (0, 3, 1, 4, 2, 5)]


def _cols(x: torch.Tensor):
    """(P, 3) -> its three (P, 1) columns, for broadcasting over 8."""
    return x[:, 0:1], x[:, 1:2], x[:, 2:3]


def _tlas_pairs(o, inv, t_min, t_max, ft: FrontierTLAS, best: _Best, qm):
    """Phase A: the TLAS descent; returns the (ray, instance) pairs whose
    instance AABB the ray hits, in level order."""
    pr = torch.nonzero(t_max >= t_min)[:, 0]
    pn = torch.zeros_like(pr)
    enc8 = ft.tlas_enc.view(-1, 8)
    n_slots = ft.tlas_leaf_inst.shape[0]
    pair_ray, pair_inst = [], []
    while pr.numel():
        best.nodes.index_add_(0, pr, torch.ones_like(pr, dtype=torch.int32))
        cap = torch.minimum(best.t, t_max)[pr][:, None]
        hit = _slab_flat(*_boxes8(ft.tlas_box, pn), *_cols(o[pr]),
                         *_cols(inv[pr]), cap)
        enc = enc8[pn]
        isleaf = (enc & 1) == 1
        cptr = enc >> 1

        # leaf -> its 4 instance slots, culled by the instance world AABB
        lr, lp = _compact_children(hit & isleaf, pr, cptr)
        k4 = torch.arange(4, device=o.device)
        inst = ft.tlas_leaf_inst[(lp[:, None] * 4 + k4).clamp(
            0, n_slots - 1)].reshape(-1)
        ray4 = lr.repeat_interleave(4)
        gi = inst.clamp_min(0).long()
        cap4 = torch.minimum(best.t, t_max)[ray4]
        ihit = _slab_flat(*(ft.inst_box[k][gi] for k in (0, 3, 1, 4, 2, 5)),
                          *o[ray4].unbind(1), *inv[ray4].unbind(1), cap4)
        ihit &= inst >= 0
        if qm != ALL_LAYERS:
            ihit &= (ft.inst_layers[gi] & qm) != 0
        nr, ni = _compact(ihit, (ray4, gi))
        pair_ray.append(nr)
        pair_inst.append(ni)

        pr, pn = _compact_children(hit & ~isleaf, pr, cptr)
    return torch.cat(pair_ray), torch.cat(pair_inst)


def _cast_chunk(o, d, inv, t_min, t_max, ft: FrontierTLAS, qm, any_hit):
    """Both phases over one chunk of rays; returns its ``_Best``."""
    best = _Best(o.shape[0], o.device, with_inst=True)
    ir, ii = _tlas_pairs(o, inv, t_min, t_max, ft, best, qm)

    # ---- the ray in each instance's object space (no renormalize) -------
    iv = [c[ii] for c in ft.inst_inv]
    bo, bd = o[ir], d[ir]
    po = [iv[4 * a] * bo[:, 0] + iv[4 * a + 1] * bo[:, 1]
          + iv[4 * a + 2] * bo[:, 2] + iv[4 * a + 3] for a in range(3)]
    pd = [iv[4 * a] * bd[:, 0] + iv[4 * a + 1] * bd[:, 1]
          + iv[4 * a + 2] * bd[:, 2] for a in range(3)]
    del iv, bo, bd
    pobj_o = torch.stack(po, dim=1)
    pobj_d = torch.stack(pd, dim=1)
    pobj_i = safe_inv_direction(pobj_d)
    ii32 = ii.to(torch.int32)

    # ---- Phase B: the BLAS forest, pairs carried by pair index ----------
    num_tris = ft.tri[0].shape[0]
    enc8 = ft.forest_enc.view(-1, 8)
    pp = torch.arange(ir.numel(), device=o.device)     # pair of each entry
    pn = ft.inst_root[ii].long()
    while pp.numel():
        ray = ir[pp]
        best.nodes.index_add_(0, ray, torch.ones_like(ray, dtype=torch.int32))
        cap = torch.minimum(best.t, t_max)[ray][:, None]
        hit = _slab_flat(*_boxes8(ft.forest_box, pn), *_cols(pobj_o[pp]),
                         *_cols(pobj_i[pp]), cap)
        enc = enc8[pn]
        isleaf = (enc & 1) == 1
        cptr = enc >> 1

        # ---- leaf pairs: 4-triangle object-space Moller-Trumbore -------
        lq, lp = _compact_children(hit & isleaf, pp, cptr)
        slot, kval, cnt = _leaf_slots(lp, ft.leaf_first, ft.leaf_count,
                                      num_tris)
        ray_l = ir[lq]
        best.tri_tests.index_add_(0, ray_l, cnt)
        q4 = lq.repeat_interleave(4)
        ray4 = ray_l.repeat_interleave(4)
        inside, t, u, v = _moller_trumbore(
            pobj_o[q4].unbind(1), pobj_d[q4].unbind(1),
            [c[slot] for c in ft.tri])
        ok = inside & (t >= t_min[ray4]) & (t <= t_max[ray4]) & kval
        inst4 = ii32[q4]
        if qm != ALL_LAYERS:
            ok &= ((ft.tri_layers[slot] & ft.inst_layers[inst4.long()])
                   & qm) != 0
        imax = torch.full_like(inst4, _IMAX)
        best.fold_inst(ray4, torch.where(ok, t, torch.full_like(t, _BIG)),
                       torch.where(ok, inst4, imax),
                       torch.where(ok, slot.to(torch.int32), imax),
                       u, v, any_hit)
        del inside, t, u, v, ok, slot, kval, q4, ray4, inst4

        # ---- internal pairs -> next frontier ---------------------------
        pp, pn = _compact_children(hit & ~isleaf, pp, cptr)
    return best


def cast_rays_tlas(rays: Rays, ft: FrontierTLAS,
                   query_mask: int = ALL_LAYERS, any_hit: bool = False,
                   inst_cap_factor: int = 4, pair_cap_factor: int = 4,
                   leaf_cap_factor: int = 4):
    """Two-level cast, on the rays' device: returns (hits, stats, occluded,
    instance_id); prim ids in the flat scene's numbering, instance_id -1
    on a miss.  The JAX package's cap factors are accepted and
    ignored.  The cast runs inside the profiler range ``cast``."""
    del inst_cap_factor, pair_cap_factor, leaf_cap_factor
    with span("cast"):
        return _cast_tlas(rays, ft, query_mask, any_hit)


def _cast_tlas(rays: Rays, ft: FrontierTLAS, query_mask, any_hit):
    o, d = rays.origin, rays.direction
    inv = safe_inv_direction(d)
    qm = as_int32(query_mask)
    parts = []
    for s in range(0, max(rays.count, 1), RAY_CHUNK):
        e = min(s + RAY_CHUNK, rays.count)
        b = _cast_chunk(o[s:e], d[s:e], inv[s:e], rays.t_min[s:e],
                        rays.t_max[s:e], ft, qm, any_hit)
        parts.append((b.t, b.inst, b.slot, b.u, b.v, b.nodes, b.tri_tests))
    best_t, best_inst, best_slot, best_u, best_v, nodes, tt = (
        torch.cat(x) for x in zip(*parts))

    found = best_slot != _IMAX
    gslot = torch.where(found, best_slot, torch.zeros_like(best_slot)).long()
    gi = torch.where(found, best_inst, torch.zeros_like(best_inst)).long()
    # object normal -> world: n_w = n_o @ R^-1
    n_o = ft.tri_normal[gslot]
    ivr = [c[gi] for c in ft.inst_inv]
    nrm = torch.stack(
        [n_o[:, 0] * ivr[a] + n_o[:, 1] * ivr[4 + a] + n_o[:, 2] * ivr[8 + a]
         for a in range(3)], dim=1)
    nrm = nrm / _norm(nrm)

    zero = torch.zeros_like(best_t)
    z3 = torch.zeros_like(rays.origin)
    t0 = torch.where(found, best_t, zero)
    prim_flat = ft.inst_prim_base[gi] + ft.tri_prim[gslot]
    lay = ft.tri_layers[gslot] & ft.inst_layers[gi]
    hits = Hits(
        t=torch.where(found, best_t, torch.full_like(best_t, T_MAX_DEFAULT)),
        position=torch.where(found[:, None],
                             rays.origin + rays.direction * t0[:, None], z3),
        normal=torch.where(found[:, None], nrm, z3),
        u=torch.where(found, best_u, zero),
        v=torch.where(found, best_v, zero),
        prim_id=torch.where(found, prim_flat,
                            torch.full_like(prim_flat, NO_HIT)),
        hit_layers=torch.where(found, lay, torch.zeros_like(lay)),
    )
    dev = rays.origin.device
    stats = RayStats(
        rays_cast=torch.tensor(rays.count, dtype=torch.int64, device=dev),
        tri_tests=tt.sum(dtype=torch.int64),
        bvh_nodes_visited=nodes.sum(dtype=torch.int64),
        hits=found.sum(),
        stack_drops=torch.zeros((), dtype=torch.int64, device=dev),
    )
    inst_out = torch.where(found, best_inst, torch.full_like(best_inst, -1))
    return hits, stats, found, inst_out
