"""Frontier caster — per-ray breadth-first traversal as dense tensor ops.

PyTorch counterpart of ``messyerraytracer_tpu/accel/frontier.py``, which
is plain ``jnp`` there (no Pallas kernel) and plain PyTorch here, on the
device of the rays:

  * the wide (8-ary) BVH is descended LEVEL BY LEVEL for all rays at once:
    the frontier is a flat list of (ray, node) pairs, each level one dense
    batch of 8-child slab tests;
  * leaf pairs intersect their (<= 4) triangles with the classic
    Moller-Trumbore of the brute oracle (``core/geometry.py``, the same
    float32 operations in the same order) and fold into per-ray bests
    with scatter-min — per-ray exact;
  * closest hit: strictly closer wins, the lowest slot wins an exact t
    tie, as a lexicographic (t, slot) scatter-min; any hit folds only the
    slot;
  * the per-ray best t caps the NEXT level's slab tests (level-lagged
    culling: the cap is min(best_t, t_max) as it stood when the level
    began).

Per-ray counters: ``nodes_visited`` counts the wide nodes a ray's pairs
opened, ``tri_tests`` the triangles of the leaves its slab tests hit.

The JAX package compacts each level into fixed-size lists (``pair_cap`` /
``leaf_cap``) and retries at double size on overflow, because ``jit``
needs static shapes.  Eager PyTorch compacts to the exact size
(``torch.nonzero``, one host sync per compaction), so nothing overflows
and nothing is retried; the cap factors are accepted and ignored.  A batch
larger than ``RAY_CHUNK`` rays is cast in chunks of that many rays, which
bounds the memory of the widest level and changes no per-ray result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import _bvh_host
from ..core.types import (
    ALL_LAYERS,
    DEFAULT_DEVICE,
    MT_DET_EPS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    Triangles,
    as_int32,
    safe_inv_direction,
)
from ..kernels.wide import _collapse8
from ..utils.trace import span

_BIG = 3.0e38
_IMAX = np.iinfo(np.int32).max
RAY_CHUNK = 1 << 20     # rays per pass of the level loop


@dataclasses.dataclass
class FrontierScene:
    """Wide-tree tables of the frontier caster, tensors on one device.

    Child slot i of wide node w lives at flat index 8*w + i.  Missing
    children carry NaN boxes (never hit).  ``child_enc`` is 2*ptr +
    is_leaf (ptr = wide-node or leaf index).  Leaves cover triangle slots
    [first, first + count) of the slot-ordered triangles, whose v0, edge1
    and edge2 components are ``tri`` (9 x (T,) f32).  The quantized tables
    (``quantize=True``) hold 8-bit child boxes from a per-node anchor at a
    power-of-two scale, xyz bytes packed x | y<<8 | z<<16 for min and max;
    a missing child there has enc 0 and an inverted box.  ``depth`` is the
    number of expansion levels."""

    child_min_x: torch.Tensor | None   # (8W,) f32; likewise _y, _z, max
    child_min_y: torch.Tensor | None
    child_min_z: torch.Tensor | None
    child_max_x: torch.Tensor | None
    child_max_y: torch.Tensor | None
    child_max_z: torch.Tensor | None
    child_enc: torch.Tensor            # (8W,) int32
    leaf_first: torch.Tensor           # (L,) int32
    leaf_count: torch.Tensor           # (L,) int32
    tri: tuple                         # 9 x (T,) f32: v0.xyz, e1.xyz, e2.xyz
    node_pmin: tuple | None = None     # 3 x (W,) f32 anchor
    node_psc: tuple | None = None      # 3 x (W,) f32 power-of-two scale
    child_qlo: torch.Tensor | None = None   # (8W,) int32
    child_qhi: torch.Tensor | None = None   # (8W,) int32
    depth: int = 1
    quantized: bool = False


def collapse_tables(amin, amax, lf, cnt):
    """Shared 8-wide collapse -> frontier tables: (child boxes (W,8,3) x 2
    NaN-padded, enc (W,8) int32, leaf binary-node index list, depth), the
    JAX package's host math.  One encoding for the frontier and the
    two-level TLAS builders."""
    m = amin.shape[0]
    is_leaf = cnt > 0
    leaves = np.nonzero(is_leaf)[0]
    leaf_of = (np.cumsum(is_leaf) - 1).astype(np.int32)
    children, _ = _collapse8(amin, amax, lf, cnt)
    children = np.asarray(children, np.int32)

    wide_of = np.full(m, -1, np.int32)
    order = children[children >= 0]
    internal_kids = order[~is_leaf[order]]
    wide_of[0] = 0
    wide_of[internal_kids] = np.arange(1, len(internal_kids) + 1,
                                       dtype=np.int32)

    present = children >= 0
    ck = np.where(present, children, 0)
    ptr = np.where(is_leaf[ck], leaf_of[ck], wide_of[ck])
    enc = np.where(present, 2 * ptr + is_leaf[ck], 0).astype(np.int32)
    cmin = np.where(present[..., None], amin[ck], np.nan).astype(np.float32)
    cmax = np.where(present[..., None], amax[ck], np.nan).astype(np.float32)

    depth = 0
    frontier = np.array([0], np.int32)
    while frontier.size:
        depth += 1
        kids = children[frontier].reshape(-1)
        kids = kids[kids >= 0]
        frontier = wide_of[kids[~is_leaf[kids]]]
    return cmin, cmax, enc, leaves, depth


def _quantize_wide_boxes(cmin, cmax, present):
    """Quantize (W,8,3) child AABBs to 8-bit offsets from a per-node
    anchor at a power-of-two scale (the CWBVH exponent-byte form), the
    JAX package's host math.

    Conservative by verification: after floor/ceil quantization the f32
    decode is checked against the true box and widened (or the node's
    scale doubled) until decoded_lo <= lo and decoded_hi >= hi hold
    exactly in f32 — traversal visits a superset, hits are unchanged.

    Returns (anchor (W,3) f32, scale (W,3) f32, qlo (W,8) i32 packed
    x|y<<8|z<<16, qhi (W,8) i32).  Missing children get qlo = 255s,
    qhi = 0 (an inverted box) and are culled by enc == 0 in the cast."""
    pm = present[..., None]
    anchor = np.where(pm, cmin, np.inf).min(axis=1)          # (W,3)
    top = np.where(pm, cmax, -np.inf).max(axis=1)
    anchor = np.where(np.isfinite(anchor), anchor, 0.0).astype(np.float32)
    top = np.where(np.isfinite(top), top, 0.0).astype(np.float32)
    extent = np.maximum(top - anchor, 0.0)
    e = np.ceil(np.log2(np.maximum(extent, 1e-30) / 255.0))
    scale = np.exp2(e).astype(np.float32)

    lo = np.where(pm, cmin, anchor[:, None, :]).astype(np.float32)
    hi = np.where(pm, cmax, anchor[:, None, :]).astype(np.float32)
    for _attempt in range(4):
        a3 = anchor[:, None, :]
        s3 = scale[:, None, :]
        qlo = np.clip(np.floor((lo - a3) / s3), 0, 255).astype(np.float32)
        qhi = np.clip(np.ceil((hi - a3) / s3), 0, 255).astype(np.float32)
        # widen one quantum where f32 decode rounding bites
        for _ in range(2):
            viol_lo = (a3 + qlo * s3).astype(np.float32) > lo
            viol_hi = (a3 + qhi * s3).astype(np.float32) < hi
            if not (viol_lo.any() or viol_hi.any()):
                break
            qlo = np.where(viol_lo & (qlo > 0), qlo - 1, qlo)
            qhi = np.where(viol_hi & (qhi < 255), qhi + 1, qhi)
        ok = ((a3 + qlo * s3).astype(np.float32) <= lo) & (
            (a3 + qhi * s3).astype(np.float32) >= hi
        )
        bad_nodes = ~ok.all(axis=(1, 2))
        if not bad_nodes.any():
            break
        scale = np.where(bad_nodes[:, None], scale * 2.0, scale)
    else:
        raise AssertionError("quantization not conservative after retries")

    qlo = qlo.astype(np.int32)
    qhi = qhi.astype(np.int32)
    qlo = np.where(present, qlo[..., 0] | (qlo[..., 1] << 8)
                   | (qlo[..., 2] << 16), 0x00FFFFFF)
    qhi = np.where(present, qhi[..., 0] | (qhi[..., 1] << 8)
                   | (qhi[..., 2] << 16), 0)
    return anchor, scale, qlo.astype(np.int32), qhi.astype(np.int32)


def _tri_components(tris: Triangles) -> tuple:
    return tuple(getattr(tris, f)[:, a].contiguous()
                 for f in ("v0", "edge1", "edge2") for a in range(3))


def build_frontier_scene(bvh, tris: Triangles,
                         quantize: bool = False) -> FrontierScene:
    """Frontier tables from a binary BVH and its slot-ordered triangles:
    the 8-wide collapse of ``kernels/wide.py`` on the host, the tables on
    the device of ``tris``."""
    amin, amax = _bvh_host(bvh, "aabb_min"), _bvh_host(bvh, "aabb_max")
    lf, cnt = _bvh_host(bvh, "left_first"), _bvh_host(bvh, "count")
    cmin, cmax, enc, leaves, depth = collapse_tables(amin, amax, lf, cnt)
    dev = tris.v0.device
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                    device=dev)
    common = dict(child_enc=put(enc.reshape(-1)),
                  leaf_first=put(lf[leaves].astype(np.int32)),
                  leaf_count=put(cnt[leaves].astype(np.int32)),
                  tri=_tri_components(tris), depth=depth)
    if quantize:
        present = ~np.isnan(cmin[..., 0])
        anchor, scale, qlo, qhi = _quantize_wide_boxes(cmin, cmax, present)
        return FrontierScene(
            child_min_x=None, child_min_y=None, child_min_z=None,
            child_max_x=None, child_max_y=None, child_max_z=None,
            node_pmin=tuple(put(anchor[:, a]) for a in range(3)),
            node_psc=tuple(put(scale[:, a]) for a in range(3)),
            child_qlo=put(qlo.reshape(-1)), child_qhi=put(qhi.reshape(-1)),
            quantized=True, **common)
    return FrontierScene(
        child_min_x=put(cmin[:, :, 0].reshape(-1)),
        child_min_y=put(cmin[:, :, 1].reshape(-1)),
        child_min_z=put(cmin[:, :, 2].reshape(-1)),
        child_max_x=put(cmax[:, :, 0].reshape(-1)),
        child_max_y=put(cmax[:, :, 1].reshape(-1)),
        child_max_z=put(cmax[:, :, 2].reshape(-1)),
        **common)


def _from_np(x, device):
    """numpy (or array-like) leaves of a JAX struct's fields as tensors;
    tuples stay tuples, None and Python scalars pass through."""
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, tuple):
        return tuple(_from_np(v, device) for v in x)
    return torch.tensor(np.asarray(x), device=device)


def frontier_scene_from_jax(*, device=DEFAULT_DEVICE,
                            **fields) -> FrontierScene:
    """The port's tables from the fields of a JAX ``FrontierScene`` (numpy
    arrays, tuples of them, ``depth`` and ``quantized``), so both packages
    can cast over the same tables."""
    return FrontierScene(**{k: _from_np(v, device)
                            for k, v in fields.items()})


def _compact(keep: torch.Tensor, values):
    """Stream compaction to the exact size: the entries of each of
    ``values`` where ``keep`` is true, in order (one host sync)."""
    idx = torch.nonzero(keep.reshape(-1))[:, 0]
    return [v.reshape(-1)[idx] for v in values]


def _compact_children(keep: torch.Tensor, pair, cptr: torch.Tensor):
    """The (pair, child pointer) of every child slot of a (P, 8) level
    where ``keep`` is true, row-major like ``_compact`` (one host
    sync); ``pair`` is the (P,) per-pair value carried along."""
    rows, cols = torch.nonzero(keep, as_tuple=True)
    return pair[rows], cptr[rows, cols].long()


def _slab_flat(bminx, bmaxx, bminy, bmaxy, bminz, bmaxz,
               ox, oy, oz, ix, iy, iz, cap_t):
    """Slab test, one float32 operation at a time in the JAX order:
    min/max per axis, hit iff far >= max(near, 0) and near <= cap_t.  NaN
    boxes fail both comparisons.  Broadcasts."""
    t1 = (bminx - ox) * ix
    t2 = (bmaxx - ox) * ix
    tn = torch.minimum(t1, t2)
    tf = torch.maximum(t1, t2)
    t1 = (bminy - oy) * iy
    t2 = (bmaxy - oy) * iy
    tn = torch.maximum(tn, torch.minimum(t1, t2))
    tf = torch.minimum(tf, torch.maximum(t1, t2))
    t1 = (bminz - oz) * iz
    t2 = (bmaxz - oz) * iz
    tn = torch.maximum(tn, torch.minimum(t1, t2))
    tf = torch.minimum(tf, torch.maximum(t1, t2))
    return (tf >= torch.clamp_min(tn, 0.0)) & (tn <= cap_t)


def _moller_trumbore(o, d, tri):
    """Classic Moller-Trumbore in components, the float32 operations of
    ``core/geometry.py::moller_trumbore`` in its order.  ``o``, ``d``: 3
    tensors each; ``tri``: the 9 (v0, e1, e2) component tensors.  Returns
    (inside: not parallel and inside the triangle, t, u, v); the caller
    adds the t range."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    parallel = det.abs() < MT_DET_EPS
    one = torch.ones_like(det)
    idet = one / torch.where(parallel, one, det)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * idet
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * idet
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * idet
    inside = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
              & (u + v <= 1.0))
    return inside, t, u, v


def _norm(v: torch.Tensor) -> torch.Tensor:
    """(N, 1) length of (N, 3) float32 rows, 1 where it is 0: the squared
    length summed as ((x² + y²) + z²), its square root taken in float64
    and rounded to float32 (correctly rounded on the card and the CPU
    alike, which PyTorch's float32 CPU sqrt is not)."""
    sq = v * v
    n2 = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
    nl = torch.sqrt(n2.double()).float()  # lint: off: correctly rounded sqrt
    return torch.where(nl > 0, nl, torch.ones_like(nl))[:, None]


def _leaf_slots(leaf, first, count, num_tris):
    """(L,) leaves -> (L*4,) triangle slots (clipped) and lane validity."""
    k4 = torch.arange(4, device=leaf.device, dtype=torch.int32)
    cnt = count[leaf]
    slot = (first[leaf][:, None] + k4).clamp(0, num_tris - 1).reshape(-1)
    kval = (k4 < cnt[:, None]).reshape(-1)
    return slot.long(), kval, cnt


class _Best:
    """Per-ray running best of one ray chunk: t, slot (and, for the
    two-level cast, instance), u, v and the counters."""

    def __init__(self, r, dev, with_inst=False):
        i32 = torch.int32
        self.t = torch.full((r,), _BIG, dtype=torch.float32, device=dev)
        self.slot = torch.full((r,), _IMAX, dtype=i32, device=dev)
        self.inst = (torch.full((r,), _IMAX, dtype=i32, device=dev)
                     if with_inst else None)
        self.u = torch.zeros((r,), dtype=torch.float32, device=dev)
        self.v = torch.zeros((r,), dtype=torch.float32, device=dev)
        self.nodes = torch.zeros((r,), dtype=i32, device=dev)
        self.tri_tests = torch.zeros((r,), dtype=i32, device=dev)

    def _set_uv(self, keep_uv, sel, ray, u, v):
        """Keep u, v where ``keep_uv``, zero elsewhere, then write the
        selected candidates' u, v (one per ray) at their rays."""
        zero = torch.zeros_like(self.u)
        self.u = torch.where(keep_uv, self.u, zero)
        self.v = torch.where(keep_uv, self.v, zero)
        tgt = ray[sel]
        self.u[tgt] = u[sel]
        self.v[tgt] = v[sel]

    def fold(self, ray, ft, fslot, u, v, any_hit):
        """Lexicographic (t, slot) scatter-min of candidates (``ft`` =
        _BIG and ``fslot`` = _IMAX where invalid); in any-hit mode only
        the slot is folded beside t."""
        imax = torch.full_like(fslot, _IMAX)
        new_t = self.t.scatter_reduce(0, ray, ft, "amin")
        cand = ft <= new_t[ray]                 # candidates tying the best
        keep_old = self.t <= new_t              # the previous best ties
        if any_hit:
            self.slot = self.slot.scatter_reduce(0, ray, fslot, "amin")
        else:
            pool = torch.where(keep_old, self.slot,
                               torch.full_like(self.slot, _IMAX))
            new_slot = pool.scatter_reduce(
                0, ray, torch.where(cand, fslot, imax), "amin")
            sel = cand & (fslot == new_slot[ray]) & (fslot != _IMAX)
            self._set_uv(keep_old & (new_slot == self.slot), sel, ray, u, v)
            self.slot = new_slot
        self.t = new_t

    def fold_inst(self, ray, ft, finst, fslot, u, v, any_hit):
        """Lexicographic (t, instance, slot) scatter-min; any-hit mode
        folds all three and leaves u, v at zero."""
        imax = torch.full_like(fslot, _IMAX)
        full = lambda x: torch.full_like(x, _IMAX)  # noqa: E731
        new_t = self.t.scatter_reduce(0, ray, ft, "amin")
        t_tie = ft <= new_t[ray]
        keep_t = self.t <= new_t
        pool = torch.where(keep_t, self.inst, full(self.inst))
        new_inst = pool.scatter_reduce(
            0, ray, torch.where(t_tie, finst, imax), "amin")
        i_tie = t_tie & (finst == new_inst[ray])
        keep_i = keep_t & (new_inst == self.inst)
        pool = torch.where(keep_i, self.slot, full(self.slot))
        new_slot = pool.scatter_reduce(
            0, ray, torch.where(i_tie, fslot, imax), "amin")
        if not any_hit:
            sel = i_tie & (fslot == new_slot[ray]) & (fslot != _IMAX)
            self._set_uv(keep_i & (new_slot == self.slot), sel, ray, u, v)
        self.t, self.inst, self.slot = new_t, new_inst, new_slot


def _child_boxes(fs: FrontierScene, pn: torch.Tensor):
    """The (P, 8) child boxes [lo x, hi x, lo y, hi y, lo z, hi z] of the
    wide nodes ``pn``, decoded from 8-bit offsets on a quantized scene
    (anchor + byte * scale)."""
    if fs.quantized:
        qlo = fs.child_qlo.view(-1, 8)[pn]
        qhi = fs.child_qhi.view(-1, 8)[pn]
        out = []
        for a in range(3):
            anc = fs.node_pmin[a][pn][:, None]
            sc = fs.node_psc[a][pn][:, None]
            out.append(anc + ((qlo >> (8 * a)) & 255).to(torch.float32) * sc)
            out.append(anc + ((qhi >> (8 * a)) & 255).to(torch.float32) * sc)
        return out
    return [getattr(fs, f"child_{m}_{a}").view(-1, 8)[pn]
            for a in "xyz" for m in ("min", "max")]


def _cast_chunk(o, d, inv, t_min, t_max, fs: FrontierScene, layers, qm,
                any_hit):
    """The level loop over one chunk of rays; returns its ``_Best``."""
    r = o.shape[0]
    best = _Best(r, o.device)
    num_tris = fs.tri[0].shape[0]
    enc8 = fs.child_enc.view(-1, 8)
    pr = torch.nonzero(t_max >= t_min)[:, 0]   # dead rays never start
    pn = torch.zeros_like(pr)
    while pr.numel():
        best.nodes.index_add_(0, pr, torch.ones_like(pr, dtype=torch.int32))
        ro, ri = o[pr], inv[pr]
        cap = torch.minimum(best.t, t_max)[pr][:, None]
        hit = _slab_flat(*_child_boxes(fs, pn),
                         ro[:, 0:1], ro[:, 1:2], ro[:, 2:3],
                         ri[:, 0:1], ri[:, 1:2], ri[:, 2:3], cap)
        del ro, ri, cap
        enc = enc8[pn]
        if fs.quantized:
            hit &= enc != 0
        isleaf = (enc & 1) == 1
        cptr = enc >> 1

        # ---- leaf pairs: up to 4 triangles each, Moller-Trumbore -------
        lr, lp = _compact_children(hit & isleaf, pr, cptr)
        slot, kval, cnt = _leaf_slots(lp, fs.leaf_first, fs.leaf_count,
                                      num_tris)
        best.tri_tests.index_add_(0, lr, cnt)
        ray4 = lr.repeat_interleave(4)
        inside, t, u, v = _moller_trumbore(
            o[ray4].unbind(1), d[ray4].unbind(1),
            [c[slot] for c in fs.tri])
        ok = (inside & (t >= t_min[ray4]) & (t <= t_max[ray4]) & kval)
        if qm != ALL_LAYERS:
            ok &= (layers[slot] & qm) != 0
        ft = torch.where(ok, t, torch.full_like(t, _BIG))
        fslot = torch.where(ok, slot.to(torch.int32),
                            torch.full_like(slot, _IMAX, dtype=torch.int32))
        best.fold(ray4, ft, fslot, u, v, any_hit)
        del inside, t, u, v, ok, ft, fslot, slot, kval, ray4

        # ---- internal pairs -> next frontier ---------------------------
        pr, pn = _compact_children(hit & ~isleaf, pr, cptr)
    return best


def _cast_frontier(rays: Rays, fs: FrontierScene, layers, query_mask: int,
                   any_hit: bool):
    """The frontier cast over all rays, in chunks of ``RAY_CHUNK``:
    (best t, best slot, u, v, nodes_visited, tri_tests) per ray."""
    o, d = rays.origin, rays.direction
    inv = safe_inv_direction(d)
    qm = as_int32(query_mask)
    parts = []
    for s in range(0, max(rays.count, 1), RAY_CHUNK):
        e = min(s + RAY_CHUNK, rays.count)
        b = _cast_chunk(o[s:e], d[s:e], inv[s:e], rays.t_min[s:e],
                        rays.t_max[s:e], fs, layers, qm, any_hit)
        parts.append((b.t, b.slot, b.u, b.v, b.nodes, b.tri_tests))
    return [torch.cat(x) for x in zip(*parts)]


def cast_rays_frontier(
    rays: Rays,
    fs: FrontierScene,
    tris: Triangles,
    query_mask: int = ALL_LAYERS,
    any_hit: bool = False,
    pair_cap_factor: int = 4,
    leaf_cap_factor: int = 4,
    return_per_ray_stats: bool = False,
):
    """Cast a batch through the frontier backend, on the rays' device.

    Returns (hits, stats, occluded[, per_ray_stats]); ``per_ray_stats``
    is {"tri_tests", "nodes_visited"}, (N,) int32 each.  The JAX
    package's cap factors are accepted and ignored (the lists are exact
    here).  The cast runs inside the profiler range ``cast``."""
    del pair_cap_factor, leaf_cap_factor
    with span("cast"):
        best_t, best_slot, best_u, best_v, nodes, tt = _cast_frontier(
            rays, fs, tris.layers, query_mask, any_hit)
        found = best_slot != _IMAX
        hits = _finalize_hits(rays, found, best_t, best_slot, best_u,
                              best_v, tris)
    dev = rays.origin.device
    stats = RayStats(
        rays_cast=torch.tensor(rays.count, dtype=torch.int64, device=dev),
        tri_tests=tt.sum(dtype=torch.int64),
        bvh_nodes_visited=nodes.sum(dtype=torch.int64),
        hits=found.sum(),
        stack_drops=torch.zeros((), dtype=torch.int64, device=dev),
    )
    if return_per_ray_stats:
        return hits, stats, found, {"tri_tests": tt, "nodes_visited": nodes}
    return hits, stats, found


def _finalize_hits(rays: Rays, found, best_t, best_slot, best_u, best_v,
                   tris: Triangles) -> Hits:
    """Winning slots -> hits: t, position o + d*t, prim id, normal and
    layers through the slot-ordered triangles."""
    g = torch.where(found, best_slot, torch.zeros_like(best_slot)).long()
    zero = torch.zeros_like(best_t)
    t0 = torch.where(found, best_t, zero)
    z3 = torch.zeros_like(rays.origin)
    return Hits(
        t=torch.where(found, best_t, torch.full_like(best_t, T_MAX_DEFAULT)),
        position=torch.where(found[:, None],
                             rays.origin + rays.direction * t0[:, None], z3),
        normal=torch.where(found[:, None], tris.normal[g], z3),
        u=torch.where(found, best_u, zero),
        v=torch.where(found, best_v, zero),
        prim_id=torch.where(found, tris.prim_id[g],
                            torch.full_like(tris.prim_id[g], NO_HIT)),
        hit_layers=torch.where(found, tris.layers[g],
                               torch.zeros_like(tris.layers[g])),
    )
