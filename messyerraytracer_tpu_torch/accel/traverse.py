"""Per-ray binary-BVH stack traversal in plain PyTorch — the ``jnp``
backend.

PyTorch counterpart of ``messyerraytracer_tpu/accel/traverse.py``, the
semantic traversal that defines exact per-ray stats.  The JAX package
computes it outside any Pallas kernel, so the port keeps it as tensor code
that runs on whatever device the tensors are on.  The same rules:

  * stack-based DFS, depth cap 64; a push past it is dropped, as in JAX,
    and counted in ``stack_drops`` (JAX drops it silently);
  * the root's box gates the walk (a ray that misses it pops nothing);
  * internal node: slab-test both children (left = node+1, right =
    ``left_first``) against the current best t, push far then near so the
    near child (smaller entry t, left on ties) pops first;
  * leaf: Moller-Trumbore on its <= 4 triangles against
    t_max = min(t_max, best), layer-mask filtered; strictly-closer update,
    the lowest slot wins a tie inside a leaf;
  * stats: nodes_visited counts every popped node, tri_tests the leaf
    triangles tested (masked ones included).

The batch is walked as a whole: each step pops one node for every ray
still alive.
"""

from __future__ import annotations

import torch

from ..core.geometry import moller_trumbore
from ..core.types import (
    ALL_LAYERS,
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
    Triangles,
    as_int32,
    safe_inv_direction,
)
from .bvh import BVH, MAX_LEAF_SIZE, STACK_DEPTH

CHUNK = 1 << 18      # rays per pass (bounds the stack's memory)


def _traverse(o, d, t_min, t_max, bvh: BVH, tris: Triangles, qmask: int,
              any_hit: bool):
    """Per-ray traversal of one ray batch.  Returns (best_t, best_slot,
    u, v, nodes_visited, tri_tests, occluded), each (N,), and the count
    of dropped pushes."""
    n, dev = o.shape[0], o.device
    amin, amax = bvh.aabb_min, bvh.aabb_max
    lf, cnt = bvh.left_first.long(), bvh.count
    m, nt = amin.shape[0], tris.v0.shape[0]
    inv = safe_inv_direction(d)

    def slab(node, best, rows):
        ro, ri = o[rows], inv[rows]
        t1 = (amin[node] - ro) * ri
        t2 = (amax[node] - ro) * ri
        tnear = torch.minimum(t1, t2).amax(dim=-1)
        tfar = torch.maximum(t1, t2).amin(dim=-1)
        return (tfar >= tnear.clamp_min(0.0)) & (tnear <= best), tnear

    everyone = torch.arange(n, device=dev)
    root_hit, _ = slab(torch.zeros_like(everyone), t_max, everyone)
    sp = root_hit.long()
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    best = torch.minimum(t_max, torch.full_like(t_max, T_MAX_DEFAULT))
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros_like(best)
    bv = torch.zeros_like(best)
    nv = torch.zeros((n,), dtype=torch.int32, device=dev)
    tt = torch.zeros((n,), dtype=torch.int32, device=dev)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    offs = torch.arange(MAX_LEAF_SIZE, device=dev)
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        alive = (sp > 0) & ~occ if any_hit else sp > 0
        act = alive.nonzero()[:, 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack[act, sp[act]]
        nv[act] += 1
        c, first = cnt[node], lf[node]
        is_leaf = c > 0

        # ---- leaf: test up to MAX_LEAF_SIZE triangles
        slots = (first[:, None] + offs[None, :]).clamp(0, nt - 1)
        in_leaf = is_leaf[:, None] & (offs[None, :] < c[:, None])
        ab = best[act]
        valid, t, u, v = moller_trumbore(
            o[act, None], d[act, None], t_min[act, None],
            torch.minimum(t_max[act], ab)[:, None],
            tris.v0[slots], tris.edge1[slots], tris.edge2[slots])
        valid &= in_leaf & ((tris.layers[slots] & qmask) != 0)
        t_m = torch.where(valid, t, torch.full_like(t, float("inf")))
        k = t_m.argmin(dim=1, keepdim=True)
        cand = t_m.gather(1, k)[:, 0]
        better = cand < ab
        slot[act] = torch.where(better, slots.gather(1, k)[:, 0], slot[act])
        bu[act] = torch.where(better, u.gather(1, k)[:, 0], bu[act])
        bv[act] = torch.where(better, v.gather(1, k)[:, 0], bv[act])
        best[act] = torch.where(better, cand, ab)
        tt[act] += in_leaf.sum(dim=1, dtype=torch.int32)
        if any_hit:
            occ[act] |= valid.any(dim=1)

        # ---- internal: push far then near (leaves push nothing)
        left = (node + 1).clamp(max=m - 1)
        right = first.clamp(0, m - 1)
        bnow = best[act]
        lhit, lt = slab(left, bnow, act)
        rhit, rt = slab(right, bnow, act)
        lhit &= ~is_leaf
        rhit &= ~is_leaf
        near_is_left = lt <= rt
        for target, want in (
                (torch.where(near_is_left, right, left),
                 torch.where(near_is_left, rhit, lhit)),     # far
                (torch.where(near_is_left, left, right),
                 torch.where(near_is_left, lhit, rhit))):    # near
            push = want & (sp[act] < STACK_DEPTH)
            drops += (want & ~push).sum()
            r = act[push]
            stack[r, sp[r]] = target[push]
            sp[r] += 1
    return (best, slot, bu, bv, nv, tt, occ), drops


def cast_rays_bvh(rays: Rays, tris: Triangles, bvh: BVH,
                  query_mask=ALL_LAYERS,
                  any_hit: bool = False) -> tuple[Hits, RayStats,
                                                  torch.Tensor]:
    """Batched closest-hit (or occlusion) cast through a binary BVH.

    ``tris`` must already be in BVH slot order (``scene.build_scene``).
    Returns (hits, stats, occluded); ``occluded`` is only meaningful for
    ``any_hit=True``."""
    qmask = as_int32(query_mask)
    outs = [_traverse(rays.origin[s:s + CHUNK], rays.direction[s:s + CHUNK],
                      rays.t_min[s:s + CHUNK], rays.t_max[s:s + CHUNK], bvh,
                      tris, qmask, any_hit)
            for s in range(0, max(rays.count, 1), CHUNK)]
    best, slot, bu, bv, nv, tt, occ = (torch.cat(x) for x in
                                       zip(*(p for p, _ in outs)))
    found = slot >= 0
    g = slot.clamp_min(0)
    zero = torch.zeros_like(best)
    hits = Hits(
        t=torch.where(found, best, torch.full_like(best, T_MAX_DEFAULT)),
        position=torch.where(found[:, None],
                             rays.origin + rays.direction * best[:, None],
                             zero[:, None]),
        normal=torch.where(found[:, None], tris.normal[g], zero[:, None]),
        u=torch.where(found, bu, zero),
        v=torch.where(found, bv, zero),
        prim_id=torch.where(found, tris.prim_id[g],
                            torch.full_like(tris.prim_id[g], NO_HIT)),
        hit_layers=torch.where(found, tris.layers[g],
                               torch.zeros_like(tris.layers[g])),
    )
    dev = rays.origin.device
    stats = RayStats(
        rays_cast=torch.tensor(rays.count, dtype=torch.int64, device=dev),
        tri_tests=tt.sum(dtype=torch.int64),
        bvh_nodes_visited=nv.sum(dtype=torch.int64),
        hits=found.sum(),
        stack_drops=sum(dr for _, dr in outs),
    )
    return hits, stats, occ
