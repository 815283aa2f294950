"""Wide-node helpers the cluster layout needs (from the JAX package's
kernels/wide.py): the 8-wide collapse of a binary DFS BVH and the lane
stride of the JAX node rows.

The 8-wide node shape is the CWBVH-class layout (tiny_bvh.h BVH8,
Ylitie'17): one node fetch tests EIGHT children, collapsing ~3 binary
levels per pop.  Children are sorted along the axis of maximum centroid
spread, so a ray visits them front-to-back by its direction sign on that
axis.  The JAX package packs two nodes per 128-lane row
(``NODE8_STRIDE`` lanes each: child k box at 6k..6k+5, enc at 48+k, sort
axis at 56) through gather-index tables (its ``_pack_idx``); the port
keeps dense per-node tables instead (kernels/cluster.py), so it needs no
index packing and reads JAX rows only to convert them.
"""

from __future__ import annotations

import numpy as np

NODE8_STRIDE = 64
WIDE8_CAP = 8


def _collapse8(amin: np.ndarray, amax: np.ndarray, lf: np.ndarray,
               cnt: np.ndarray):
    """Collapse the binary DFS BVH into an 8-wide tree (host, vectorized).

    Greedy: starting from a node's two children, repeatedly expand the
    internal child with the largest surface area until 8 children.
    Returns (children, axis): ``children`` is a (W, 8) int32 array of
    binary node ids (-1 = missing), sorted per node along ``axis`` (W,)
    by box centroid.  Whole BFS levels expand together as (F, 8) passes.
    """
    is_leaf = cnt > 0
    ext = np.maximum(amax - amin, 0.0)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]
    cent = (amin + amax) * 0.5

    if bool(is_leaf[0]):
        # degenerate: root is a leaf — one wide node holding it
        return (np.array([[0] + [-1] * 7], np.int32), np.zeros(1, np.int32))

    children_lvls: list[np.ndarray] = []
    axes_lvls: list[np.ndarray] = []
    frontier = np.array([0], np.int32)   # binary ids becoming wide nodes
    while frontier.size:
        f = frontier.size
        kids = np.full((f, WIDE8_CAP), -1, np.int32)
        kids[:, 0] = frontier + 1
        kids[:, 1] = lf[frontier]
        ncount = np.full(f, 2, np.int32)
        # greedy expansion: 6 rounds of replace-max-area-internal-child
        for _ in range(WIDE8_CAP - 2):
            present = kids >= 0
            safe = np.where(present, kids, 0)
            expandable = present & ~is_leaf[safe]
            a = np.where(expandable, area[safe], -np.inf)
            best = np.argmax(a, axis=1)
            rows = np.nonzero((a[np.arange(f), best] > -np.inf)
                              & (ncount < WIDE8_CAP))[0]
            if rows.size == 0:
                break
            kd = kids[rows, best[rows]]
            kids[rows, best[rows]] = kd + 1                # replace in place
            kids[rows, ncount[rows]] = lf[kd]              # append sibling
            ncount[rows] += 1
        # sort present kids along the max-centroid-spread axis
        present = kids >= 0
        safe = np.where(present, kids, 0)
        ck = np.where(present[..., None], cent[safe], np.nan)
        spread = np.nanmax(ck, axis=1) - np.nanmin(ck, axis=1)
        ax = np.argmax(spread, axis=1)
        key = np.where(present, np.take_along_axis(
            cent[safe], ax[:, None, None], axis=2)[..., 0], np.inf)
        ordr = np.argsort(key, axis=1, kind="stable")
        kids = np.take_along_axis(kids, ordr, axis=1)
        children_lvls.append(kids)
        axes_lvls.append(ax)
        flat = kids.reshape(-1)
        flat = flat[flat >= 0]
        frontier = flat[~is_leaf[flat]]                    # row-major BFS
    return (np.concatenate(children_lvls).astype(np.int32),
            np.concatenate(axes_lvls).astype(np.int32))
