"""Wide-node layouts: the binary dual-AABB and the 8-wide BVH over leaves
of up to 4 triangles, plus the 8-wide upper-tree helpers the cluster layout
shares.

PyTorch counterpart of ``messyerraytracer_tpu/kernels/wide.py``.  The JAX
package packs nodes and leaves into 128-lane rows through gather-index
tables (its ``_pack_idx``), stores integers as exact floats and marks
absent children with NaN boxes plus a trailing dummy node and dummy leaf,
because that is what a TPU DMA and vector unit want.  The port keeps dense
per-node tables instead (``WideScene``), as it does for clusters:

  * child boxes (W, K, 6) f32 [min.xyz, max.xyz], K = 2 or 8; NaN for an
    absent child (never read: its code says absent);
  * child codes (W, K) i32, 2*ptr + is_leaf, ``ABSENT`` (-1) for an
    absent child; ptr = wide node or leaf index;
  * split axis (W,) i32: the children are sorted along it, so a ray
    visits them front-to-back by its direction sign on that axis;
  * leaf triangles (L, 4, 9) f32 [v0, e1, e2], zero rows padding a leaf
    (their zero edges fail the determinant test); leaf counts (L,);
  * per padded slot (4L,): prim id, layers, unit normal, triangle slot.

Both layouts keep the JAX leaf order (DFS discovery) and wide node order
(binary: DFS; 8-wide: the BFS of ``_collapse8``), so slot numbers match
the JAX package's; ``wide_scene_from_jax`` converts JAX state and the
tests hold the port's builders against it, table for table.

The 8-wide shape is the CWBVH-class layout (tiny_bvh.h BVH8, Ylitie'17):
one node fetch tests eight children, collapsing ~3 binary levels per pop.
``WideScene.quantized`` derives its 8-bit child boxes (the JAX package's
``_to_columnar_q`` math).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import _bvh_host
from ..core.types import DEFAULT_DEVICE
from ..native import check_tables
from ..utils.trace import span

NODE_STRIDE = 16      # JAX lanes per binary node (8 per 128-lane row)
NODE8_STRIDE = 64     # JAX lanes per 8-wide node (2 per row)
LEAF_STRIDE = 64      # JAX lanes per leaf (2 per row)
LEAF_CAP = 4          # MAX_LEAF_SIZE
WIDE8_CAP = 8
ABSENT = -1           # child code of an empty child slot

_QSCALE = np.float32((1 + 2.0 ** -20) / 255)   # _to_columnar_q's margin


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


def _wide_stack_need(node_child) -> int:
    """Worst-case transient DFS stack depth of a wide tree, counted the
    way the casts push (all internal children of a popped node land on
    the stack before the next pop).

    ``node_child``: (W, K) child codes, row w = wide node w.  When node
    ``w`` is processed with ``d`` entries beneath it the peak is
    ``d + k(w)``; each of its ``k(w)`` internal kids is later processed
    with at most ``d + k(w) - 1`` entries beneath — conservative over both
    push orders.  Walks the tree one level at a time."""
    nc = np.asarray(node_child)
    internal = (nc >= 0) & ((nc & 1) == 0)
    kcnt = internal.sum(axis=1).astype(np.int64)
    need = 1                                     # root entry at init
    rows = np.zeros(1, np.int64)
    depth = np.zeros(1, np.int64)
    while rows.size:
        k = kcnt[rows]
        need = max(need, int((depth + k).max()))
        kids = (nc[rows] >> 1)[internal[rows]]   # row-major: rows in order
        depth = np.repeat(depth + k - 1, k)
        rows = kids.astype(np.int64)
    return need


def _upper_node_tables(amin, amax, lf, cnt, is_leaf, leaf_of,
                       collapsed=None):
    """8-wide node tables over a binary DFS tree whose leaves are the
    nodes flagged ``is_leaf`` (binary leaves, or cluster roots); a leaf's
    payload is ``leaf_of``.  Returns (node_box, node_child, node_axis, nw,
    stack_need, child_node): ``child_node`` (nw, 8) is the binary node
    each child slot holds, -1 for an absent slot (the refits regather
    ``node_box`` through it).  ``collapsed`` = (child_node, node_axis) of
    an earlier collapse of the same tree keeps its grouping (a checkpoint
    of a refit scene); None collapses over the boxes."""
    m = amin.shape[0]
    ucnt = np.where(is_leaf, 1, 0).astype(np.int32)
    children, waxes = (_collapse8(amin, amax, lf, ucnt) if collapsed is None
                       else collapsed)
    children = np.asarray(children, np.int32)
    nw = children.shape[0]

    wide_of = np.full(m, -1, np.int32)
    order = children[children >= 0]
    internal_kids = order[ucnt[order] == 0]
    wide_of[0] = 0
    wide_of[internal_kids] = np.arange(1, len(internal_kids) + 1,
                                       dtype=np.int32)

    present = children >= 0
    ck = np.where(present, children, 0)
    ptr = np.where(is_leaf[ck], leaf_of[ck], wide_of[ck])
    node_child = np.where(present, 2 * ptr + is_leaf[ck],
                          ABSENT).astype(np.int32)
    node_box = np.concatenate(
        [amin[ck], amax[ck]], axis=-1).astype(np.float32)   # (nw, 8, 6)
    node_box[~present] = np.nan
    return (node_box, node_child, np.asarray(waxes, np.int32), nw,
            _wide_stack_need(node_child), children)


def _child_boxes(child_node: torch.Tensor, bvh) -> torch.Tensor:
    """(W, K, 6) child boxes [min.xyz, max.xyz] gathered from ``bvh``'s
    node boxes through ``child_node``, NaN where a slot is absent: the
    build's ``node_box``, on the device of the BVH."""
    ck = child_node.clamp_min(0).long()
    box = torch.cat([bvh.aabb_min[ck], bvh.aabb_max[ck]], dim=-1)
    return torch.where((child_node >= 0)[..., None], box,
                       torch.full_like(box, float("nan")))


# ---------------------------------------------------------------------------
# the port's tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WideScene:
    """Tables of the wide cast (kernels/traverse_pallas.py), on one
    device; see the module docstring for the layout.

    ``dummy_enc`` (2 * W) and ``dummy_leaf`` (L) are the JAX package's
    never-hit dummy node code and all-zero dummy leaf index, kept as the
    scene's identity for conversions; ``stream_leaves`` / ``stream_nodes``
    are the JAX package's VMEM-fit flags, metadata only here.
    ``stack_need`` is the build-time worst-case traversal stack depth.
    ``child_node`` (W, K) i32 is the binary BVH node each child slot came
    from, -1 if absent (the refresh's gather table; None for tables
    converted from the JAX package).  Construction and ``quantized``
    check the tables kernel B4 reads (``check_tables``)."""

    node_box: torch.Tensor
    node_child: torch.Tensor
    node_axis: torch.Tensor
    leaf_tri: torch.Tensor
    leaf_count: torch.Tensor
    slot_prim_id: torch.Tensor
    slot_layers: torch.Tensor
    slot_normal: torch.Tensor
    slot_tri: torch.Tensor
    branching: int
    dummy_enc: int
    dummy_leaf: int
    stack_need: int
    stream_leaves: bool = False
    stream_nodes: bool = False
    child_node: torch.Tensor | None = None
    _q: tuple | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self._check(self._q)

    def _check(self, q: tuple | None) -> None:
        f32, i32 = torch.float32, torch.int32
        nw, kw, nl = self.node_child.shape[0], self.branching, self.num_leaves
        tables = [("node_box", self.node_box, f32, (nw, kw, 6)),
                  ("node_child", self.node_child, i32, (nw, kw)),
                  ("node_axis", self.node_axis, i32, (nw,)),
                  ("leaf_tri", self.leaf_tri, f32, (nl, LEAF_CAP, 9)),
                  ("leaf_count", self.leaf_count, i32, (nl,)),
                  ("slot_layers", self.slot_layers, i32, (nl * LEAF_CAP,))]
        if q is not None:
            tables += zip(("q_anchor", "q_scale", "q_lo", "q_hi"), q,
                          (f32, f32, i32, i32), ((nw, 3), (nw, 3), (nw, 8),
                                                 (nw, 8)))
        # B4 reads every table in 16-byte loads
        check_tables("WideScene", tables, [name for name, *_ in tables])

    @property
    def num_leaves(self) -> int:
        return self.leaf_count.shape[0]

    def quantized(self):
        """The 8-bit child boxes of the 8-wide nodes, computed at first
        use and cached: (anchor (W,3) f32, scale (W,3) f32, qlo (W,8) i32,
        qhi (W,8) i32), each q holding the x, y, z byte at bits 0, 8, 16.

        The float32 math of the JAX package's ``_to_columnar_q``: the
        anchor is the min corner of the node's children, one quantum is
        the node's extent over 255 widened by a relative 2^-20 and an
        absolute |coord|*2^-12 margin, and every bound moves one quantum
        outward, so ``anchor + q * scale`` always contains the exact box.
        Absent children get qlo = 0xFFFFFF, qhi = 0 as in JAX (their code
        skips them)."""
        if self._q is None:
            if self.branching != 8:
                raise ValueError("quantized nodes need the 8-wide layout")
            box, present = self.node_box, self.node_child >= 0
            pm = present[..., None]
            inf = torch.full_like(box[..., 0:3], float("inf"))
            mins = box[..., 0:3]
            maxs = box[..., 3:6]
            anchor = torch.where(pm, mins, inf).amin(dim=1)
            top = torch.where(pm, maxs, -inf).amax(dim=1)
            mag = anchor.abs() + top.abs()
            scale = (((top - anchor) + mag * 2.0 ** -12)
                     * torch.tensor(_QSCALE, device=box.device))
            safe = torch.where(scale > 0, scale, torch.ones_like(scale))
            rel_lo = (mins - anchor[:, None]) / safe[:, None]
            rel_hi = (maxs - anchor[:, None]) / safe[:, None]
            qlo = (torch.floor(rel_lo) - 1.0).clamp(0.0, 255.0)
            qhi = (torch.ceil(rel_hi) + 1.0).clamp(0.0, 255.0)

            def pack(q, absent_value):
                q = torch.where(pm, q, torch.zeros_like(q)).to(torch.int32)
                p = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
                return torch.where(present, p,
                                   torch.full_like(p, absent_value))

            q = (anchor.contiguous(), scale.contiguous(),
                 pack(qlo, 0xFFFFFF).contiguous(), pack(qhi, 0).contiguous())
            self._check(q)
            self._q = q
        return self._q

    def quantized_boxes(self) -> torch.Tensor:
        """The boxes the quantized nodes decode to, (W, 8, 6) like
        ``node_box``: ``anchor + q * scale`` per bound, in float32, the
        kernel's decode."""
        anchor, scale, qlo, qhi = self.quantized()
        lo, hi = [], []
        for a in range(3):
            for q, out in ((qlo, lo), (qhi, hi)):
                qa = ((q >> (8 * a)) & 255).to(torch.float32)
                out.append(anchor[:, None, a] + qa * scale[:, None, a])
        return torch.stack(lo + hi, dim=-1)


def _leaf_tables(lf, cnt, v0, e1, e2, nrm, pid, lay):
    """Leaf and slot tables over the binary leaves in DFS order (the
    JAX leaf gather's values)."""
    t = v0.shape[0]
    leaves = np.nonzero(cnt > 0)[0]
    ks = np.arange(LEAF_CAP, dtype=np.int64)[None, :]
    slots = np.clip(lf[leaves][:, None].astype(np.int64) + ks, 0,
                    max(t - 1, 0))                      # (L, 4)
    valid = ks < cnt[leaves][:, None]
    vm = valid[..., None]
    tri = np.concatenate([v0[slots], e1[slots], e2[slots]], axis=-1)
    return {
        "leaf_tri": np.where(vm, tri, 0.0).astype(np.float32),
        "leaf_count": cnt[leaves].astype(np.int32),
        "slot_prim_id": np.where(valid, pid[slots], -1).astype(
            np.int32).reshape(-1),
        "slot_layers": np.where(valid, lay[slots], 0).astype(
            np.int32).reshape(-1),
        "slot_normal": np.where(vm, nrm[slots], 0.0).astype(
            np.float32).reshape(-1, 3),
        "slot_tri": np.where(valid, slots, 0).astype(np.int32).reshape(-1),
    }


def _host_inputs(bvh, tris, _np):
    host = {k: _bvh_host(bvh, k) for k in (
        "aabb_min", "aabb_max", "left_first", "count", "split_axis")}
    if _np is None:
        _np = tuple(x.cpu().numpy() for x in (
            tris.v0, tris.edge1, tris.edge2, tris.normal, tris.prim_id,
            tris.layers))
    return host, tuple(np.asarray(a) for a in _np)


def _put(tables: dict, device) -> dict:
    return {k: torch.tensor(np.ascontiguousarray(v), device=device)
            for k, v in tables.items()}


def _finish(tables: dict, device, **meta) -> WideScene:
    return WideScene(**_put(tables, device), **meta,
                     stack_need=_wide_stack_need(tables["node_child"]))


def build_wide_scene(bvh, tris, _np=None, stream_leaves: bool = False,
                     stream_nodes: bool = False, device=None) -> WideScene:
    """The binary dual-AABB layout: one wide node per internal BVH node
    holding both children's boxes and codes (the JAX ``build_wide_scene``
    contract).  Host-side numpy; the tables go to ``device`` (default: the
    device of ``tris``, else ``DEFAULT_DEVICE``).  ``_np`` optionally
    gives host copies (v0, e1, e2, normal, prim_id, layers) in slot
    order."""
    host, (v0, e1, e2, nrm, pid, lay) = _host_inputs(bvh, tris, _np)
    amin, amax = host["aabb_min"], host["aabb_max"]
    lf, cnt = host["left_first"], host["count"]
    is_leaf = cnt > 0
    internal = np.nonzero(~is_leaf)[0]
    wide_of = np.cumsum(~is_leaf) - 1
    leaf_of = np.cumsum(is_leaf) - 1
    if len(internal) == 0:
        # root is a leaf: one wide node, left = leaf 0, right absent
        node_box = np.full((1, 2, 6), np.nan, np.float32)
        node_box[0, 0] = np.concatenate([amin[0], amax[0]])
        node_child = np.array([[1, ABSENT]], np.int32)
        node_axis = np.zeros(1, np.int32)
        kids = np.array([[0, -1]], np.int32)
    else:
        kids = np.stack([internal + 1, lf[internal]], axis=1)   # (W, 2)
        node_box = np.concatenate([amin[kids], amax[kids]],
                                  axis=-1).astype(np.float32)
        ptr = np.where(is_leaf[kids], leaf_of[kids], wide_of[kids])
        node_child = (2 * ptr + is_leaf[kids]).astype(np.int32)
        node_axis = host["split_axis"][internal].astype(np.int32)
    tables = {"node_box": node_box, "node_child": node_child,
              "node_axis": node_axis, "child_node": kids.astype(np.int32),
              **_leaf_tables(lf, cnt, v0, e1, e2, nrm, pid, lay)}
    if device is None:
        device = tris.v0.device if tris is not None else DEFAULT_DEVICE
    return _finish(tables, device, branching=2,
                   dummy_enc=2 * node_child.shape[0],
                   dummy_leaf=int(is_leaf.sum()),
                   stream_leaves=stream_leaves, stream_nodes=stream_nodes)


def build_wide8_scene(bvh, tris, _np=None, stream_leaves: bool = False,
                      stream_nodes: bool = False, device=None,
                      collapsed=None) -> WideScene:
    """The 8-wide layout: ``_collapse8`` over the binary BVH (or the given
    ``collapsed`` grouping, see ``_upper_node_tables``), leaves as in
    ``build_wide_scene`` (the JAX ``build_wide8_scene`` contract).  Runs
    inside the span ``wide.build``."""
    with span("wide.build"):
        host, (v0, e1, e2, nrm, pid, lay) = _host_inputs(bvh, tris, _np)
        lf, cnt = host["left_first"], host["count"]
        is_leaf = cnt > 0
        leaf_of = (np.cumsum(is_leaf) - 1).astype(np.int32)
        node_box, node_child, node_axis, nw, _, kids = _upper_node_tables(
            host["aabb_min"], host["aabb_max"], lf, cnt, is_leaf, leaf_of,
            collapsed)
        tables = {"node_box": node_box, "node_child": node_child,
                  "node_axis": node_axis, "child_node": kids,
                  **_leaf_tables(lf, cnt, v0, e1, e2, nrm, pid, lay)}
        if device is None:
            device = tris.v0.device if tris is not None else DEFAULT_DEVICE
        return _finish(tables, device, branching=8, dummy_enc=2 * nw,
                       dummy_leaf=int(is_leaf.sum()),
                       stream_leaves=stream_leaves,
                       stream_nodes=stream_nodes)


def refresh_wide_scene(wide: WideScene, bvh, tris) -> WideScene:
    """The tables after a refit, on their device: child boxes regathered
    from the refit ``bvh`` through ``child_node``, leaf triangles and slot
    normals from the re-derived slot-ordered ``tris`` through
    ``slot_tri``.  The topology (codes, axes, counts, slot ids) is
    unchanged; the cached quantized boxes are dropped.  Returns a new
    ``WideScene``; the old one's tensors are not written."""
    if wide.child_node is None:
        raise ValueError("refresh_wide_scene: these tables were converted "
                         "from the JAX package and carry no child_node "
                         "table; build them with the port's builders")
    slots = wide.slot_tri.long().view(wide.num_leaves, LEAF_CAP)
    ks = torch.arange(LEAF_CAP, device=slots.device)
    valid = (ks < wide.leaf_count[:, None])[..., None]       # (L, 4, 1)
    tri = torch.cat([tris.v0[slots], tris.edge1[slots], tris.edge2[slots]],
                    dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=slots.device)
    return dataclasses.replace(
        wide, node_box=_child_boxes(wide.child_node, bvh),
        leaf_tri=torch.where(valid, tri, zero),
        slot_normal=torch.where(valid, tris.normal[slots], zero).view(-1, 3),
        _q=None)


# ---------------------------------------------------------------------------
# conversion from the JAX package's scene state
# ---------------------------------------------------------------------------

def wide_scene_from_jax(nodes, leaf_tris, slot_prim_id, slot_layers,
                        slot_normal, slot_tri, *, branching: int,
                        dummy_enc: int, dummy_leaf: int,
                        stream_leaves: bool = False,
                        stream_nodes: bool = False,
                        device=DEFAULT_DEVICE) -> WideScene:
    """The port's tables from the numpy arrays of a JAX ``WideScene``
    (its lane-packed ``nodes`` and ``leaf_tris`` rows, the slot tables and
    metadata), so both packages can cast over the same scene state.

    Binary rows hold [Lmin, Lmax, Rmin, Rmax, Lenc, Renc, axis, 0] per 16
    lanes, 8-wide rows [8 boxes, 8 encs, axis, pad] per 64 lanes; a leaf
    is 4 x 9 triangle fields and its count at lane 36 of 64.  An absent
    child is the one with a NaN box (binary root-is-leaf's right child;
    the 8-wide dummy-enc children)."""
    k = int(branching)
    nw, nl = int(dummy_enc) // 2, int(dummy_leaf)
    stride = NODE8_STRIDE if k == WIDE8_CAP else NODE_STRIDE
    rows = np.asarray(nodes, np.float32).reshape(-1, stride)[:nw]
    node_box = np.ascontiguousarray(rows[:, :6 * k].reshape(nw, k, 6))
    enc = rows[:, 6 * k:7 * k]
    leaves = np.asarray(leaf_tris, np.float32).reshape(-1, LEAF_STRIDE)[:nl]
    tables = {
        "node_box": node_box,
        "node_child": np.where(np.isnan(node_box[..., 0]), ABSENT,
                               enc.astype(np.int32)).astype(np.int32),
        "node_axis": rows[:, 7 * k].astype(np.int32),
        "leaf_tri": np.ascontiguousarray(
            leaves[:, :9 * LEAF_CAP].reshape(nl, LEAF_CAP, 9)),
        "leaf_count": leaves[:, 9 * LEAF_CAP].astype(np.int32),
        "slot_prim_id": np.asarray(slot_prim_id, np.int32),
        "slot_layers": np.asarray(slot_layers, np.int32),
        "slot_normal": np.asarray(slot_normal, np.float32).reshape(-1, 3),
        "slot_tri": np.asarray(slot_tri, np.int32),
    }
    return _finish(tables, device, branching=k, dummy_enc=int(dummy_enc),
                   dummy_leaf=nl, stream_leaves=stream_leaves,
                   stream_nodes=stream_nodes)
