"""Wide cast — closest hit / any hit over the wide-node tables.

PyTorch counterpart of ``messyerraytracer_tpu/kernels/traverse_pallas.py``
(the module keeps its name so a reader finds the counterpart; here it
drives CUDA, not Pallas).  ``cast_rays_wide`` keeps the JAX signature and
return tuple.  Under it sits one kernel, B4 of the port
(``csrc/wide_cast.cu``), with its wrapper ``wide_cast_cuda``, and the
plain PyTorch version of the same per-ray algorithm, ``wide_cast_plain``.
``wide_cast`` routes by the device of the rays: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version.  The kernel also
serves the JAX package's streamed casts (``stream_leaves`` /
``stream_nodes``, its ``_traverse_kernel``): on the card the scene is read
from device memory through L2 either way.

The per-ray algorithm (kernel and plain version alike), over the binary
(K = 2) or the 8-wide (K = 8) tree, exact or quantized (``columnar="q"``)
child boxes:

  * the root is pushed unconditionally; a dead ray (t_max < t_min) tests
    against cap = -BIG and so opens nothing;
  * each pop slab-tests the K children (safe inverse direction) with
    ``tf >= max(tn, 0) && tn <= cap``, cap = min(best, t_max); absent
    children have the code -1 and are never hit;
  * children are visited front-to-back by the ray's own direction sign on
    the node's split axis: hit leaves near-to-far, each intersected at once
    if its entry distance is still <= cap; then hit internal children
    pushed far-to-near, every push that does not fit ``kstack`` counted in
    ``stack_drops``;
  * a leaf runs the classic Moller-Trumbore of the JAX kernel
    (traverse_pallas.py:754-789; no barycentric band) over its triangles
    in index order with a strictly-closer update; the winner's slot is
    leaf*4 + k;
  * ``query_mask`` != -1 rejects triangles with (layers & mask) == 0, in
    the traversal; a rejected triangle still counts in tri_tests, which
    adds each visited leaf's real triangle count (the JAX count lane);
  * any-hit retires the ray after the leaf that produced a hit.

Counters are per ray: tri_tests per ray, pops counts internal-node pops
over all rays.  (The JAX kernel counts a ray tile's shared footprint.)

The kernel is compiled with ``-fmad=false`` and both versions evaluate
every expression in the same order with IEEE division, so on one device
their hits and counters agree bit for bit; against the JAX package and the
brute oracle they agree by the ``bench.py::parity`` rule.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import (
    KERNEL_F32 as _F32,
    NO_HIT,
    PLAIN_CHUNK,
    Hits,
    Rays,
    RayStats,
    as_int32,
    kernel_stack,
    kstack_for,
    safe_inv_direction,
)
from ..native import CudaLibrary, check, check_rays, cuda_device
from ..utils.trace import count, span
from .wide import LEAF_CAP, WideScene

COLUMNAR = (None, True, False, "leaf", "q")   # the JAX layout choices


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _intersect_leaves(st, o, d, tmin, tmax, rays, leaf, ws, qmask):
    """Intersect rays ``rays`` with leaves ``leaf`` and update the state
    ``st`` in place (the kernel's ``intersect_leaf``, batched over rays
    and the leaf's 4 triangles)."""
    f = ws.leaf_tri[leaf]                                   # (B, 4, 9)
    col = lambda j: f[:, :, j]                              # noqa: E731
    rd, ro = d[rays], o[rays]
    dx, dy, dz = rd[:, 0, None], rd[:, 1, None], rd[:, 2, None]
    ox, oy, oz = ro[:, 0, None], ro[:, 1, None], ro[:, 2, None]
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det.abs() >= _F32["det_eps"]
    one = torch.ones_like(det)
    idet = one / torch.where(ok, det, one)
    tvx = ox - col(0)
    tvy = oy - col(1)
    tvz = oz - col(2)
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * idet
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * idet
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * idet
    cnt = ws.leaf_count[leaf]
    k = torch.arange(LEAF_CAP, device=leaf.device)
    best = st["best"][rays]
    valid = (ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t >= tmin[rays, None]) & (t <= tmax[rays, None])
             & (t < best[:, None]) & (k[None, :] < cnt[:, None]))
    if qmask != -1:
        lay = ws.slot_layers[leaf[:, None] * LEAF_CAP + k[None, :]]
        valid &= (lay & qmask) != 0
    st["tt"][rays] += cnt

    # winner: least t, lowest index among equal t (the kernel's
    # sequential strictly-closer loop)
    score = torch.where(valid, t, torch.full_like(t, _F32["big"]))
    tb = score.amin(dim=1, keepdim=True)
    found = valid.any(dim=1)
    kb = (valid & (score == tb)).to(torch.uint8).argmax(dim=1, keepdim=True)
    w = rays[found]
    kb = kb[found]
    st["best"][w] = tb[found, 0]
    st["u"][w] = u[found].gather(1, kb)[:, 0]
    st["v"][w] = v[found].gather(1, kb)[:, 0]
    st["slot"][w] = (leaf[found] * LEAF_CAP + kb[:, 0]).to(torch.int32)


def _plain_pass(o, d, tmin, tmax, ws, box, qmask, any_hit, kstack):
    """One pass of the plain version over a ray batch: a while loop over
    the active rays, each popping one node per step."""
    n, dev = o.shape[0], o.device
    kw = ws.branching
    st = {
        "best": torch.full((n,), _F32["big"], dtype=torch.float32,
                           device=dev),
        "u": torch.zeros((n,), dtype=torch.float32, device=dev),
        "v": torch.zeros((n,), dtype=torch.float32, device=dev),
        "slot": torch.full((n,), -1, dtype=torch.int32, device=dev),
        "tt": torch.zeros((n,), dtype=torch.int32, device=dev),
    }
    inv = safe_inv_direction(d)
    lim = torch.where(tmax >= tmin, tmax,
                      torch.full_like(tmax, -_F32["big"]))   # dead: -BIG
    stack = torch.zeros((n, kstack), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)   # root pushed
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    pops = torch.zeros((), dtype=torch.int64, device=dev)
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        act = ((sp > 0) & ~done).nonzero()[:, 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack[act, sp[act]]
        pops += act.numel()
        codes = ws.node_child[node]                        # (A, K)
        bx = box[node]                                     # (A, K, 6)
        ao, ai, alim = o[act], inv[act], lim[act]
        cap = torch.minimum(st["best"][act], alim)

        def slab(a):
            t1 = (bx[:, :, a] - ao[:, a, None]) * ai[:, a, None]
            t2 = (bx[:, :, a + 3] - ao[:, a, None]) * ai[:, a, None]
            return torch.minimum(t1, t2), torch.maximum(t1, t2)

        tn, tf = slab(0)
        for a in (1, 2):
            lo, hi = slab(a)
            tn = torch.maximum(tn, lo)
            tf = torch.minimum(tf, hi)
        hit = ((codes >= 0) & (tf >= tn.clamp_min(0.0))
               & (tn <= cap[:, None]))
        axis = ws.node_axis[node].long()
        fwd = d[act].gather(1, axis[:, None])[:, 0] >= 0.0

        def child(p):
            k = torch.where(fwd, p, kw - 1 - p)[:, None]
            return (codes.gather(1, k)[:, 0], hit.gather(1, k)[:, 0],
                    tn.gather(1, k)[:, 0])

        for p in range(kw):                 # leaves, near to far
            ck, hk, tk = child(p)
            sel = (hk & ((ck & 1) == 1) & ~done[act]
                   & (tk <= torch.minimum(st["best"][act], alim)))
            if bool(sel.any()):
                rays = act[sel]
                _intersect_leaves(st, o, d, tmin, tmax, rays,
                                  (ck[sel] >> 1).long(), ws, qmask)
                if any_hit:
                    done[rays] = st["slot"][rays] >= 0
        for p in range(kw - 1, -1, -1):     # internal children, far to near
            ck, hk, _ = child(p)
            sel = hk & ((ck & 1) == 0) & ~done[act]
            fits = sel & (sp[act] < kstack)
            drops += (sel & ~fits).sum()
            r = act[fits]
            stack[r, sp[r]] = (ck[fits] >> 1).long()
            sp[r] += 1

    found = st["slot"] >= 0
    zero = torch.zeros_like(st["best"])
    fout = torch.stack([
        torch.where(found, st["best"], torch.full_like(zero, _F32["t_miss"])),
        torch.where(found, st["u"], zero), torch.where(found, st["v"], zero)])
    iout = torch.stack([st["slot"], st["tt"]])
    return fout, iout, torch.stack([pops, drops])


def wide_cast_plain(origin, direction, t_min, t_max, ws: WideScene,
                    query_mask: int = -1, any_hit: bool = False,
                    quantized: bool = False, kstack: int | None = None,
                    chunk: int = PLAIN_CHUNK):
    """The plain PyTorch version of kernel B4, on any device.

    Returns (fout (3, N) f32 [t, u, v], iout (2, N) i32 [slot, tri_tests],
    counters (2,) int64 [pops, stack_drops]) — the kernel's outputs.
    ``quantized`` traverses the decoded 8-bit boxes
    (``WideScene.quantized_boxes``, the values the kernel decodes).  Rays
    are processed ``chunk`` at a time to bound memory."""
    kstack = kstack_for(ws.stack_need) if kstack is None else int(kstack)
    box = ws.quantized_boxes() if quantized else ws.node_box
    qmask = as_int32(query_mask)
    outs = [_plain_pass(origin[s:s + chunk], direction[s:s + chunk],
                        t_min[s:s + chunk], t_max[s:s + chunk], ws, box,
                        qmask, any_hit, kstack)
            for s in range(0, origin.shape[0], chunk)]
    if not outs:
        dev = origin.device
        return (torch.empty((3, 0), dtype=torch.float32, device=dev),
                torch.empty((2, 0), dtype=torch.int32, device=dev),
                torch.zeros(2, dtype=torch.int64, device=dev))
    return (torch.cat([f for f, _, _ in outs], dim=1),
            torch.cat([i for _, i, _ in outs], dim=1),
            sum(c for _, _, c in outs))


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
cuda_library = CudaLibrary("wide_cast.cu", "libmrt_wide_cast.so", {
    "mrt_wide_cast": (
        [_p, _p, _p, _p, _i]                    # rays, n
        + [_p, _p, _p]                          # exact nodes
        + [_p, _p, _p, _p]                      # quantized nodes
        + [_p, _p, _p]                          # leaves, slot layers
        + [_i, _i, _i, _i, _i, _i]              # K, q, qmask, any, kstack,
        #                                         kcap
        + [_f] * 4                              # f32 constants
        + [_p, _p, _p, _p, _p])})               # fout, iout, counters,
#                                                 warp_stats, stream


def wide_cast_cuda(origin, direction, t_min, t_max, ws: WideScene,
                   query_mask: int = -1, any_hit: bool = False,
                   quantized: bool = False, kstack: int | None = None,
                   warp_stats: torch.Tensor | None = None):
    """Launch kernel B4 on CUDA tensors; same outputs as
    ``wide_cast_plain``.  Launches on the current stream without
    synchronizing; raises if the launch is refused.

    ``warp_stats``: None, or a (5,) int64 tensor on the rays' device that
    the launch adds [node-phase passes, popping lanes, leaf-phase passes,
    wanting lanes, lanes whose leaf was tested cooperatively] to (a build
    of the kernel that counts; the lane occupancy of a phase is lanes /
    (32 x passes))."""
    kstack, kcap = kernel_stack(ws.stack_need, kstack)
    dev = cuda_device(origin.device, "wide_cast_cuda")
    n = check_rays(origin, direction, t_min, t_max, ws.node_box.device)
    qptr = ([t.data_ptr() for t in ws.quantized()] if quantized
            else [0, 0, 0, 0])
    if warp_stats is not None:
        check(warp_stats, "warp_stats", torch.int64, (5,), dev)
    fout = torch.empty((3, n), dtype=torch.float32, device=dev)
    iout = torch.empty((2, n), dtype=torch.int32, device=dev)
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    if n == 0:
        return fout, iout, counters
    cuda_library.launch("mrt_wide_cast", [
        origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
        t_max.data_ptr(), n,
        ws.node_box.data_ptr(), ws.node_child.data_ptr(),
        ws.node_axis.data_ptr(), *qptr,
        ws.leaf_tri.data_ptr(), ws.leaf_count.data_ptr(),
        ws.slot_layers.data_ptr(),
        ws.branching, int(bool(quantized)), as_int32(query_mask),
        int(bool(any_hit)), kstack, kcap,
        *(_F32[k] for k in ("det_eps", "inv_eps", "big", "t_miss")),
        fout.data_ptr(), iout.data_ptr(), counters.data_ptr(),
        None if warp_stats is None else warp_stats.data_ptr()],
        dev, "b4.launch")
    return fout, iout, counters


def wide_cast(rays: Rays, ws: WideScene, query_mask: int = -1,
              any_hit: bool = False, quantized: bool = False,
              kstack: int | None = None):
    """Kernel B4 on CUDA tensors, its plain version on CPU tensors.  Adds
    the batch's ray count to the counter ``b4.rays.any_hit`` or
    ``b4.rays.nearest`` (while a profiler records)."""
    count("b4.rays.any_hit" if any_hit else "b4.rays.nearest", rays.count)
    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, ws)
    kind = rays.origin.device.type
    if kind == "cuda":
        return wide_cast_cuda(*args, query_mask, any_hit, quantized, kstack)
    if kind == "cpu":
        return wide_cast_plain(*args, query_mask, any_hit, quantized, kstack)
    raise ValueError(f"no wide cast for device {rays.origin.device}")


# ---------------------------------------------------------------------------
# the cast entry point
# ---------------------------------------------------------------------------

def _hits_from_slots(fout, iout, rays: Rays, ws: WideScene):
    """Hits from the kernel's per-ray outputs: prim id, normal and layers
    through the slot tables, position = o + d*t (the JAX epilogue,
    traverse_pallas.py:1308-1328)."""
    t, slot = fout[0], iout[0]
    found = slot >= 0
    g = slot.clamp_min(0).long()
    zero = torch.zeros_like(rays.origin)
    hits = Hits(
        t=t,
        position=torch.where(found[:, None],
                             rays.origin + rays.direction * t[:, None], zero),
        normal=torch.where(found[:, None], ws.slot_normal[g], zero),
        u=fout[1],
        v=fout[2],
        prim_id=torch.where(found, ws.slot_prim_id[g],
                            torch.full_like(slot, NO_HIT)),
        hit_layers=torch.where(found, ws.slot_layers[g],
                               torch.zeros_like(slot)),
    )
    return hits, found


def cast_rays_wide(rays: Rays, scene: WideScene, query_mask: int = -1,
                   any_hit: bool = False, interpret=None, n_slots=None,
                   stream_leaves=None, stream_nodes=None, srows=None,
                   columnar=None, cond_drain=None):
    """Cast a ray batch through the wide-node scene (binary dual-AABB or
    8-wide, per ``scene.branching``).  Returns (hits, stats, occluded).

    ``columnar="q"`` (8-wide only) traverses the quantized 8-bit child
    boxes.  The other arguments are the JAX kernel's TPU layout and
    schedule knobs (interpret, n_slots, srows, cond_drain, columnar True /
    False / "leaf", and the streaming flags stream_leaves / stream_nodes):
    accepted and ignored — the same kernel serves every one of them.
    Kernel B4 and the hit assembly run inside the profiler range
    ``cast``, the hit assembly inside ``b4.hits``."""
    del interpret, n_slots, stream_leaves, stream_nodes, srows, cond_drain
    if columnar not in COLUMNAR:
        raise ValueError(f"columnar must be one of {COLUMNAR}")
    quantized = columnar == "q"
    with span("cast"):
        fout, iout, counters = wide_cast(rays, scene, query_mask, any_hit,
                                         quantized)
        with span("b4.hits"):
            hits, found = _hits_from_slots(fout, iout, rays, scene)
    dev = rays.origin.device
    stats = RayStats(
        rays_cast=torch.tensor(rays.count, dtype=torch.int64, device=dev),
        tri_tests=iout[1].sum(dtype=torch.int64),
        bvh_nodes_visited=counters[0],
        hits=found.sum(),
        stack_drops=counters[1],
    )
    return hits, stats, found
