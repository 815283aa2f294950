"""Cluster cast — closest hit / any hit over the cluster tables.

PyTorch counterpart of ``messyerraytracer_tpu/kernels/cluster_v2.py``:
``cast_rays_cluster_v2`` (flat) and ``cast_rays_cluster_tlas_v2``
(instanced) keep its signatures and return tuples.  Under them sits one
kernel, B1 of the port (``csrc/cluster_cast.cu``), with its wrapper
``cluster_cast_cuda``, and the plain PyTorch version of the same per-ray
algorithm, ``cluster_cast_plain``.  ``cluster_cast`` routes by the device
of the rays: a CUDA tensor launches the kernel (or raises), a CPU tensor
runs the plain version.

The per-ray algorithm (kernel and plain version alike):

  * a dead ray (t_max < t_min) opens no node and returns a miss;
  * the stack starts with the root wide node; each pop slab-tests the 8
    children against cap = min(best, t_max) (absent children have the
    code -1 and are never hit — no NaN box is relied on);
  * children are visited front-to-back by the ray's own direction sign
    on the node's split axis: hit clusters near-to-far, each intersected
    at once if its entry distance is still <= min(best, t_max); then hit
    internal children pushed far-to-near, every push that does not fit
    ``kstack`` counted in ``stack_drops``;
  * a cluster runs the anchored Plucker Moller-Trumbore of the JAX kernel
    (cluster_v2.py:366-396) over its triangles in index order, so the
    lowest index wins a tie inside a cluster; instanced clusters move the
    ray to object space first (no renormalization) and the normal back
    through the inverse-transpose;
  * ``query_mask`` != -1 rejects triangles with (layers & mask) == 0;
    -1 applies no filter, as in the JAX package;
  * any-hit retires the ray after the cluster that produced a hit.

Counters are per ray: tri_tests adds a cluster's triangle count per
cluster visit, node_visits counts child boxes hit, pops counts node pops
over all rays.  (The JAX package counts a 2048-ray tile's shared
footprint instead.)

The kernel is compiled with ``-fmad=false`` and both versions evaluate
every expression in the same order with IEEE division, so on one device
their hits and counters agree bit for bit; against the JAX package and
the brute oracle they agree by the ``bench.py::parity`` rule.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.types import (
    KERNEL_F32 as _F32,
    NO_HIT,
    PLAIN_CHUNK,
    T_MAX_DEFAULT,
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
from .cluster import LOCAL_BITS, LOCAL_MASK, ClusterScene
from .cluster_tlas import ClusterTLAS


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _intersect_clusters(st, o, d, tmin, tmax, rays, code, cs, inst_mode,
                        qmask):
    """Intersect rays ``rays`` with the clusters of leaf codes ``code``
    and update the state ``st`` in place (the kernel's
    ``intersect_cluster``, batched over rays and the cluster's
    triangles)."""
    ro, rd = o[rays], d[rays]
    ox, oy, oz = ro[:, 0], ro[:, 1], ro[:, 2]
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    if inst_mode:
        inst = code >> LOCAL_BITS
        c = (cs.inst_cbase[inst] + (code & LOCAL_MASK)).long()
        m = cs.iinv[inst]
        ox, oy, oz = (m[:, 0] * ox + m[:, 1] * oy + m[:, 2] * oz + m[:, 3],
                      m[:, 4] * ox + m[:, 5] * oy + m[:, 6] * oz + m[:, 7],
                      m[:, 8] * ox + m[:, 9] * oy + m[:, 10] * oz
                      + m[:, 11])
        dx, dy, dz = (m[:, 0] * dx + m[:, 1] * dy + m[:, 2] * dz,
                      m[:, 4] * dx + m[:, 5] * dy + m[:, 6] * dz,
                      m[:, 8] * dx + m[:, 9] * dy + m[:, 10] * dz)
    else:
        c = code.long()
    anc = cs.cl_anchor[c]
    ax, ay, az = anc[:, 0], anc[:, 1], anc[:, 2]
    cnt = cs.cl_count[c]
    tau = dx * (ax - ox) + dy * (ay - oy) + dz * (az - oz)
    if inst_mode:
        tau = tau * torch.reciprocal(dx * dx + dy * dy + dz * dz)
    ocx = ox + tau * dx - ax
    ocy = oy + tau * dy - ay
    ocz = oz + tau * dz - az
    mx = ocy * dz - ocz * dy
    my = ocz * dx - ocx * dz
    mz = ocx * dy - ocy * dx

    f = cs.tri[c]                                   # (B, T, 16)
    col = lambda j: f[:, :, j]                      # noqa: E731
    col_r = lambda x: x[:, None]                    # noqa: E731
    dx, dy, dz = col_r(dx), col_r(dy), col_r(dz)
    mx, my, mz = col_r(mx), col_r(my), col_r(mz)
    det = col(0) * dx + col(1) * dy + col(2) * dz
    un = (col(3) * dx + col(4) * dy + col(5) * dz
          + col(6) * mx + col(7) * my + col(8) * mz)
    vn = (col(9) * dx + col(10) * dy + col(11) * dz
          + col(12) * mx + col(13) * my + col(14) * mz)
    tn = -(col(0) * col_r(ocx) + col(1) * col_r(ocy)
           + col(2) * col_r(ocz)) + col(15)
    ok = det.abs() >= _F32["det_eps"]
    one = torch.ones_like(det)
    idet = torch.reciprocal(torch.where(ok, det, one))
    u = un * idet
    v = vn * idet
    t = tn * idet + col_r(tau)
    best = st["best"][rays]
    k = torch.arange(cs.tcap, device=c.device)
    valid = (ok & (u >= _F32["bary_lo"]) & (u <= _F32["bary_hi"])
             & (v >= _F32["bary_lo"]) & (u + v <= _F32["bary_hi"])
             & (t >= col_r(tmin[rays])) & (t <= col_r(tmax[rays]))
             & (t < col_r(best)) & (k[None, :] < col_r(cnt)))
    lay = cs.tri_layers[c]
    if qmask != -1:
        valid &= (lay & qmask) != 0
    st["tt"][rays] += cnt

    # winner: least t, lowest index among equal t (the kernel's
    # sequential strictly-closer loop)
    score = torch.where(valid, t, torch.full_like(t, _F32["big"]))
    tb = score.amin(dim=1, keepdim=True)
    found = valid.any(dim=1)
    kb = (valid & (score == tb)).to(torch.uint8).argmax(dim=1, keepdim=True)
    w = rays[found]
    kb, c = kb[found], c[found]
    st["best"][w] = tb[found, 0]
    st["u"][w] = u[found].gather(1, kb)[:, 0]
    st["v"][w] = v[found].gather(1, kb)[:, 0]
    nn = f[found].gather(1, kb[:, :, None].expand(-1, 1, 3))[:, 0]
    nx, ny, nz = nn[:, 0], nn[:, 1], nn[:, 2]
    prim = cs.tri_prim[c].gather(1, kb)[:, 0]
    if inst_mode:
        ins = inst[found]
        fw = cs.ifwd[ins]
        nx, ny, nz = (fw[:, 0] * nx + fw[:, 1] * ny + fw[:, 2] * nz,
                      fw[:, 3] * nx + fw[:, 4] * ny + fw[:, 5] * nz,
                      fw[:, 6] * nx + fw[:, 7] * ny + fw[:, 8] * nz)
        prim = prim + cs.iprim[ins]
        st["inst"][w] = ins
    st["n"][w] = torch.stack([nx, ny, nz], dim=1)
    st["prim"][w] = prim
    st["lay"][w] = lay[found].gather(1, kb)[:, 0]


def _plain_pass(o, d, tmin, tmax, cs, inst_mode, qmask, any_hit, kstack):
    """One pass of the plain version over a ray batch: a while loop over
    the active rays, each popping one node per step."""
    n, dev = o.shape[0], o.device
    i32 = dict(dtype=torch.int32, device=dev)
    st = {
        "best": torch.full((n,), _F32["big"], dtype=torch.float32,
                           device=dev),
        "u": torch.zeros((n,), dtype=torch.float32, device=dev),
        "v": torch.zeros((n,), dtype=torch.float32, device=dev),
        "n": torch.zeros((n, 3), dtype=torch.float32, device=dev),
        "prim": torch.full((n,), NO_HIT, **i32),
        "lay": torch.zeros((n,), **i32),
        "inst": torch.full((n,), -1, **i32),
        "tt": torch.zeros((n,), **i32),
        "nv": torch.zeros((n,), **i32),
    }
    inv = safe_inv_direction(d)
    stack = torch.zeros((n, kstack), dtype=torch.int64, device=dev)
    sp = (tmax >= tmin).long()               # dead rays open no node
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
        codes = cs.node_child[node]                        # (A, 8)
        box = cs.node_box[node]                            # (A, 8, 6)
        ao, ai = o[act], inv[act]
        cap = torch.minimum(st["best"][act], tmax[act])

        def slab(a):
            t1 = (box[:, :, a] - ao[:, a, None]) * ai[:, a, None]
            t2 = (box[:, :, a + 3] - ao[:, a, None]) * ai[:, a, None]
            return torch.minimum(t1, t2), torch.maximum(t1, t2)

        tn, tf = slab(0)
        for a in (1, 2):
            lo, hi = slab(a)
            tn = torch.maximum(tn, lo)
            tf = torch.minimum(tf, hi)
        hit = ((codes >= 0) & (tf >= tn.clamp_min(0.0))
               & (tn <= cap[:, None]))
        st["nv"][act] += hit.sum(dim=1, dtype=torch.int32)
        axis = cs.node_axis[node].long()
        fwd = d[act].gather(1, axis[:, None])[:, 0] >= 0.0

        def child(p):
            k = torch.where(fwd, p, 7 - p)[:, None]
            return (codes.gather(1, k)[:, 0], hit.gather(1, k)[:, 0],
                    tn.gather(1, k)[:, 0])

        for p in range(8):                  # clusters, near to far
            ck, hk, tk = child(p)
            sel = (hk & ((ck & 1) == 1) & ~done[act]
                   & (tk <= torch.minimum(st["best"][act], tmax[act])))
            if bool(sel.any()):
                rays = act[sel]
                _intersect_clusters(st, o, d, tmin, tmax, rays, ck[sel] >> 1,
                                    cs, inst_mode, qmask)
                if any_hit:
                    done[rays] = st["prim"][rays] >= 0
        for p in range(7, -1, -1):          # internal children, far to near
            ck, hk, _ = child(p)
            sel = hk & ((ck & 1) == 0) & ~done[act]
            fits = sel & (sp[act] < kstack)
            drops += (sel & ~fits).sum()
            r = act[fits]
            stack[r, sp[r]] = (ck[fits] >> 1).long()
            sp[r] += 1

    found = st["prim"] >= 0
    zero = torch.zeros_like(st["best"])
    fout = torch.stack([
        torch.where(found, st["best"], torch.full_like(zero, _F32["t_miss"])),
        torch.where(found, st["u"], zero), torch.where(found, st["v"], zero),
        st["n"][:, 0], st["n"][:, 1], st["n"][:, 2]])
    iout = torch.stack([st["prim"], st["lay"], st["tt"], st["inst"],
                        st["nv"]])
    return fout, iout, torch.stack([pops, drops])


def cluster_cast_plain(origin, direction, t_min, t_max, cs: ClusterScene,
                       query_mask: int = -1, any_hit: bool = False,
                       kstack: int | None = None,
                       chunk: int = PLAIN_CHUNK):
    """The plain PyTorch version of kernel B1, on any device.

    Returns (fout (6, N) f32 [t, u, v, -n xyz], iout (5, N) i32 [prim,
    layers, tri_tests, instance, node_visits], counters (2,) int64
    [pops, stack_drops]) — the kernel's outputs.  Rays are processed
    ``chunk`` at a time to bound memory."""
    kstack = kstack_for(cs.stack_need) if kstack is None else int(kstack)
    inst_mode = isinstance(cs, ClusterTLAS)
    qmask = as_int32(query_mask)
    outs = [_plain_pass(origin[s:s + chunk], direction[s:s + chunk],
                        t_min[s:s + chunk], t_max[s:s + chunk], cs,
                        inst_mode, qmask, any_hit, kstack)
            for s in range(0, origin.shape[0], chunk)]
    if not outs:
        dev = origin.device
        return (torch.empty((6, 0), dtype=torch.float32, device=dev),
                torch.empty((5, 0), dtype=torch.int32, device=dev),
                torch.zeros(2, dtype=torch.int64, device=dev))
    return (torch.cat([f for f, _, _ in outs], dim=1),
            torch.cat([i for _, i, _ in outs], dim=1),
            sum(c for _, _, c in outs))


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
cuda_library = CudaLibrary("cluster_cast.cu", "libmrt_cluster_cast.so", {
    "mrt_cluster_cast": (
        [_p, _p, _p, _p, _i]                    # rays, n
        + [_p, _p, _p, _p, _p, _p, _p, _p, _i]  # scene tables, tcap
        + [_p, _p, _p, _p]                      # instance tables
        + [_i, _i, _i, _i]                      # qmask, any_hit, kstack,
        #                                         kcap
        + [_f] * 6                              # f32 constants
        + [_p, _p, _p, _p, _p])})               # fout, iout, counters,
#                                                 warp_stats, stream


def _kernel_args(origin, direction, t_min, t_max, cs: ClusterScene,
                 query_mask: int = -1, any_hit: bool = False,
                 kstack: int | None = None) -> list:
    """Check the per-call inputs of kernel B1 (rays, ``kstack``; ``cs``
    checked its tables) and return the leading arguments of its C entry,
    up to the outputs (rays, tables, flags, constants)."""
    kstack, kcap = kernel_stack(cs.stack_need, kstack)
    cuda_device(origin.device, "cluster_cast_cuda")
    n = check_rays(origin, direction, t_min, t_max, cs.node_box.device)
    inst = [0, 0, 0, 0]
    if isinstance(cs, ClusterTLAS):
        inst = [cs.inst_cbase.data_ptr(), cs.iprim.data_ptr(),
                cs.iinv.data_ptr(), cs.ifwd.data_ptr()]
    return [origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), n,
            cs.node_box.data_ptr(), cs.node_child.data_ptr(),
            cs.node_axis.data_ptr(), cs.tri.data_ptr(),
            cs.tri_prim.data_ptr(), cs.tri_layers.data_ptr(),
            cs.cl_anchor.data_ptr(), cs.cl_count.data_ptr(), cs.tcap, *inst,
            as_int32(query_mask), int(bool(any_hit)), kstack, kcap,
            *(_F32[k] for k in ("det_eps", "bary_lo", "bary_hi", "inv_eps",
                                 "big", "t_miss"))]


def cluster_cast_cuda(origin, direction, t_min, t_max, cs: ClusterScene,
                      query_mask: int = -1, any_hit: bool = False,
                      kstack: int | None = None,
                      warp_stats: torch.Tensor | None = None):
    """Launch kernel B1 on CUDA tensors; same outputs as
    ``cluster_cast_plain``.  Launches on the current stream without
    synchronizing; raises if the launch is refused.

    ``warp_stats``, a (3,) int64 tensor on the rays' device, makes the
    launch also add, over its warps, the cluster-phase passes, the lanes
    that wanted a cluster in them, and the (lane, cluster) pairs tested
    warp-cooperatively; None launches the kernel that does not count."""
    args = _kernel_args(origin, direction, t_min, t_max, cs, query_mask,
                        any_hit, kstack)
    dev, n = origin.device, origin.shape[0]
    if warp_stats is not None:
        check(warp_stats, "warp_stats", torch.int64, (3,), dev)
    fout = torch.empty((6, n), dtype=torch.float32, device=dev)
    iout = torch.empty((5, n), dtype=torch.int32, device=dev)
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    if n == 0:
        return fout, iout, counters
    cuda_library.launch("mrt_cluster_cast", args + [
        fout.data_ptr(), iout.data_ptr(), counters.data_ptr(),
        None if warp_stats is None else warp_stats.data_ptr()],
        dev, "b1.launch")
    return fout, iout, counters


def cluster_cast(rays: Rays, cs: ClusterScene, query_mask: int = -1,
                 any_hit: bool = False, kstack: int | None = None):
    """Kernel B1 on CUDA tensors, its plain version on CPU tensors."""
    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, cs)
    kind = rays.origin.device.type
    if kind == "cuda":
        return cluster_cast_cuda(*args, query_mask, any_hit, kstack)
    if kind == "cpu":
        return cluster_cast_plain(*args, query_mask, any_hit, kstack)
    raise ValueError(f"no cluster cast for device {rays.origin.device}")


# ---------------------------------------------------------------------------
# the cast entry points
# ---------------------------------------------------------------------------

def _hits_from_buffers_v2(fout, iout, rays: Rays):
    """Elementwise hit assembly from the kernel's per-ray outputs."""
    with span("hits.unpack"):
        t, u, v = fout.unbind(0)[:3]
        pid, lay, tt, inst, nv = iout.unbind(0)
        found = pid >= 0
    with span("hits.normal"):
        nrm = -fout[3:6].T
        ln = torch.sqrt((nrm * nrm).sum(dim=-1, keepdim=True))
        nrm = nrm / torch.where(ln > 0.0, ln, torch.ones_like(ln))
    with span("hits.fields"):
        zero = torch.zeros_like(nrm)
        hits = Hits(
            t=torch.where(found, t, torch.full_like(t, T_MAX_DEFAULT)),
            position=torch.where(found[:, None],
                                 rays.origin + rays.direction * t[:, None],
                                 zero),
            normal=torch.where(found[:, None], nrm, zero),
            u=u,
            v=v,
            prim_id=torch.where(found, pid, torch.full_like(pid, NO_HIT)),
            hit_layers=torch.where(found, lay, torch.zeros_like(lay)),
        )
        return hits, found, tt, inst, nv


def _cast(rays, cs, query_mask, any_hit):
    """Kernel B1 and its hit assembly, inside the span ``cast`` (the
    assembly in ``cast.hits``), and the counters ``b1.*``."""
    with span("cast"):
        fout, iout, counters = cluster_cast(rays, cs, query_mask, any_hit)
        with span("cast.hits"):
            hits, found, tt, inst, nv = _hits_from_buffers_v2(fout, iout,
                                                              rays)
    dev = rays.origin.device
    with span("cast.stats"):
        stats = RayStats(
            rays_cast=torch.tensor(rays.count, dtype=torch.int64,
                                   device=dev),
            tri_tests=tt.sum(dtype=torch.int64),
            bvh_nodes_visited=counters[0],
            hits=found.sum(),
            stack_drops=counters[1],
        )
    count("b1.rays", rays.count)
    count("b1.tri_tests", stats.tri_tests)
    count("b1.pops", counters[0])
    count("b1.stack_drops", counters[1])
    return hits, stats, found, tt, inst, nv


def cast_rays_cluster_v2(rays: Rays, cs: ClusterScene, query_mask: int = -1,
                         any_hit: bool = False, interpret=None, srows=None,
                         qd=None, popn=None, qroom=None, dmode=None,
                         probe: str = "", return_per_ray: bool = False,
                         nway=None):
    """Closest-hit / any-hit cast over ``ClusterScene`` tables.  While a
    profiler records, adds the call's rays, triangle tests, node pops and
    dropped stack pushes to the counters ``b1.rays``, ``b1.tri_tests``,
    ``b1.pops`` and ``b1.stack_drops``.

    Returns (hits, stats, occluded[, {"tri_tests", "node_visits"}]).  The
    TPU schedule knobs (interpret, srows, qd, popn, qroom, dmode, nway)
    are accepted and ignored; ``probe`` timing modes do not exist here."""
    del interpret, srows, qd, popn, qroom, dmode, nway
    if probe:
        raise ValueError("probe= timing modes are TPU-only")
    hits, stats, found, tt, _, nv = _cast(rays, cs, query_mask, any_hit)
    if return_per_ray:
        return hits, stats, found, {"tri_tests": tt, "node_visits": nv}
    return hits, stats, found


def cast_rays_cluster_tlas_v2(rays: Rays, ct: ClusterTLAS,
                              query_mask: int = -1, any_hit: bool = False,
                              interpret=None, srows=None, qd=None,
                              popn=None, qroom=None, dmode=None,
                              return_per_ray: bool = False, nway=None):
    """Instanced cast over ``ClusterTLAS`` tables.  Returns (hits, stats,
    occluded, instance_id[, per_ray dict]); prim ids are in the flattened
    scene's numbering, instance_id is -1 on a miss.  The TPU schedule
    knobs are accepted and ignored.  Adds to the counters ``b1.*`` as
    ``cast_rays_cluster_v2`` does."""
    del interpret, srows, qd, popn, qroom, dmode, nway
    if not isinstance(ct, ClusterTLAS):
        raise TypeError("cast_rays_cluster_tlas_v2 needs a ClusterTLAS")
    hits, stats, found, tt, inst, nv = _cast(rays, ct, query_mask, any_hit)
    with span("cast.instance"):
        inst_id = torch.where(found, inst, torch.full_like(inst, -1))
    if return_per_ray:
        return (hits, stats, found, inst_id,
                {"tri_tests": tt, "node_visits": nv})
    return hits, stats, found, inst_id
