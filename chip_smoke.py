"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
the port still builds and runs its main paths on the GPU.

    python3 chip_smoke.py

Builds both kernels from the checkout, each with its own nvcc started at
the same time (B1: kernels/csrc/cluster_cast.cu, B4: kernels/csrc/
wide_cast.cu; nvcc -> ctypes), then:

  1. holds kernel B1 against its plain PyTorch version on the card, bit
     for bit with every counter, on test-sized flat and instanced scenes
     (closest hit, any hit, a layer mask, dead and zero-direction rays, a
     forced small stack, coherent grid rays, sparse warps, a scene of
     duplicated triangles), and reads B1's warp stats to show which mode
     of its cluster phase each case took;
  2. drives the cluster main path at full size — the 1M-triangle instanced
     TLAS of the JAX package's bench.py headline (4 meshes, 215
     instances), one block-swizzled 1920x1080 frame through
     ``SceneTLAS.cast_rays_instanced`` and through the flat twin
     ``build_scene_from_tri_array(world_tris).cast_rays`` — counts the
     kernel launches of that run, checks both casts on a 4096-ray
     subsample against the brute oracle, and holds the kernel against its
     plain version on the whole frame at both shapes, timing each and
     reading its lane occupancy;
  3. holds kernel B4 against its plain version on the card, bit for bit
     with every counter, on the test-sized flat scene built with
     ``backend="pallas"`` at branching 8 and 2 (closest hit, any hit, a
     layer mask, the quantized nodes, the streamed casts of B5's contract,
     a forced small stack, coherent grid rays, sparse warps, a scene of
     duplicated triangles), and reads B4's warp stats (the lane occupancy
     of its node and leaf phases);
  4. drives the ``pallas`` path at full size — the same 1M world
     triangles built with ``backend="pallas"`` (8-wide), the same frame
     through ``RayScene.cast_rays`` and ``any_hit_rays`` — counts B4's
     launches (and that B1 did not launch), checks stack_drops and parity
     against brute, holds B4 against its plain version bit for bit on the
     whole frame as closest hit and as any hit, times the cast and the
     kernel (both modes, with both lane occupancies); the binary and
     quantized layouts at the same scene by parity, timed on the whole
     frame and held bit for bit on a 262,144-ray slice; and the v1
     cluster entry points (B3) on B1.

Every number is printed beside the card's name and power limit.  The last
two lines are the kernel summary and the result, both JSON.  Exits
non-zero, printing no result, when there is no CUDA card or any check
fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

FRAME = (1920, 1080)
SLICE = 262_144        # rays of the frame held kernel == plain per layout

# H100 SXM peaks for the bound (NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# float32 lane instructions per second outside the tensor cores: 132 SMs x
# 128 lanes x 1.98 GHz.  The data sheet's 67 TFLOP/s counts an FMA as two
# operations, but both kernels build with -fmad=false and the counts below
# are single instructions (sub, mul, min/max, compare), none of them fused.
F32_INSTR_PER_S = 33.5e12
# float32 instructions the algorithm does per unit of counted work
SLAB_OPS = 25          # one child box: 6 sub, 6 mul, 6 min/max, 4 combine,
#                        3 compare
MT_OPS = 55            # one classic Moller-Trumbore triangle test
PLUCKER_OPS = 46       # one anchored Plucker triangle test (B1)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after one warm-up, fenced by
    CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def build_kernels(card: str) -> None:
    """Build both kernel libraries, one nvcc each, started together."""
    from messyerraytracer_tpu_torch.kernels import cluster_v2, traverse_pallas

    t0 = time.time()
    errors = []

    def build(mod):
        try:
            mod.cuda_library()
        except Exception as e:      # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(m,))
               for m in (cluster_v2, traverse_pallas)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"[{card}] kernel build {time.time() - t0} s (2 nvcc in "
          f"parallel)", flush=True)


def random_rays(n: int, seed: int, extent: float, device,
                live_per_warp: int = 32):
    """Random rays from a seed, with dead rays (t_max < t_min) and
    zero-direction rays mixed in; ``live_per_warp`` < 32 also kills all
    but the first that many rays of every 32 (sparse warps)."""
    from messyerraytracer_tpu_torch.core.types import make_rays

    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 4.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::101] = 0.0
    t_max = np.full(n, 3.402823466e38, np.float32)
    t_max[::97] = -1.0
    t_max[np.arange(n) % 32 >= live_per_warp] = -1.0
    return make_rays(o, d, t_max=t_max, device=device)


def grid_rays(eye, target, fov: float, device, w: int = 256, h: int = 128):
    """A coherent pinhole frame, block-swizzled as the headline frame is
    (one warp covers a 16x2 pixel patch)."""
    import torch

    import messyerraytracer_tpu_torch as mrt
    from messyerraytracer_tpu_torch.dispatch.morton import (
        raster_block_permutation)

    cam = mrt.CameraParams.look_at(eye, target, fov_degrees=fov)
    perm = torch.as_tensor(raster_block_permutation(w, h, 32),
                           device=device).long()
    return mrt.generate_rays(cam, w, h, device=device).take(perm)


def compare_kernel_plain(rays, cs, chunk=None, **kw):
    """Run kernel B1 and its plain version on the same rays; check that
    they agree bit for bit: t, u, v, normals, prim ids, layers, instance
    ids, per-ray tri_tests and node_visits, pops and stack_drops; and that
    the kernel's warp-counting build returns the same.  Returns
    (max_abs_err, the plain version's ms on the host clock fenced by
    synchronization, warp stats [passes, wanting lanes, cooperative
    pairs])."""
    import torch

    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        PLAIN_CHUNK, cluster_cast_cuda, cluster_cast_plain)

    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, cs)
    stats = torch.zeros(3, dtype=torch.int64, device=rays.origin.device)
    fk, ik, ck = cluster_cast_cuda(*args, **kw)
    counted = cluster_cast_cuda(*args, warp_stats=stats, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(counted, (fk, ik, ck))),
          f"kernel == its warp-counting build {kw}")
    t0 = time.time()
    fp, ip, cp = cluster_cast_plain(*args, chunk=chunk or PLAIN_CHUNK, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    err = float((fk - fp).abs().max()) if fk.numel() else 0.0
    check(err == 0.0 and torch.equal(fk, fp),
          f"t/u/v/normals kernel == plain {kw}: max_abs_err {err}")
    for row, what in enumerate(("prim ids", "layers", "tri_tests",
                                "instance ids", "node_visits")):
        check(torch.equal(ik[row], ip[row]), f"{what} kernel == plain {kw}")
    check(torch.equal(ck, cp), f"pops/stack_drops kernel == plain {kw}")
    return err, plain_ms, [int(x) for x in stats.tolist()]


def occupancy(stats) -> float:
    """Lane occupancy of the cluster phase: wanting lanes / (32 x
    passes)."""
    return stats[1] / (32 * stats[0]) if stats[0] else 0.0


def compare_wide_plain(rays, ws, chunk=None, **kw):
    """Run kernel B4 and its plain version on the same rays; check that
    they agree bit for bit: t, u, v, slots, per-ray tri_tests, pops and
    stack_drops; and that the kernel's warp-counting build returns the
    same.  Returns (max_abs_err, plain ms, kernel outputs, warp stats
    [node-phase passes, popping lanes, leaf-phase passes, wanting lanes,
    cooperatively tested lanes])."""
    import torch

    from messyerraytracer_tpu_torch.kernels.traverse_pallas import (
        PLAIN_CHUNK, wide_cast_cuda, wide_cast_plain)

    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, ws)
    stats = torch.zeros(5, dtype=torch.int64, device=rays.origin.device)
    k = wide_cast_cuda(*args, **kw)
    counted = wide_cast_cuda(*args, warp_stats=stats, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(counted, k)),
          f"B4 == its warp-counting build {kw}")
    t0 = time.time()
    p = wide_cast_plain(*args, chunk=chunk or PLAIN_CHUNK, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    (fk, ik, ck), (fp, ip, cp) = k, p
    err = float((fk - fp).abs().max()) if fk.numel() else 0.0
    check(err == 0.0 and torch.equal(fk, fp),
          f"B4 t/u/v kernel == plain {kw}: max_abs_err {err}")
    check(torch.equal(ik, ip), f"B4 slots/tri_tests kernel == plain {kw}")
    check(torch.equal(ck, cp), f"B4 pops/stack_drops kernel == plain {kw}")
    return err, plain_ms, k, [int(x) for x in stats.tolist()]


def wide_occupancy(stats) -> tuple[float, float]:
    """B4's lane occupancy of its node phase (popping lanes / (32 x
    passes)) and of its leaf phase (wanting lanes / (32 x passes))."""
    return (stats[1] / (32 * stats[0]) if stats[0] else 0.0,
            stats[3] / (32 * stats[2]) if stats[2] else 0.0)


def coop_share(stats) -> float:
    """The share of B4's leaf visits tested cooperatively."""
    return stats[4] / stats[3] if stats[3] else 0.0


def small_flat_tris():
    """The ~22K-triangle flat test scene: a wavy plane (layer 1) and a
    sphere (layer 2)."""
    from messyerraytracer_tpu_torch.utils import meshes

    g = meshes.plane(16.0, y=0.0, subdiv=80)
    g[:, :, 1] = np.sin(g[:, :, 0]) * 0.6
    sph = meshes.uv_sphere(2.0, 48, 96, center=(0, 2.5, 0))
    layers = np.concatenate([np.full(len(g), 0b01, np.int32),
                             np.full(len(sph), 0b10, np.int32)])
    return np.concatenate([g, sph]), layers


def small_scenes(device, copies: int = 1):
    """The flat test scene and a small instanced one; ``copies`` = 2
    duplicates every triangle of each mesh at a higher index (the tie
    scene: both copies land in one cluster, so every hit is a tie that the
    lower index must win)."""
    from messyerraytracer_tpu_torch.kernels.cluster_tlas import (
        build_cluster_tlas)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)
    from messyerraytracer_tpu_torch.utils import meshes

    tris, layers = small_flat_tris()
    flat = build_scene_from_tri_array(np.concatenate([tris] * copies),
                                      layers=np.concatenate([layers] * copies),
                                      device=device)

    def xform(t, s=1.0):
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.eye(3) * s
        m[:, 3] = t
        return m

    inst = [(0, xform((x, 0.0, z), 0.4)) for x in range(-4, 5, 2)
            for z in range(-4, 5, 2)]
    inst += [(1, xform((-3, 0, 0), 1.2)), (1, xform((3, 0.5, -1), 0.5))]
    ct = build_cluster_tlas(
        [np.concatenate([m] * copies) for m in (
            meshes.uv_sphere(1.0, 16, 32), meshes.box((1.0, 2.0, 1.0)))],
        inst, tcap=32, device=device)
    return flat, ct


def phase_kernel_vs_plain(card: str, device) -> None:
    """Phase 1: kernel B1 against its plain version on the card, bit for
    bit, and each mode of its cluster phase taken where the case says:
    coherent grid rays test their clusters lane-serially, sparse warps (28
    of every 32 rays dead) warp-cooperatively, and the tie scene makes the
    cooperative reduction keep the lowest index."""
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        cluster_cast_cuda)

    flat, ct = small_scenes(device)
    tie_flat, tie_ct = small_scenes(device, copies=2)
    before = cluster_cast_cuda.launches
    worst = 0.0

    def case(name, what, rays, cs, **kw):
        nonlocal worst
        err, _, st = compare_kernel_plain(rays, cs, **kw)
        worst = max(worst, err)
        print(f"[{card}] phase 1 {name} {what} {kw or ''}: kernel == "
              f"plain, max_abs_err {err}; warp stats {st} (passes, wanting "
              f"lanes, cooperative pairs), lane occupancy {occupancy(st)}",
              flush=True)
        return st

    for name, cs, tie, extent, cam in (
            ("flat", flat.cluster, tie_flat.cluster, 8.0,
             ((1, 3, 6), (3, 0, 3), 8.0)),
            ("instanced", ct, tie_ct, 5.0, ((0, 1, 3), (0, 0, 0), 10.0))):
        rays = random_rays(8192, 1, extent, device)
        for kw in ({}, {"any_hit": True}, {"query_mask": 0b10},
                   {"kstack": 1}):
            case(name, "random", rays, cs, **kw)
        _, _, counters = cluster_cast_cuda(
            rays.origin, rays.direction, rays.t_min, rays.t_max, cs,
            kstack=1)
        check(int(counters[1]) > 0, f"{name}: forced small stack drops")
        st = case(name, "coherent grid", grid_rays(*cam, device), cs)
        check(st[1] > 0 and st[2] <= st[1] // 10,
              f"{name} coherent: the serial mode takes >= 90% of pairs")
        sparse = random_rays(8192, 3, extent, device, live_per_warp=4)
        st = case(name, "sparse warps", sparse, cs)
        check(st[1] > 0 and st[2] == st[1],
              f"{name} sparse warps: every pair cooperative")
        for what, r in (("tie scene", random_rays(8192, 4, extent, device)),
                        ("tie scene, sparse warps",
                         random_rays(8192, 4, extent, device,
                                     live_per_warp=4))):
            st = case(name, what, r, tie)
            check(st[2] > 0, f"{name} {what}: cooperative pairs tested")
    # on the flat tie scene every hit is on the first copy: prim ids are
    # input indices, so the lowest index won each tie
    rays = random_rays(8192, 4, 8.0, device)
    _, iout, _ = cluster_cast_cuda(rays.origin, rays.direction, rays.t_min,
                                   rays.t_max, tie_flat.cluster)
    prim = iout[0][iout[0] >= 0]
    check(prim.numel() > 0 and bool((prim < len(small_flat_tris()[0])).all()),
          "tie scene: rays hit, each on the lower copy")
    check(cluster_cast_cuda.launches > before, "kernel launch count rose")
    print(f"[{card}] phase 1 ok: worst max_abs_err {worst}; tie scene: "
          f"{prim.numel()} hits, all on the lower copy", flush=True)


def headline_tlas(device):
    """The bench.py headline scene (bench.py:122-167), through the port."""
    from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS
    from messyerraytracer_tpu_torch.utils import meshes

    terrain = meshes.plane(20.0, y=0.0, subdiv=100)
    terrain[:, :, 1] = (np.sin(terrain[:, :, 0] * 0.9)
                        * np.cos(terrain[:, :, 2] * 0.8))
    sphere_hi = meshes.uv_sphere(1.6, 64, 64)
    sphere_lo = meshes.uv_sphere(1.0, 32, 32)
    rock = meshes.box((1.4, 1.0, 1.2))
    rng = np.random.default_rng(11)

    def xf(tx, ty, tz, s=1.0):
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = s
        m[:3, 3] = (tx, ty, tz)
        return m

    times = {}
    t0 = time.time()
    tlas = SceneTLAS(backend="cluster", device=device)
    m_ter = tlas.add_mesh(terrain)
    m_shi = tlas.add_mesh(sphere_hi)
    m_slo = tlas.add_mesh(sphere_lo)
    m_rock = tlas.add_mesh(rock)
    times["meshes"] = time.time() - t0
    for gx in range(4):
        for gz in range(4):
            tlas.add_instance(m_ter, xf((gx - 1.5) * 20, 0.0,
                                        (gz - 1.5) * 20))
    for _ in range(60):
        c = rng.uniform(-35, 35, 2)
        tlas.add_instance(m_shi, xf(c[0], rng.uniform(1.5, 4.0), c[1],
                                    s=rng.uniform(0.6, 1.4)))
    for _ in range(99):
        c = rng.uniform(-35, 35, 2)
        tlas.add_instance(m_slo, xf(c[0], rng.uniform(0.8, 2.5), c[1],
                                    s=rng.uniform(0.5, 1.5)))
    for _ in range(40):
        c = rng.uniform(-35, 35, 2)
        tlas.add_instance(m_rock, xf(c[0], 0.5, c[1]))
    t1 = time.time()
    tlas.build_tlas()
    times["flatten"] = time.time() - t1
    t1 = time.time()
    tlas.build_instanced()
    times["instanced"] = time.time() - t1
    times["build_tlas_s"] = time.time() - t0
    return tlas, times


def frame_rays(device):
    """The headline 1920x1080 frame, block-swizzled (bench.py:34-45)."""
    import torch

    import messyerraytracer_tpu_torch as mrt
    from messyerraytracer_tpu_torch.dispatch.morton import (
        raster_block_permutation)

    w, h = FRAME
    cam = mrt.CameraParams.look_at((0, 26, 55), (0, 1, 0), fov_degrees=60.0)
    perm = torch.as_tensor(raster_block_permutation(w, h, 32),
                           device=device).long()
    return mrt.generate_rays(cam, w, h, device=device).take(perm)


def cluster_bound(cs, rays, fout, iout, counters):
    """B1's bound on this run's inputs: rays, scene tables and outputs
    moved once; slab tests of 8 children per pop and one Plucker test per
    counted triangle test."""
    import torch

    from messyerraytracer_tpu_torch.kernels.cluster_tlas import ClusterTLAS

    tables = [cs.node_box, cs.node_child, cs.node_axis, cs.tri, cs.tri_prim,
              cs.tri_layers, cs.cl_anchor, cs.cl_count]
    if isinstance(cs, ClusterTLAS):
        tables += [cs.inst_cbase, cs.iprim, cs.iinv, cs.ifwd]
    moved = nbytes(rays.origin, rays.direction, rays.t_min, rays.t_max,
                   fout, iout, *tables)
    ops = (int(counters[0]) * 8 * SLAB_OPS
           + int(iout[2].sum(dtype=torch.int64)) * PLUCKER_OPS)
    return bound(moved, ops)


def wide_bound(ws, rays, fout, iout, counters, quantized=False):
    """B4's bound on this run's inputs: rays, scene tables and outputs
    moved once; K slab tests per pop and one Moller-Trumbore test per
    counted triangle test."""
    import torch

    nodes = (list(ws.quantized()) if quantized else [ws.node_box])
    moved = nbytes(rays.origin, rays.direction, rays.t_min, rays.t_max,
                   fout, iout, *nodes, ws.node_child, ws.node_axis,
                   ws.leaf_tri, ws.leaf_count)
    ops = (int(counters[0]) * ws.branching * SLAB_OPS
           + int(iout[1].sum(dtype=torch.int64)) * MT_OPS)
    return bound(moved, ops)


def phase_main_path(card: str, device):
    """Phase 2: the headline cluster main path at full size.  Returns B1's
    summary and what phase 4 reuses (world triangles, frame, the brute
    oracle's hits on the subsample)."""
    import torch

    from messyerraytracer_tpu_torch.core.brute import cast_rays_brute, parity
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        cluster_cast_cuda)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    tlas, times = headline_tlas(device)
    world_tris = tlas._world_tris_np()
    t0 = time.time()
    flat = build_scene_from_tri_array(world_tris, device=device)
    times["build_1m_flat_s"] = time.time() - t0
    rays = frame_rays(device)
    n = rays.count
    print(f"[{card}] scene: {len(tlas.instances)} instances, "
          f"{world_tris.shape[0]} world triangles, {n} rays; build s "
          f"{json.dumps(times)}", flush=True)

    # ---- the main path's own run: counts reset just before, read after
    cluster_cast_cuda.launches = 0
    hi, si, _, inst = tlas.cast_rays_instanced(rays)
    hf, sf = flat.cast_rays(rays)
    torch.cuda.synchronize()
    launches = cluster_cast_cuda.launches
    check(launches > 0, "main path launched kernel B1")
    for name, h, s in (("instanced", hi, si), ("flat", hf, sf)):
        check(int(s.stack_drops) == 0, f"{name}: stack_drops == 0")
        check(bool(torch.isfinite(h.t).all()), f"{name}: finite t")
        print(f"[{card}] {name} 1080p: hit_rate "
              f"{float(h.hit.float().mean())}, stack_drops "
              f"{int(s.stack_drops)}, tri_tests/ray "
              f"{int(s.tri_tests) / n}, pops/ray "
              f"{int(s.bvh_nodes_visited) / n}", flush=True)
    check(torch.equal(hi.hit, inst >= 0), "instance id set on every hit")
    print(f"[{card}] main path: kernel B1 launches {launches}", flush=True)

    # ---- parity against the brute oracle on a strided subsample
    idx = torch.arange(4096, device=device) * (n // 4096)
    sub = rays.take(idx)
    hb, _ = cast_rays_brute(sub, flat.tris, chunk=8192)
    hs_i, _, _, _ = tlas.cast_rays_instanced(sub)
    hs_f, _ = flat.cast_rays(sub)
    for name, hs in (("instanced", hs_i), ("flat", hs_f)):
        ok = parity(hs, hb)
        print(f"[{card}] parity {name} vs brute (4096 rays): {ok}",
              flush=True)
        check(ok, f"{name} parity vs brute")

    # ---- timing: the cast entry points, then kernel vs plain alone
    dt_i = cuda_ms(lambda: tlas.cast_rays_instanced(rays), 5)
    dt_f = cuda_ms(lambda: flat.cast_rays(rays), 5)
    for name, dt in (("instanced", dt_i), ("flat", dt_f)):
        print(f"[{card}] {name} cast 1080p: {dt} ms/frame, "
              f"{n / dt / 1e3} Mrays/s", flush=True)
    print(f"[{card}] instanced_vs_flat {dt_f / dt_i}", flush=True)

    # ---- kernel B1 against its plain version at both frame shapes, with
    # the lane occupancy of its cluster phase; the summary keeps the
    # instanced times and bound and the larger error
    k = {"launches": launches, "max_abs_err": 0.0}
    for name, cs in (("instanced", tlas._ctlas), ("flat", flat.cluster)):
        args = (rays.origin, rays.direction, rays.t_min, rays.t_max, cs)
        ms = cuda_ms(lambda: cluster_cast_cuda(*args), 5)
        err, plain_ms, st = compare_kernel_plain(rays, cs, chunk=1 << 20)
        bms, by = cluster_bound(cs, rays, *cluster_cast_cuda(*args))
        print(f"[{card}] kernel B1 {name} frame (T={cs.tcap}): kernel "
              f"{ms} ms, plain {plain_ms} ms, bound {bms} ms ({by}), "
              f"kernel == plain, max_abs_err {err}; lane occupancy "
              f"{occupancy(st)}, cooperative pairs/ray {st[2] / n}, "
              f"cluster visits/ray {st[1] / n}, warp stats {st}",
              flush=True)
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if name == "instanced":
            k.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    k["library_ms"] = None       # no single PyTorch call casts over a BVH
    ctx = {"world_tris": world_tris, "rays": rays, "sub": sub, "hb": hb,
           "tlas": tlas, "flat": flat}
    return k, ctx


def phase_wide_vs_plain(card: str, device) -> None:
    """Phase 3: kernel B4 against its plain version on the card, bit for
    bit, with the lane occupancy of its node and leaf phases: random rays
    (closest, any hit, a layer mask, a forced small stack, quantized
    nodes), coherent grid rays, sparse warps (28 of every 32 rays dead)
    and a scene of duplicated triangles (ties the lower slot must win)."""
    import torch

    from messyerraytracer_tpu_torch.kernels.traverse_pallas import (
        cast_rays_wide, wide_cast_cuda)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    tris, layers = small_flat_tris()
    rays = random_rays(8192, 2, 8.0, device)
    extra = (("coherent grid", grid_rays((1, 3, 6), (3, 0, 3), 8.0, device),
              1),
             ("sparse warps", random_rays(8192, 3, 8.0, device,
                                          live_per_warp=4), 1),
             ("tie scene", random_rays(8192, 4, 8.0, device), 2))
    before = wide_cast_cuda.launches
    worst = 0.0
    for branching in (8, 2):
        def scene(copies):
            return build_scene_from_tri_array(
                np.concatenate([tris] * copies),
                layers=np.concatenate([layers] * copies), backend="pallas",
                branching=branching, device=device).wide

        ws = scene(1)
        cases = [("random", rays, ws, kw) for kw in (
            {}, {"any_hit": True}, {"query_mask": 0b10}, {"kstack": 1})]
        if branching == 8:
            cases.append(("random", rays, ws, {"quantized": True}))
        cases += [(what, r, ws if copies == 1 else scene(copies), {})
                  for what, r, copies in extra]
        for what, r, w, kw in cases:
            err, _, (fk, ik, ck), st = compare_wide_plain(r, w, **kw)
            worst = max(worst, err)
            if kw.get("kstack") == 1:
                check(int(ck[1]) > 0, "B4 forced small stack drops")
            if what != "random":
                check(int((ik[0] >= 0).sum()) > 0, f"B4 {what}: rays hit")
            print(f"[{card}] phase 3 branching {branching} {what} "
                  f"{kw or 'closest'}: kernel == plain, max_abs_err {err}, "
                  f"stack_drops {int(ck[1])}; warp stats {st} (node "
                  f"passes, popping lanes, leaf passes, wanting lanes, "
                  f"cooperative lanes), lane occupancy node/leaf "
                  f"{wide_occupancy(st)}, cooperative share "
                  f"{coop_share(st)}", flush=True)
            if what == "random" and not kw:
                closest = (fk, ik)
        # B5's contract: the streamed cast launches the same kernel
        n0 = wide_cast_cuda.launches
        hs, ss, _ = cast_rays_wide(rays, ws, stream_leaves=True,
                                   stream_nodes=True)
        torch.cuda.synchronize()
        check(wide_cast_cuda.launches == n0 + 1, "streamed cast launched B4")
        check(torch.equal(hs.t, closest[0][0])
              and torch.equal(hs.prim_id >= 0, closest[1][0] >= 0),
              "streamed cast == closest-hit kernel (== plain)")
        check(int(ss.stack_drops) == 0, "streamed cast stack_drops == 0")
        print(f"[{card}] phase 3 branching {branching} streamed "
              f"(stream_leaves, stream_nodes): == kernel == plain",
              flush=True)
    check(wide_cast_cuda.launches > before, "B4 launch count rose")
    print(f"[{card}] phase 3 ok: worst max_abs_err {worst}", flush=True)


def phase_pallas_path(card: str, device, ctx: dict) -> dict:
    """Phase 4: the pallas path at full size, and B3's entry points."""
    import torch

    from messyerraytracer_tpu_torch.core.brute import parity
    from messyerraytracer_tpu_torch.kernels.cluster import cast_rays_cluster
    from messyerraytracer_tpu_torch.kernels.cluster_tlas import (
        cast_rays_cluster_tlas)
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        cast_rays_cluster_tlas_v2, cast_rays_cluster_v2, cluster_cast_cuda)
    from messyerraytracer_tpu_torch.kernels.traverse_pallas import (
        cast_rays_wide, wide_cast_cuda)
    from messyerraytracer_tpu_torch.kernels.wide import build_wide_scene
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    rays, sub, hb = ctx["rays"], ctx["sub"], ctx["hb"]
    n = rays.count
    t0 = time.time()
    scene = build_scene_from_tri_array(ctx["world_tris"], backend="pallas",
                                       device=device)
    ws = scene.wide
    build_s = time.time() - t0
    print(f"[{card}] pallas scene (8-wide): {ws.node_child.shape[0]} nodes, "
          f"{ws.num_leaves} leaves, stack_need {ws.stack_need}, stream "
          f"flags {ws.stream_leaves}/{ws.stream_nodes}, build {build_s} s",
          flush=True)

    # ---- the pallas path's own run: counts reset just before, read after
    wide_cast_cuda.launches = 0
    cluster_cast_cuda.launches = 0
    hits, stats = scene.cast_rays(rays)
    occ = scene.any_hit_rays(rays)
    torch.cuda.synchronize()
    launches = wide_cast_cuda.launches
    check(launches > 0, "pallas path launched kernel B4")
    check(cluster_cast_cuda.launches == 0, "pallas path did not launch B1")
    check(int(stats.stack_drops) == 0, "pallas 1080p: stack_drops == 0")
    check(bool(torch.isfinite(hits.t).all()), "pallas 1080p: finite t")
    check(torch.equal(occ, hits.hit), "any-hit occluded == closest hit")
    print(f"[{card}] pallas 1080p: hit_rate {float(hits.hit.float().mean())}"
          f", stack_drops {int(stats.stack_drops)}, tri_tests/ray "
          f"{int(stats.tri_tests) / n}, pops/ray "
          f"{int(stats.bvh_nodes_visited) / n}; B4 launches {launches}, B1 "
          f"launches {cluster_cast_cuda.launches}", flush=True)
    ok = parity(scene.cast_rays(sub)[0], hb)
    print(f"[{card}] parity pallas (8-wide) vs brute (4096 rays): {ok}",
          flush=True)
    check(ok, "pallas parity vs brute")
    check(torch.equal(scene.any_hit_rays(sub), hb.hit),
          "pallas any-hit vs brute")

    # ---- timing: the cast entry point, then B4 alone and its plain
    # version on the whole 8-wide frame, closest hit and any hit, with the
    # lane occupancy of its node and leaf phases; the summary keeps the
    # closest hit's times and bound and the larger error
    dt = cuda_ms(lambda: scene.cast_rays(rays), 5)
    print(f"[{card}] pallas cast 1080p: {dt} ms/frame, {n / dt / 1e3} "
          f"Mrays/s", flush=True)
    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, ws)
    k = {"launches": launches, "max_abs_err": 0.0, "library_ms": None}
    for name, kw in (("closest hit", {}), ("any hit", {"any_hit": True})):
        ms = cuda_ms(lambda: wide_cast_cuda(*args, **kw), 5)
        err, plain_ms, out, st = compare_wide_plain(rays, ws, chunk=1 << 20,
                                                    **kw)
        bms, by = wide_bound(ws, rays, *out)
        print(f"[{card}] kernel B4 8-wide frame, {name}: kernel {ms} ms, "
              f"plain {plain_ms} ms, bound {bms} ms ({by}), kernel == "
              f"plain, max_abs_err {err}; lane occupancy node/leaf "
              f"{wide_occupancy(st)}, cooperative share {coop_share(st)}, "
              f"warp stats {st}", flush=True)
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if not kw:
            k.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)

    # ---- the binary and quantized layouts at the same scene
    ws2 = build_wide_scene(scene.bvh, scene.tris, device=device)
    part = rays.take(torch.arange(min(SLICE, n), device=device))
    for name, w, kw in (("binary", ws2, {}), ("quantized", ws,
                                              {"quantized": True})):
        hs, _, _ = cast_rays_wide(sub, w,
                                  columnar="q" if kw else None)
        ok = parity(hs, hb)
        print(f"[{card}] parity pallas ({name}) vs brute (4096 rays): {ok}",
              flush=True)
        check(ok, f"pallas {name} parity vs brute")
        a2 = (rays.origin, rays.direction, rays.t_min, rays.t_max, w)
        ms2 = cuda_ms(lambda: wide_cast_cuda(*a2, **kw), 5)
        st = torch.zeros(5, dtype=torch.int64, device=device)
        fo, io, co = wide_cast_cuda(*a2, warp_stats=st, **kw)
        check(int(co[1]) == 0, f"{name} frame stack_drops == 0")
        bms2, by2 = wide_bound(w, rays, fo, io, co, **kw)
        st = [int(x) for x in st.tolist()]
        err2, plain2, _, _ = compare_wide_plain(part, w, **kw)
        k["max_abs_err"] = max(k["max_abs_err"], err2)
        print(f"[{card}] kernel B4 {name} frame: kernel {ms2} ms, bound "
              f"{bms2} ms ({by2}), tri_tests/ray "
              f"{int(io[1].sum(dtype=torch.int64)) / n}, pops/ray "
              f"{int(co[0]) / n}, stack_need {w.stack_need}; lane "
              f"occupancy node/leaf {wide_occupancy(st)}, cooperative "
              f"share {coop_share(st)}; kernel == plain "
              f"on {SLICE} rays (plain {plain2} ms), max_abs_err {err2}",
              flush=True)

    # ---- B3: the v1 cluster entry points run on B1
    flat, tlas = ctx["flat"], ctx["tlas"]
    cluster_cast_cuda.launches = 0
    h1, s1, _ = cast_rays_cluster(rays, flat.cluster)
    hi1, _, _, ii1 = cast_rays_cluster_tlas(rays, tlas._ctlas)
    torch.cuda.synchronize()
    b3 = cluster_cast_cuda.launches
    check(b3 == 2, "B3 entry points launched B1")
    h2, s2, _ = cast_rays_cluster_v2(rays, flat.cluster)
    hi2, _, _, ii2 = cast_rays_cluster_tlas_v2(rays, tlas._ctlas)
    check(torch.equal(h1.t, h2.t) and torch.equal(h1.prim_id, h2.prim_id)
          and int(s1.tri_tests) == int(s2.tri_tests),
          "cast_rays_cluster == cast_rays_cluster_v2")
    check(torch.equal(hi1.t, hi2.t) and torch.equal(ii1, ii2),
          "cast_rays_cluster_tlas == cast_rays_cluster_tlas_v2")
    print(f"[{card}] B3 entry points: B1 launches {b3}, hits == v2's",
          flush=True)
    return k


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    # fails here, before printing anything, outside a checkout of the repo
    import messyerraytracer_tpu_torch  # noqa: F401

    t_start = time.time()
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    device = torch.device("cuda", 0)
    build_kernels(card)
    phase_kernel_vs_plain(card, device)
    k1, ctx = phase_main_path(card, device)
    phase_wide_vs_plain(card, device)
    k4 = phase_pallas_path(card, device, ctx)
    print(f"[{card}] chip_smoke total {time.time() - t_start} s",
          flush=True)
    src = "messyerraytracer_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [
        {"name": "cluster_cast (postponed cluster visits, warp-cooperative "
                 "triangle tests)", "route": "cuda",
         "source": src + "cluster_cast.cu",
         "replaces": "messyerraytracer_tpu/kernels/cluster_v2.py:81 "
                     "(+ messyerraytracer_tpu/kernels/cluster.py:1262, "
                     "fused; messyerraytracer_tpu/kernels/cluster.py:564's "
                     "entry points)",
         **k1},
        {"name": "wide_cast (postponed leaf visits, 16-byte loads, "
                 "register cap)", "route": "cuda",
         "source": src + "wide_cast.cu",
         "replaces": "messyerraytracer_tpu/kernels/traverse_pallas.py:555 "
                     "(+ messyerraytracer_tpu/kernels/traverse_pallas.py:87"
                     "'s streamed casts)",
         **k4}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
