"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
the port still builds and runs its main paths on the GPU.

    python3 chip_smoke.py

Builds the kernels from the checkout, each with its own nvcc started at
the same time (B1: kernels/csrc/cluster_cast.cu, B4: kernels/csrc/
wide_cast.cu, the refit kernel: kernels/csrc/tlas_refit.cu, the camera
kernel: kernels/csrc/camera_rays.cu, the sort key kernel M1:
kernels/csrc/morton_keys.cu; nvcc -> ctypes), then:

  1. holds kernel B1 against its plain PyTorch version on the card, bit
     for bit with every counter, on test-sized flat and instanced scenes
     (closest hit, any hit, a layer mask, dead and zero-direction rays, a
     forced small stack, coherent grid rays, sparse warps, a scene of
     duplicated triangles), and reads B1's warp stats to show which mode
     of its cluster phase each case took; then (1b) holds the camera
     kernel against its plain version, on the card and on the CPU, bit
     for bit on both primary cells' frames (1920x1080 and 1024x768), and
     times it over CAMERA_ITERS launches beside its bound and the plain
     version's time; (1c) holds the sort key kernel M1 against its plain
     version on the card, bit for bit, for each key kind at the service
     batch's and the path-traced wave's sizes, and times it alone over
     MORTON_ITERS launches beside its bound, its wrapper, the plain
     version and the stable sort of int32 against int64 keys;
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
     cluster entry points (B3) on B1;
  5. serving and rendering at full size: (a) a ``RayTracerService`` over
     the headline meshes and instances answers 524,288 random rays
     through the Morton-sorting dispatcher on B1, closest and any hit,
     sorted and unsorted (bit-equal), with parity against brute, then
     ``RayDispatcher`` on phase 4's pallas scene (B4, sorted ==
     unsorted); (b) ``RayRenderer`` over ``SceneTLAS.instanced_scene()``
     at 1920x1080 — COLOR with two lights and shadows over 2 accumulated
     frames, then NORMAL, DEPTH, PRIM_ID and HIT_MASK (HIT_MASK == the
     instanced cast's hit); (c) the wavefront path tracer, 3 bounces at
     1920x1080 on the instanced and the flat scene (carried sort within
     1e-4 of the uncarried frame); (d) camera rays, and the test-sized
     scenes rendered and path-traced, on the card and on the CPU (the
     plain versions): rays, integer AOVs and PCG32 streams equal, floats
     within the tests' tolerances.  Each path's B1 / B4 launches are
     counted from its own run; each kernel is held bit for bit against
     its plain version on the inputs these paths give it (the sorted
     service batch, closest and any hit; the renderer's shadow wave; the
     path tracers' shadow and extend waves with their dead rays); one
     call of each path is profiled (torch.profiler) and its device time
     split by the port's ``record_function`` ranges;
  6. dynamic scenes, debug draw modes and checkpoints at full size, over
     phase 2's headline TLAS and phase 4's pallas scene: (a) 100 instances
     move through ``SceneTLAS.set_transform`` (timed, wall and device),
     the 1080p frame is cast through the moved instanced tables, checked
     against brute over the moved world and B1 held against its plain
     version on a slice; (b) ``refit_tlas`` of the 1M flat twin, timed
     beside the twin's build, its cast against the instanced one and its
     tables bit for bit against the same refit on the CPU; (c) the
     pallas scene's terrain displaced through ``RayScene.refit``, B4 held
     against its plain version, parity with brute; (d) the service's
     ``set_transform`` and ``refit``, then 524,288 random rays sorted ==
     unsorted; (e) ``cast_debug_rays`` in all 7 modes on a 1920x1080 grid
     over the refit twin, the heatmap's counts against the plain
     version's, ``bvh_wireframe`` timed; (f) ``save_scene`` /
     ``load_scene`` of the twin, timed, the loaded frame equal to the
     saved one's.  Each part's B1 / B4 launches are counted from its own
     run and added to the kernels line;
  7. the frontier backends, the two-level casts and the multi-device
     casts at full size: (a) ``backend="frontier"`` and ``"frontier_q"``
     on phase 2's flat twin at 1080p (timed, peak memory, per-ray
     counters beside B1's and B4's, parity with brute and bit equality
     where the prims agree, prims against B4's frame); (b)
     ``cast_rays_two_level_fast`` on the instanced headline scene at
     1080p and ``cast_rays_two_level`` (one B1 cast per instance) on
     65,536 rays, each against the instanced cast (off ties only cracks
     at an edge), table bytes; (c) ``cast_rays_sharded`` on meshes of 1
     and 4 entries of the card, bit-equal to the single cast on B1 and
     B4, ``cast_rays_scene_sharded`` with 4 shards of the 1M scene
     (parity with brute and with the unsharded pallas frame),
     ``render_step_sharded`` at 1080p and ``dryrun_multichip(4)``; (d)
     frontier, frontier_q and the two-level fast cast on the card against
     the CPU, bit for bit; (e) only where more than one card is visible,
     the paths of (c) on ``make_mesh()``, one shard a card, bit-equal to
     the same mesh size on one card and timed beside it.  The frontier and two-level fast paths launch
     neither kernel (checked); the other paths' launches are counted from
     their own runs;
  8. the demo gallery (``messyerraytracer_tpu_torch/demos/run_demos.py``,
     the 11 demos of the JAX package's demos/run_demos.py) on the card at
     the demos' own sizes (320x240 frames, the 64x48 debug grid, the
     192x144 path-traced Cornell box at 4 spp x 3 bounces): each demo
     through ``run_demo`` with its wall ms, B1 launches and HUD line,
     and its images and HUD numbers held against the same demo on the
     CPU (integers exact, floats within rtol 1e-5, images by
     ``IMAGE_RULE``); B1 held bit for bit against its plain version on
     the layer demo's two masked casts and on a bounce wave of the
     Cornell box with its dead rays;
  9. the port's headline benchmark (``messyerraytracer_tpu_torch/
     bench.py``, the JAX package's bench.py on the port) at full size:
     ``bench.run`` prints bench.py's JSON line from the card (the 1M
     instanced headline and its flat twin at 1920x1080, the 99K and 2M
     flat tiers at 1024x768, 524,288 incoherent rays, 640x480 path-traced
     frames), checked: every parity flag true, no stack drop at 2M, 215
     instances and 1,000,736 world triangles, bench.py's keys less the
     TPU-only ones; B1's launches counted from that run; B1 held bit for
     bit against its plain version on the 99K frame, and the 99K
     path-traced frame's wave rays equal with B1 and with its plain
     version.

The camera kernel's launches are counted, as B1's are, from the main
paths' own runs (the frames of phases 2, 5, 7, 8 and 9; phase 1b's
checks and timing are left out), and their sum goes to the kernel
summary.  Every number is printed beside the card's name and power
limit.  The last two lines are the kernel summary and the result, both
JSON.  Exits
non-zero, printing no result, when there is no CUDA card or any check
fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import sys
import threading
import time

import numpy as np

# fails here, printing nothing, outside a checkout of the repo
from messyerraytracer_tpu_torch.bench import (
    block_swizzled_frame_rays,
    card_name_and_power,
    headline_camera,
    headline_tlas,
)
from messyerraytracer_tpu_torch.kernels import (
    camera_rays,
    cluster_tlas,
    cluster_v2,
    morton_keys,
    traverse_pallas,
)

# each kernel's library; its ``launches`` counts the kernel's launches
B1, B4 = cluster_v2.cuda_library, traverse_pallas.cuda_library
R1, C1 = cluster_tlas.cuda_library, camera_rays.cuda_library
M1 = morton_keys.cuda_library

FRAME = (1920, 1080)
SLICE = 262_144        # rays of the frame held kernel == plain per layout
HEADLINE_INSTANCES = 215
HEADLINE_WORLD_TRIS = 1_000_736

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
    """Build the five kernel libraries, one nvcc each, started together."""
    t0 = time.time()
    errors = []

    def build(mod):
        try:
            mod.cuda_library()
        except Exception as e:      # re-raised below, in the main thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(m,))
               for m in (cluster_v2, traverse_pallas, cluster_tlas,
                         camera_rays, morton_keys)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"[{card}] kernel build {time.time() - t0} s ({len(threads)} "
          f"nvcc in parallel)", flush=True)


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
    before = B1.launches
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
    check(B1.launches > before, "kernel launch count rose")
    print(f"[{card}] phase 1 ok: worst max_abs_err {worst}; tie scene: "
          f"{prim.numel()} hits, all on the lower copy", flush=True)


CAMERA_ITERS = 2000       # launches of the camera kernel timed together
CAMERA_BYTES_PER_RAY = 32  # origin 12, direction 12, t_min 4, t_max 4


def phase_camera(card: str, device) -> dict:
    """Phase 1b: the camera kernel against its plain version on the primary
    cells' frames, bit for bit, with the cells' jitter (0.5) and a Halton
    one: the kernel's rays (one launch a call) equal the plain version's
    on the card and on the CPU.  Then timed, each fenced by CUDA events:
    the kernel alone (its C entry on outputs allocated once) and
    ``generate_rays`` (wrapper and allocation) over CAMERA_ITERS launches,
    the plain version on the card over 20 calls.  The bound is the bytes
    the frame's rays take, written once.  Returns {frame: (kernel ms,
    call ms, plain ms, bound ms)}."""
    import torch

    import messyerraytracer_tpu_torch as mrt
    from messyerraytracer_tpu_torch.bench import camera_99k
    from messyerraytracer_tpu_torch.kernels import camera_rays as kcam
    from messyerraytracer_tpu_torch.render import camera as rcam
    from messyerraytracer_tpu_torch.render.renderer import halton

    cpu, out = torch.device("cpu"), {}
    fields = ("origin", "direction", "t_min", "t_max")
    for name, cam, w, h in (("1920x1080", headline_camera(), 1920, 1080),
                            ("1024x768", camera_99k(), 1024, 768)):
        for jit in ((0.5, 0.5), (halton(1, 2), halton(1, 3))):
            before = C1.launches
            a = mrt.generate_rays(cam, w, h, jitter=jit, device=device)
            check(C1.launches == before + 1,
                  f"camera {name}: one launch a call")
            for dev in (device, cpu):
                b = rcam._generate_rays(cam, w, h, jit, dev)
                check(all(torch.equal(getattr(a, f).cpu(),
                                      getattr(b, f).cpu()) for f in fields),
                      f"camera kernel {name} jitter {jit} == plain on "
                      f"{dev.type} bit for bit")
        n = w * h
        outs = tuple(torch.empty(s, dtype=torch.float32, device=device)
                     for s in ((n, 3), (n, 3), (n,), (n,)))
        args = kcam.kernel_args(w, h, False, cam.origin, cam.basis,
                                (0.5, 0.5), rcam._plane_scales(cam, w, h),
                                outs)
        lib = kcam.cuda_library()
        stream = torch.cuda.current_stream().cuda_stream
        kernel_ms = cuda_ms(lambda: lib.mrt_camera_rays(*args, stream),
                            CAMERA_ITERS)
        call_ms = cuda_ms(lambda: mrt.generate_rays(cam, w, h,
                                                    device=device),
                          CAMERA_ITERS)
        plain_ms = cuda_ms(lambda: rcam._generate_rays(
            cam, w, h, (0.5, 0.5), device), 20)
        written = CAMERA_BYTES_PER_RAY * n
        bound_ms, what = bound(written, 0)
        out[name] = (kernel_ms, call_ms, plain_ms, bound_ms)
        print(f"[{card}] phase 1b camera {name}: kernel == plain (card and "
              f"CPU) bit for bit; alone {kernel_ms} ms a launch, "
              f"generate_rays {call_ms} ms a call (CUDA events over "
              f"{CAMERA_ITERS}); bound {bound_ms} ms ({written} bytes, "
              f"{what}), alone at {100.0 * bound_ms / kernel_ms}% of it; "
              f"plain version {plain_ms} ms", flush=True)
    return out


MORTON_ITERS = 2000        # launches of the sort key kernel timed together
MORTON_BYTES_PER_RAY = 28  # origin 12 and direction 12 read, a key 4 written
MORTON_RAYS = (("service batch", 524_288), ("path-traced wave", 307_200))


def phase_morton(card: str, device) -> dict:
    """Phase 1c: the sort key kernel M1 against its plain version on the
    card, bit for bit, for every key kind (octant-major at dir_bits 1 and
    9, origin-major, direction), with and without live flags, on random
    rays with dead and zero-direction rows at the service batch's and the
    path-traced wave's sizes; one launch a call.  Then timed, each fenced
    by CUDA events: the kernel alone (its C entry on a key tensor
    allocated once) and ``sort_keys_6d`` (wrapper and allocation) over
    MORTON_ITERS launches, the plain version over 20 calls, and the
    stable sort of the int32 keys and of the same keys in int64 over 200.
    The bound is the bytes a ray's key reads and writes, once.  Returns
    {rays: (kernel ms, call ms, plain ms, bound ms, int32 sort ms, int64
    sort ms)}."""
    import torch

    from messyerraytracer_tpu_torch.dispatch import morton as pm

    km, out = morton_keys, {}
    for name, n in MORTON_RAYS:
        rays = random_rays(n, 31 + n, 40.0, device)
        lo = torch.tensor([-30.0, 0.0, -30.0], device=device)
        hi = torch.tensor([30.0, 5.0, 30.0], device=device)
        live = rays.t_max > rays.t_min
        for kind, b in ((km.OCTANT_MAJOR, 1), (km.OCTANT_MAJOR, 9),
                        (km.ORIGIN_MAJOR, 1), (km.DIRECTION, 1)):
            for flags in (None, live):
                before = M1.launches
                got = km.morton_keys_cuda(rays.origin, rays.direction, lo,
                                          hi, kind, b, flags)
                check(M1.launches == before + 1, f"M1 {name}: one launch")
                if kind == km.DIRECTION:
                    want = pm._ray_direction_morton(rays.direction)
                else:
                    want = pm._keys_6d(rays, lo, hi,
                                       kind == km.OCTANT_MAJOR, b)
                if flags is not None:
                    want = torch.where(flags, want,
                                       torch.full_like(want, pm.DEAD_KEY))
                check(torch.equal(got, want.to(torch.int32)),
                      f"M1 {name} kind {kind} dir_bits {b} live "
                      f"{flags is not None} == plain bit for bit")
        keys = torch.empty((n,), dtype=torch.int32, device=device)
        args = [n, km.OCTANT_MAJOR, 1, rays.origin.data_ptr(),
                rays.direction.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                None, keys.data_ptr()]
        lib = M1()
        stream = torch.cuda.current_stream().cuda_stream
        kernel_ms = cuda_ms(lambda: lib.mrt_morton_keys(*args, stream),
                            MORTON_ITERS)
        call_ms = cuda_ms(lambda: pm.sort_keys_6d(rays, lo, hi),
                          MORTON_ITERS)
        plain_ms = cuda_ms(lambda: pm._keys_6d(rays, lo, hi), 20)
        wide = keys.to(torch.int64)
        sort32_ms = cuda_ms(lambda: torch.sort(keys, stable=True), 200)
        sort64_ms = cuda_ms(lambda: torch.sort(wide, stable=True), 200)
        moved = MORTON_BYTES_PER_RAY * n
        bound_ms, what = bound(moved, 0)
        out[name] = (kernel_ms, call_ms, plain_ms, bound_ms, sort32_ms,
                     sort64_ms)
        print(f"[{card}] phase 1c M1 {name} ({n} rays): kernel == plain "
              f"bit for bit (4 kinds, live and not); alone {kernel_ms} ms "
              f"a launch, sort_keys_6d {call_ms} ms a call (CUDA events "
              f"over {MORTON_ITERS}); bound {bound_ms} ms ({moved} bytes, "
              f"{what}), alone at {100.0 * bound_ms / kernel_ms}% of it; "
              f"plain version {plain_ms} ms; stable sort int32 {sort32_ms} "
              f"ms, int64 {sort64_ms} ms", flush=True)
    return out


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
    reset_camera()
    rays = block_swizzled_frame_rays(*FRAME, headline_camera(), device)
    check(read_camera("main path") == 1, "main path's frame: one launch of "
          "the camera kernel")
    n = rays.count
    print(f"[{card}] scene: {len(tlas.instances)} instances, "
          f"{world_tris.shape[0]} world triangles, {n} rays; build s "
          f"{json.dumps(times)}", flush=True)
    check((len(tlas.instances), world_tris.shape[0])
          == (HEADLINE_INSTANCES, HEADLINE_WORLD_TRIS), "the headline scene")

    # ---- the main path's own run: counts reset just before, read after
    B1.launches = 0
    hi, si, _, inst = tlas.cast_rays_instanced(rays)
    hf, sf = flat.cast_rays(rays)
    torch.cuda.synchronize()
    launches = B1.launches
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
           "tlas": tlas, "flat": flat, "instanced_ms": dt_i}
    return k, ctx


def phase_wide_vs_plain(card: str, device) -> None:
    """Phase 3: kernel B4 against its plain version on the card, bit for
    bit, with the lane occupancy of its node and leaf phases: random rays
    (closest, any hit, a layer mask, a forced small stack, quantized
    nodes), coherent grid rays, sparse warps (28 of every 32 rays dead)
    and a scene of duplicated triangles (ties the lower slot must win)."""
    import torch

    from messyerraytracer_tpu_torch.kernels.traverse_pallas import (
        cast_rays_wide)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    tris, layers = small_flat_tris()
    rays = random_rays(8192, 2, 8.0, device)
    extra = (("coherent grid", grid_rays((1, 3, 6), (3, 0, 3), 8.0, device),
              1),
             ("sparse warps", random_rays(8192, 3, 8.0, device,
                                          live_per_warp=4), 1),
             ("tie scene", random_rays(8192, 4, 8.0, device), 2))
    before = B4.launches
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
        n0 = B4.launches
        hs, ss, _ = cast_rays_wide(rays, ws, stream_leaves=True,
                                   stream_nodes=True)
        torch.cuda.synchronize()
        check(B4.launches == n0 + 1, "streamed cast launched B4")
        check(torch.equal(hs.t, closest[0][0])
              and torch.equal(hs.prim_id >= 0, closest[1][0] >= 0),
              "streamed cast == closest-hit kernel (== plain)")
        check(int(ss.stack_drops) == 0, "streamed cast stack_drops == 0")
        print(f"[{card}] phase 3 branching {branching} streamed "
              f"(stream_leaves, stream_nodes): == kernel == plain",
              flush=True)
    check(B4.launches > before, "B4 launch count rose")
    print(f"[{card}] phase 3 ok: worst max_abs_err {worst}", flush=True)


def phase_pallas_path(card: str, device, ctx: dict) -> dict:
    """Phase 4: the pallas path at full size, and B3's entry points."""
    import torch

    from messyerraytracer_tpu_torch.core.brute import parity
    from messyerraytracer_tpu_torch.kernels.cluster import cast_rays_cluster
    from messyerraytracer_tpu_torch.kernels.cluster_tlas import (
        cast_rays_cluster_tlas)
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        cast_rays_cluster_tlas_v2, cast_rays_cluster_v2)
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
    ctx["pallas"] = scene
    print(f"[{card}] pallas scene (8-wide): {ws.node_child.shape[0]} nodes, "
          f"{ws.num_leaves} leaves, stack_need {ws.stack_need}, stream "
          f"flags {ws.stream_leaves}/{ws.stream_nodes}, build {build_s} s",
          flush=True)

    # ---- the pallas path's own run: counts reset just before, read after
    B4.launches = 0
    B1.launches = 0
    hits, stats = scene.cast_rays(rays)
    occ = scene.any_hit_rays(rays)
    torch.cuda.synchronize()
    launches = B4.launches
    check(launches > 0, "pallas path launched kernel B4")
    check(B1.launches == 0, "pallas path did not launch B1")
    check(int(stats.stack_drops) == 0, "pallas 1080p: stack_drops == 0")
    check(bool(torch.isfinite(hits.t).all()), "pallas 1080p: finite t")
    check(torch.equal(occ, hits.hit), "any-hit occluded == closest hit")
    print(f"[{card}] pallas 1080p: hit_rate {float(hits.hit.float().mean())}"
          f", stack_drops {int(stats.stack_drops)}, tri_tests/ray "
          f"{int(stats.tri_tests) / n}, pops/ray "
          f"{int(stats.bvh_nodes_visited) / n}; B4 launches {launches}, B1 "
          f"launches {B1.launches}", flush=True)
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
    B1.launches = 0
    h1, s1, _ = cast_rays_cluster(rays, flat.cluster)
    hi1, _, _, ii1 = cast_rays_cluster_tlas(rays, tlas._ctlas)
    torch.cuda.synchronize()
    b3 = B1.launches
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


# ---------------------------------------------------------------------------
# phase 5: serving and rendering
# ---------------------------------------------------------------------------

INCOHERENT = 512 * 1024     # random rays of the service batch (bench.py)
SMALL_FRAME = (64, 48)      # card against CPU
HIT_FIELDS = ("t", "position", "normal", "u", "v", "prim_id", "hit_layers")
# the port's torch.profiler ranges (device_split reads them)
PORT_RANGES = ("cast", "morton.key", "morton.sort", "morton.gather",
               "morton.unshuffle", "wavefront.take", "render.raygen",
               "render.trace", "render.shadows", "render.shade",
               "refit.set_transforms", "refit.tlas", "refit.scene")


# Random rays start anywhere in the scene, many next to a surface.  B1's t
# goes through ray and triangle coordinates relative to the cluster anchor,
# so its absolute error is a few ulps of the scene's coordinates, not of t:
# a hit at t << 1 can miss rtol 1e-5 against the brute oracle's classic
# Moller-Trumbore (measured on the headline scene: 3 of 4096 rays, by up to
# 5.6e-6 at t = 0.023, coordinates up to 40).  Such batches add ANCHOR_ULPS
# ulps of the scene's largest coordinate to t's tolerance.
ANCHOR_ULPS = 8


def anchor_atol(scene) -> float:
    lo, hi = (b.cpu().numpy() for b in (scene.bvh.aabb_min[0],
                                         scene.bvh.aabb_max[0]))
    big = max(np.abs(lo).max(), np.abs(hi).max())
    return float(ANCHOR_ULPS * np.finfo(np.float32).eps * big)


def device_split(fn, ranges) -> dict:
    """One more call of ``fn`` (after a warm-up) under torch.profiler.
    Returns ms: the call's wall time (CUDA events, under the profiler), the
    device's busy time (the union of its kernels and copies) and idle share,
    the kernels B1 and B4 by name (each launch, in launch order), for each
    ``torch.profiler`` range named in ``ranges`` the device time of the
    kernels launched inside it (B1 and B4 included: the profiler links each
    launch to the port's span around it, ``b1.launch`` or ``b4.launch``),
    and the rest of the busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    events = prof.events()
    on_device = sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in events
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.name not in PORT_RANGES)
    busy, reach = 0.0, float("-inf")
    for a, b, _ in on_device:          # union of the device intervals, us
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    wall = start.elapsed_time(end)
    split = {"wall": wall, "device busy": busy / 1e3,
             "idle share": 1.0 - busy / 1e3 / wall,
             "device events": len(on_device)}
    launches = [((b - a) / 1e3, label) for a, b, name in on_device
                for label, kernel in (("B1", "cluster_cast_kernel"),
                                      ("B4", "wide_cast_kernel"),
                                      ("refit", "tlas_refit_kernel"))
                if kernel in name]
    for label in ("B1", "B4", "refit"):
        split[f"{label} launches"] = [ms for ms, k in launches if k == label]
        split[f"{label} kernel"] = sum(split[f"{label} launches"])
    for name in ranges:
        split[name] = sum(e.device_time_total for e in events
                          if e.name == name
                          and e.device_type == DeviceType.CPU) / 1e3
    split["rest"] = split["device busy"] - sum(split[n] for n in ranges)
    return split


def take_hits(hits, idx):
    from messyerraytracer_tpu_torch.core.types import Hits

    return Hits(*(getattr(hits, f)[idx] for f in HIT_FIELDS))


def same_hits(a, b) -> bool:
    import torch

    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in HIT_FIELDS)


def headline_service(tlas, device):
    """A RayTracerService over the headline meshes and instances, in the
    headline's instance order (so the same flattened numbering)."""
    from messyerraytracer_tpu_torch.api.service import RayTracerService

    svc = RayTracerService(device=device)
    blas = {}
    for inst in tlas.instances:
        if inst.blas_id in blas:
            svc.add_instance(blas[inst.blas_id], inst.transform, inst.layers)
        else:
            svc.register_mesh(tlas.meshes[inst.blas_id].tri_array,
                              inst.transform, inst.layers)
            blas[inst.blas_id] = len(svc.tlas.meshes) - 1
    return svc


def shading(device):
    """Two lights (a sun and a point light over the terrain), the default
    sky and material."""
    from messyerraytracer_tpu_torch.render.shade import (
        default_materials, make_environment, make_lights)

    lights = make_lights([
        {"type": 0, "direction": (-0.4, 1.0, -0.2), "energy": 1.5},
        {"type": 1, "position": (5.0, 12.0, 10.0), "energy": 400.0,
         "range": 60.0}], device=device)
    return lights, make_environment(device=device), default_materials(device)


def service_rays(scene, device):
    """INCOHERENT random rays from a seed: origins uniform in the scene's
    root box, directions uniform."""
    from messyerraytracer_tpu_torch.core.types import make_rays

    lo, hi = (b.cpu().numpy() for b in (scene.bvh.aabb_min[0],
                                         scene.bvh.aabb_max[0]))
    rng = np.random.default_rng(3)
    o = rng.uniform(lo, hi, (INCOHERENT, 3)).astype(np.float32)
    d = rng.standard_normal((INCOHERENT, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return make_rays(o, d, device=device)


def phase_service(card: str, device, ctx: dict) -> dict:
    """Phase 5a: RayTracerService on the headline scene — 524,288 random
    rays through the Morton-sorting dispatcher onto B1, sorted against
    unsorted, closest and any hit; then RayDispatcher on phase 4's 8-wide
    pallas scene onto B4.  Each kernel is held against its plain version on
    the sorted batch the dispatcher gives it."""
    import torch

    from messyerraytracer_tpu_torch.api.service import (
        MODE_ANY_HIT, MODE_NEAREST, RayQuery)
    from messyerraytracer_tpu_torch.core.brute import cast_rays_brute, parity
    from messyerraytracer_tpu_torch.dispatch.dispatcher import RayDispatcher
    from messyerraytracer_tpu_torch.dispatch.morton import sort_rays_6d

    t0 = time.time()
    svc = headline_service(ctx["tlas"], device)
    svc.build()
    ctx["svc"] = svc
    scene = svc.scene
    check(torch.equal(scene.tris.v0, ctx["flat"].tris.v0)
          and torch.equal(scene.tris.prim_id, ctx["flat"].tris.prim_id),
          "service scene == phase 2's flat twin")
    print(f"[{card}] phase 5a service build {time.time() - t0} s: "
          f"{len(svc.tlas.instances)} instances, {scene.num_tris} "
          f"triangles, backend {svc.get_backend()}", flush=True)
    rays = service_rays(scene, device)
    n = rays.count

    # ---- the service path's own run: counts reset just before, read after
    B1.launches = 0
    B4.launches = 0
    res = {(mode, coherent): svc.submit(RayQuery(rays, mode=mode,
                                                 coherent=coherent))
           for mode in (MODE_NEAREST, MODE_ANY_HIT)
           for coherent in (False, True)}
    torch.cuda.synchronize()
    b1 = B1.launches
    check(b1 == 4 and B4.launches == 0,
          f"service: one B1 launch per submit (B1 {b1}, B4 "
          f"{B4.launches})")
    hs, ss = res[MODE_NEAREST, False].hits, res[MODE_NEAREST, False].stats
    hu, su = res[MODE_NEAREST, True].hits, res[MODE_NEAREST, True].stats
    check(same_hits(hs, hu), "B1: sorted == unsorted, every field")
    occ_s = res[MODE_ANY_HIT, False].hit_flags
    check(torch.equal(occ_s, res[MODE_ANY_HIT, True].hit_flags),
          "B1 any hit: sorted == unsorted")
    check(torch.equal(occ_s, hs.hit), "any hit == closest hit's hit")
    check(int(ss.stack_drops) == 0 and int(su.stack_drops) == 0,
          "service: stack_drops == 0")
    idx = torch.arange(4096, device=device) * (n // 4096)
    hb, _ = cast_rays_brute(rays.take(idx), scene.tris, chunk=8192)
    atol = anchor_atol(scene)
    ok = parity(take_hits(hs, idx), hb, atol=atol)
    check(ok, f"service parity vs brute (t atol {atol})")
    print(f"[{card}] phase 5a service 512K random rays: B1 launches {b1}; "
          f"sorted == unsorted bit for bit (closest and any hit); parity vs "
          f"brute (4096 rays, t atol {atol}) {ok}; stack_drops 0; hit_rate "
          f"{float(hs.hit.float().mean())}; tri_tests/ray sorted "
          f"{int(ss.tri_tests) / n}, unsorted {int(su.tri_tests) / n}; "
          f"pops/ray sorted {int(ss.bvh_nodes_visited) / n}, unsorted "
          f"{int(su.bvh_nodes_visited) / n}", flush=True)

    # ---- B1 against its plain version on the dispatcher's sorted batch
    srt, _ = sort_rays_6d(rays, scene.bvh.aabb_min[0], scene.bvh.aabb_max[0])
    for kw in ({}, {"any_hit": True}):
        err, plain_ms, st = compare_kernel_plain(srt, scene.cluster,
                                                 chunk=1 << 20, **kw)
        print(f"[{card}] phase 5a B1 on the service's sorted batch "
              f"{kw or 'closest'}: kernel == plain, max_abs_err {err}, "
              f"plain {plain_ms} ms; lane occupancy {occupancy(st)}",
              flush=True)

    # ---- one profiled submit split by stage; submit times, CUDA events
    split = device_split(lambda: svc.submit(RayQuery(rays)), (
        "morton.key", "morton.sort", "morton.gather", "cast",
        "morton.unshuffle"))
    sub_s = cuda_ms(lambda: svc.submit(RayQuery(rays)), 5)
    sub_u = cuda_ms(lambda: svc.submit(RayQuery(rays, coherent=True)), 5)
    print(f"[{card}] phase 5a one sorted submit by stage (device ms, "
          f"torch.profiler) {json.dumps(split)}; submit sorted {sub_s} ms ("
          f"{n / sub_s / 1e3} Mrays/s), unsorted {sub_u} ms "
          f"({n / sub_u / 1e3} Mrays/s)", flush=True)

    # ---- the dispatcher on phase 4's 8-wide pallas scene, kernel B4
    pallas = ctx["pallas"]
    pd = RayDispatcher(pallas)
    B4.launches = 0
    hp_s, sp_s = pd.cast_rays(rays)
    hp_u, sp_u = pd.cast_rays(rays, coherent=True)
    op_s = pd.any_hit_rays(rays)
    op_u = pd.any_hit_rays(rays, coherent=True)
    torch.cuda.synchronize()
    b4 = B4.launches
    check(b4 == 4, f"dispatcher on pallas: one B4 launch per cast ({b4})")
    check(same_hits(hp_s, hp_u), "B4: sorted == unsorted, every field")
    check(torch.equal(op_s, op_u) and torch.equal(op_s, hp_s.hit),
          "B4 any hit: sorted == unsorted == closest hit's hit")
    check(int(sp_s.stack_drops) == 0, "pallas dispatcher: stack_drops == 0")
    ok4 = parity(take_hits(hp_s, idx), hb)
    check(ok4, "pallas dispatcher parity vs brute")
    psrt, _ = sort_rays_6d(rays, pallas.bvh.aabb_min[0],
                           pallas.bvh.aabb_max[0])
    for kw in ({}, {"any_hit": True}):
        err, plain_ms, _, st = compare_wide_plain(psrt, pallas.wide,
                                                  chunk=1 << 20, **kw)
        print(f"[{card}] phase 5a B4 on the dispatcher's sorted batch "
              f"{kw or 'closest'}: kernel == plain, max_abs_err {err}, "
              f"plain {plain_ms} ms; lane occupancy node/leaf "
              f"{wide_occupancy(st)}", flush=True)
    ms_s = cuda_ms(lambda: pd.cast_rays(rays), 5)
    ms_u = cuda_ms(lambda: pd.cast_rays(rays, coherent=True), 5)
    cast_s = cuda_ms(lambda: pallas.cast_rays(psrt), 5)
    print(f"[{card}] phase 5a dispatcher on pallas (8-wide): B4 launches "
          f"{b4}; sorted == unsorted bit for bit; parity (bench.py rule) "
          f"{ok4}; tri_tests/ray sorted {int(sp_s.tri_tests) / n}, unsorted "
          f"{int(sp_u.tri_tests) / n}; sorted {ms_s} ms ("
          f"{n / ms_s / 1e3} Mrays/s; its cast alone {cast_s} ms), "
          f"unsorted {ms_u} ms ({n / ms_u / 1e3} Mrays/s)", flush=True)
    return {"b1": b1, "b4": b4}


def phase_renderer(card: str, device, ctx: dict) -> int:
    """Phase 5b: RayRenderer over ``tlas.instanced_scene()`` at 1920x1080:
    COLOR with two lights and shadows over 2 accumulated frames, then one
    frame of NORMAL, DEPTH, PRIM_ID and HIT_MASK; B1 held against its plain
    version on the shadow wave.  Returns B1's launches."""
    import torch

    import messyerraytracer_tpu_torch as mrt
    from messyerraytracer_tpu_torch.render import framebuffer as fb
    from messyerraytracer_tpu_torch.render.renderer import (
        RayRenderer, RenderSettings, halton, shadow_rays)

    tlas = ctx["tlas"]
    inst = tlas.instanced_scene()
    w, h = FRAME
    cam = mrt.CameraParams.look_at((0, 26, 55), (0, 1, 0), fov_degrees=60.0)
    lights, env, mats = shading(device)
    color = RayRenderer(inst, cam, lights, env, mats, device=device,
                        settings=RenderSettings(w, h, channels=(fb.COLOR,)))
    aovs = (fb.NORMAL, fb.DEPTH, fb.PRIM_ID, fb.HIT_MASK)
    debug = RayRenderer(inst, cam, lights, env, mats, device=device,
                        settings=RenderSettings(w, h, channels=aovs,
                                                accumulate=False))

    # ---- the renderer's own run: counts reset just before, read after
    B1.launches = 0
    reset_camera()
    color.render_frame()
    per_color = B1.launches
    f_color = color.render_frame()
    f_debug = debug.render_frame()
    torch.cuda.synchronize()
    launches = B1.launches
    check(per_color == 2 and launches == 5,
          f"renderer: B1 per COLOR frame {per_color} (trace + shadows), "
          f"{launches} in the run")
    check(read_camera("renderer") == 3, "renderer: one camera launch a "
          "frame")
    check(color._accum_frames == 2, "two frames accumulated")
    for frame, chans in ((f_color, (fb.COLOR,)), (f_debug, aovs)):
        for ch in chans:
            check(bool(torch.isfinite(frame.get(ch)).all()),
                  f"1080p {ch}: every pixel finite")
    ref = tlas.cast_rays_instanced(
        mrt.generate_rays(cam, w, h, device=device))[0].hit
    mask = f_debug.get(fb.HIT_MASK)[:, 0] > 0.5
    check(torch.equal(mask, ref), "HIT_MASK == cast_rays_instanced's hit")
    print(f"[{card}] phase 5b renderer 1080p on the instanced scene: B1 "
          f"launches {launches} ({per_color} per COLOR frame); every pixel "
          f"finite; HIT_MASK == the instanced cast's hit (hit_rate "
          f"{float(mask.float().mean())}); mean sRGB "
          f"{float(f_color.get(fb.COLOR)[:, :3].mean())}", flush=True)

    # ---- B1 against its plain version on the first COLOR frame's shadow
    # wave ([light][pixel], dead rays where a pixel missed), a strided slice
    rays = mrt.generate_rays(cam, w, h, jitter=(halton(1, 2), halton(1, 3)),
                             device=device)
    hits, _ = inst.cast_rays(rays)
    wave = shadow_rays(hits, lights, hits.hit)
    m = min(SLICE, wave.count)
    part = wave.take(torch.arange(m, device=device) * (wave.count // m))
    err, plain_ms, st = compare_kernel_plain(part, inst.cluster_tlas,
                                             chunk=1 << 20, any_hit=True)
    dead = int((part.t_max < part.t_min).sum())
    print(f"[{card}] phase 5b B1 on {m} of the {wave.count} shadow "
          f"rays ({dead} dead), any hit: kernel == plain, max_abs_err "
          f"{err}, plain {plain_ms} ms; lane occupancy {occupancy(st)}",
          flush=True)

    # ---- one profiled COLOR frame split by stage; frame times, CUDA events
    split = device_split(color.render_frame, (
        "render.raygen", "render.trace", "render.shadows", "render.shade"))
    frames = {"COLOR frame": cuda_ms(color.render_frame, 3),
              "4 AOVs frame": cuda_ms(debug.render_frame, 3)}
    print(f"[{card}] phase 5b one COLOR frame by stage (device ms, "
          f"torch.profiler) {json.dumps(split)}; frame ms (CUDA events) "
          f"{json.dumps(frames)}", flush=True)
    return launches


def phase_path_tracers(card: str, device, ctx: dict) -> int:
    """Phase 5c: the wavefront path tracer at 1920x1080, 3 bounces, on the
    instanced scene and on the flat 1M cluster scene; B1 held against its
    plain version on bounce 0's shadow wave and bounce 1's extend wave.
    Returns B1's launches."""
    import torch

    from messyerraytracer_tpu_torch.dispatch.morton import sort_perm_6d
    from messyerraytracer_tpu_torch.render.pathtrace import dead_unless
    from messyerraytracer_tpu_torch.render.wavefront import (
        WavefrontPathTracer)

    lights, env, mats = shading(device)
    reset_camera()
    rays = block_swizzled_frame_rays(*FRAME, headline_camera(), device)
    check(read_camera("path tracers") == 1, "path tracers' frame: one "
          "camera launch")
    inst = ctx["tlas"].instanced_scene()
    total = 0
    for name, scene, cs, bounds in (
            ("instanced", inst, inst.cluster_tlas, inst.bounds),
            ("flat", ctx["flat"], ctx["flat"].cluster, None)):
        pt = WavefrontPathTracer(scene, lights, env, mats, bounds=bounds)
        check(pt.bounds is not None, f"{name}: carried-sort frame")
        # ---- this tracer's own run: counts reset just before, read after
        B1.launches = 0
        img, wave = pt.trace_frame(rays, max_bounces=3, sample_index=1,
                                   with_counts=True)
        torch.cuda.synchronize()
        launches = B1.launches
        total += launches
        check(launches == 8, f"{name} PT: B1 per frame {launches} (4 extend "
              f"+ 4 connect)")
        check(tuple(img.shape) == (rays.count, 3)
              and bool(torch.isfinite(img).all()),
              f"{name} PT: every pixel finite")
        ref = pt._trace_frame_stages(rays, 3, 1, carried=False)
        err = float((img - ref).abs().max())
        check(err < 1e-4, f"{name} PT: carried == uncarried, max |diff| "
              f"{err}")

        # ---- B1 against its plain version on the waves of the carried
        # frame: bounce 0's shadow rays (any hit) and bounce 1's extend
        # rays in their carried order, both with dead rays
        st = pt.generate(rays, 1)
        st = pt.shade(st, scene.cast_rays(rays)[0], 0, 3)
        shadow = st.shadow_ray
        st = st.take(sort_perm_6d(st.ray, *pt.bounds, live=st.active))
        extend = dead_unless(st.ray, st.active)
        for what, r, kw in (("bounce 0 shadow", shadow, {"any_hit": True}),
                            ("bounce 1 extend", extend, {})):
            dead = int((r.t_max < r.t_min).sum())
            check(dead > 0, f"{name} {what} wave holds dead rays")
            werr, plain_ms, wst = compare_kernel_plain(r, cs, chunk=1 << 20,
                                                       **kw)
            print(f"[{card}] phase 5c {name} B1 on the {what} wave "
                  f"({r.count} rays, {dead} dead): kernel == plain, "
                  f"max_abs_err {werr}, plain {plain_ms} ms; lane occupancy "
                  f"{occupancy(wst)}", flush=True)

        ms = cuda_ms(lambda: pt.trace_frame(rays, max_bounces=3,
                                            sample_index=1), 3)
        split = device_split(
            lambda: pt.trace_frame(rays, max_bounces=3, sample_index=1),
            ("cast", "morton.key", "morton.sort", "morton.gather",
             "morton.unshuffle", "wavefront.take"))
        print(f"[{card}] phase 5c PT {name} 1080p x 3 bounces: {ms} ms/"
              f"frame, {int(wave)} wave rays, {int(wave) / ms / 1e3} "
              f"Mrays/s; B1 launches {launches}; carried vs uncarried max "
              f"|diff| {err}; mean radiance {float(img.mean())}; one "
              f"frame by stage (device ms, torch.profiler) "
              f"{json.dumps(split)}", flush=True)
    return total


def phase_card_vs_cpu(card: str, device) -> None:
    """Phase 5d: camera rays, every AOV and one wavefront frame of the
    test-sized scenes on the card and on the CPU (the plain versions).
    Camera rays, HIT_MASK, PRIM_ID and the PCG32 streams equal; float AOVs
    within 5e-4 (POSITION modulo 1), radiance within 1e-4 on all but 2% of
    pixels (the tests' tolerances)."""
    import torch

    import messyerraytracer_tpu_torch as mrt
    from messyerraytracer_tpu_torch.accel.tlas import InstancedScene
    from messyerraytracer_tpu_torch.render import framebuffer as fb
    from messyerraytracer_tpu_torch.render.renderer import (
        RayRenderer, RenderSettings)
    from messyerraytracer_tpu_torch.render.wavefront import (
        WavefrontPathTracer, _finalize)

    w, h = SMALL_FRAME
    cam = mrt.CameraParams.look_at((0, 6, 12), (0, 1, 0), fov_degrees=50)
    rng = np.random.default_rng(5)
    for c, (cw, ch), jit in (
            (mrt.CameraParams.look_at((0, 26, 55), (0, 1, 0),
                                      fov_degrees=60.0), FRAME, (0.3, 0.6)),
            (cam, SMALL_FRAME, tuple(rng.uniform(0, 1, (h, w)).astype(
                np.float32) for _ in range(2))),
            (mrt.CameraParams.look_at((0, 2, 5), (0, 0, 0), ortho=True),
             SMALL_FRAME, (0.5, 0.5))):
        a, b = (mrt.generate_rays(c, cw, ch, jitter=jit, device=dev)
                for dev in (device, torch.device("cpu")))
        check(all(torch.equal(getattr(a, f).cpu(), getattr(b, f))
                  for f in ("origin", "direction", "t_min", "t_max")),
              f"generate_rays {cw}x{ch}: card == CPU bit for bit")
    print(f"[{card}] phase 5d camera rays (1920x1080 perspective, 64x48 "
          f"per-pixel jitter, 64x48 ortho): card == CPU bit for bit",
          flush=True)
    out = {}
    for k, dev in enumerate((torch.device("cpu"), device)):
        flat, ct = small_scenes(dev)
        inst = InstancedScene(ct, tuple(torch.as_tensor(b, device=dev)
                                        for b in ct.pair_bounds))
        lights, env, mats = shading(dev)
        for name, scene in (("flat", flat), ("instanced", inst)):
            r = RayRenderer(scene, cam, lights, env, mats, device=dev,
                            settings=RenderSettings(
                                w, h, channels=fb.ALL_CHANNELS,
                                accumulate=False))
            frame = r.render_frame()
            pt = WavefrontPathTracer(scene, lights, env, mats,
                                     bounds=getattr(scene, "bounds", None))
            rays = mrt.generate_rays(cam, w, h, device=dev)
            st = pt.generate(rays, 2)
            for bounce in range(3):
                st = pt.shade(st, pt.extend(st, sort=bounce > 0), bounce, 2)
                st = pt.connect(st, sort=bounce > 0)
            out[k, name] = (frame, st.rng, _finalize(st))
    for name in ("flat", "instanced"):
        (fc, rc, ac), (fg, rg, ag) = out[0, name], out[1, name]
        for ch in fb.ALL_CHANNELS:
            a, b = fg.get(ch).cpu(), fc.get(ch)
            if ch in (fb.HIT_MASK, fb.PRIM_ID):
                check(torch.equal(a, b), f"{name} {ch}: card == CPU")
                continue
            diff = (a - b).abs()
            if ch == fb.POSITION:
                diff = torch.minimum(diff, 1.0 - diff)
            check(float(diff.max()) <= 5e-4,
                  f"{name} {ch}: card within 5e-4 of CPU "
                  f"({float(diff.max())})")
        check(torch.equal(rg.cpu(), rc), f"{name}: PCG32 streams card == CPU")
        rel = ((ag.cpu() - ac).abs() / ac.abs().clamp_min(1.0)).amax(dim=1)
        share = float((rel > 1e-4).float().mean())
        check(bool(torch.isfinite(ag).all()) and share <= 0.02,
              f"{name} PT: card within 1e-4 of CPU on 98% of pixels "
              f"({share})")
        print(f"[{card}] phase 5d {name} {w}x{h}: HIT_MASK, PRIM_ID and "
              f"PCG32 streams card == CPU; float AOVs within 5e-4; PT "
              f"pixels off by > 1e-4: {share}", flush=True)


# ---------------------------------------------------------------------------
# phase 6: dynamic scenes, debug draw modes and checkpoints
# ---------------------------------------------------------------------------

DEBUG_EYE, DEBUG_FWD = (0.0, 26.0, 55.0), (0.0, -25.0, -55.0)


def headline_moves(tlas) -> dict:
    """100 instance moves of the headline scene: the 60 high-detail
    spheres up by 0.5, the 40 rocks each rotated about y (seeded)."""
    rng = np.random.default_rng(17)
    meshes_of = [i.blas_id for i in tlas.instances]
    moves = {}
    for k, inst in enumerate(tlas.instances):
        m = inst.transform.copy()
        if meshes_of[k] == 1:                   # high-detail sphere
            m[1, 3] += 0.5
        elif meshes_of[k] == 3:                 # rock
            a = rng.uniform(0.0, 2.0 * np.pi)
            c, n = np.cos(a), np.sin(a)
            rot = np.array([[c, 0, n], [0, 1, 0], [-n, 0, c]], np.float32)
            m[:, :3] = rot @ m[:, :3]
        else:
            continue
        moves[k] = m
    return moves


def to_device(x, device):
    """A copy of a scene object (dataclasses of tensors, tuples, dicts) with
    every tensor on ``device``."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: to_device(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


def bit_equal(a, b) -> bool:
    """Equal bit patterns (NaN == NaN), on the device of ``a``."""
    import torch

    b = b.to(a.device)
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def sync_s(fn):
    """(result, wall seconds) of ``fn`` fenced by synchronization."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def world_triangles(tlas, device):
    from messyerraytracer_tpu_torch.core.types import make_triangles

    w = tlas._world_tris_np()
    return make_triangles(w[:, 0], w[:, 1], w[:, 2], device=device)


# A ray that grazes a triangle's edge can hit it in object space (the
# instanced cast) and miss it in world space (the flat twin, brute), or the
# reverse: world coordinates up to 40 carry ~4e-6 of rounding, which is a
# barycentric error of ~1e-4 on the headline's smallest triangles (the
# sphere poles).  The twin and the instanced cast may disagree off ties
# only on such rays (on the H100: 1 ray of the 1080p frame, unmoved and
# moved alike, at u + v = 1 - 3.6e-5; PERF.md).
GRAZE_BARY = 1e-4


def twin_vs_instanced(hf, hi, rays, world_tris):
    """Where the twin's and the instanced frame's prims differ off ties,
    check that brute over ``world_tris`` confirms one of them and that the
    other's hit grazes an edge (min(u, v, 1 - u - v) < GRAZE_BARY) or is
    a miss where the confirmed one grazes.  Returns (prims equal, a
    summary)."""
    import torch

    from messyerraytracer_tpu_torch.core.brute import cast_rays_brute

    same = hf.prim_id == hi.prim_id
    both = hf.hit & hi.hit
    tie = both & ((hf.t - hi.t).abs()
                  <= 4e-6 * torch.maximum(hi.t.abs(), torch.ones_like(hi.t)))
    off = torch.nonzero(~same & ~tie)[:, 0]
    check(off.numel() <= 4096, f"twin vs instanced: {off.numel()} rays "
          f"differ off ties")
    if not off.numel():
        return same, {"rays": 0}
    hb, _ = cast_rays_brute(rays.take(off), world_tris, chunk=8192)

    def edge(h):
        u, v = h.u[off], h.v[off]
        return torch.minimum(torch.minimum(u, v), 1.0 - u - v)

    ef, ei = edge(hf), edge(hi)
    twin_ok = hf.prim_id[off] == hb.prim_id
    inst_ok = hi.prim_id[off] == hb.prim_id
    graze = torch.where(twin_ok, torch.where(hi.hit[off], ei, ef),
                        torch.where(hf.hit[off], ef, ei))
    ok = (twin_ok | inst_ok) & (graze < GRAZE_BARY)
    summary = {"rays": off.numel(), "brute sides with the twin":
               int(twin_ok.sum()), "with the instanced": int(inst_ok.sum()),
               "largest edge distance": float(graze.max())}
    check(bool(ok.all()), f"twin vs instanced off ties are edge grazes "
          f"{json.dumps(summary)}")
    return same, summary


REFIT_ITERS = 2000       # launches of the refit kernel timed together


def time_refit_kernel(card: str, ct) -> tuple:
    """The refit kernel on ``ct``'s shapes against its plain version,
    bit for bit, then timed: the kernel alone (its C entry on outputs
    allocated once) and the wrapper as ``set_transforms`` calls it, each
    fenced by CUDA events over REFIT_ITERS launches, and the plain
    version.  Returns ms: (kernel, wrapper, plain, bound).  The bound
    counts each table read once and each output written once (the
    arrival counters twice)."""
    import torch

    from messyerraytracer_tpu_torch.kernels import cluster_tlas as ctl

    rows = torch.as_tensor(ct.inst_rows, device=ct.node_box.device)
    out, ref = ctl.refit_pairs_cuda(ct, rows), ctl._refit_pairs_plain(ct,
                                                                      rows)
    for k, a, b in (("aabb_min", out[0].aabb_min, ref[0].aabb_min),
                    ("aabb_max", out[0].aabb_max, ref[0].aabb_max),
                    ("node_box", out[1], ref[1]), ("iinv", out[2], ref[2]),
                    ("ifwd", out[3], ref[3])):
        check(bit_equal(a, b), f"refit kernel {k} == plain bit for bit")
    check(not bool(ct.pair_arrivals.any()), "arrival counters back at 0")
    args, outs = ctl._refit_kernel_args(ct, rows)
    bvh = ct.pair_bvh
    moved = nbytes(rows, ct.pair_obj_min, ct.pair_obj_max, ct.pair_inst,
                   bvh.tri_order, bvh.left_first, bvh.count, ct.pair_parent,
                   ct.pair_slot, ct.child_node, ct.pair_arrivals,
                   ct.pair_arrivals, *outs)
    bound_ms, what = bound(moved, 0)
    lib, stream = ctl.cuda_library(), torch.cuda.current_stream().cuda_stream
    kernel_ms = cuda_ms(lambda: lib.mrt_tlas_refit(*args, stream),
                        REFIT_ITERS)
    wrapper_ms = cuda_ms(lambda: ctl.refit_pairs_cuda(ct, rows), REFIT_ITERS)
    plain_ms = cuda_ms(lambda: ctl._refit_pairs_plain(ct, rows), 20)
    check(not bool(ct.pair_arrivals.any()), "arrival counters back at 0")
    print(f"[{card}] refit kernel: {bvh.num_nodes} nodes, {bvh.num_tris} "
          f"pairs, {ct.n_inst} instances; alone {kernel_ms} ms a launch, "
          f"through its wrapper {wrapper_ms} ms a call (CUDA events over "
          f"{REFIT_ITERS}); bound {bound_ms} ms ({moved} bytes, {what}); "
          f"plain version {plain_ms} ms; wrapper launches so far "
          f"{R1.launches}", flush=True)
    return kernel_ms, wrapper_ms, plain_ms, bound_ms


def phase_dynamic(card: str, device, ctx: dict) -> dict:
    """Phase 6: dynamic scenes, debug draw modes and checkpoints at full
    size.  Returns B1's and B4's launches from its paths' own runs."""
    import os
    import tempfile

    import torch

    from messyerraytracer_tpu_torch.accel.tlas import _world_slots
    from messyerraytracer_tpu_torch.api.service import RayQuery
    from messyerraytracer_tpu_torch.core.brute import cast_rays_brute, parity
    from messyerraytracer_tpu_torch.debug import debug as dbg
    from messyerraytracer_tpu_torch.kernels.cluster_tlas import (
        set_transforms)
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        cluster_cast_plain)
    from messyerraytracer_tpu_torch.scene.scene import _refit_slots
    from messyerraytracer_tpu_torch.scene.serialize import (
        load_scene, save_scene)

    tlas, rays, pallas = ctx["tlas"], ctx["rays"], ctx["pallas"]
    n = rays.count
    idx = torch.arange(4096, device=device) * (n // 4096)
    sub = rays.take(idx)
    part = rays.take(torch.arange(min(SLICE, n), device=device))
    b1 = b4 = 0

    # ---- the flat twin, built before the moves (it stays on the old
    # transforms until refit_tlas, the JAX package's two-step contract)
    _, twin_s = sync_s(tlas._ensure_flat)
    old_twin = tlas.flat
    print(f"[{card}] phase 6 flat twin build {twin_s} s "
          f"({old_twin.num_tris} triangles)", flush=True)

    # ---- (a) 100 instances move through set_transform
    moves = headline_moves(tlas)
    check(len(moves) == 100, f"100 moves ({len(moves)})")
    cpu_ct = to_device(tlas._ctlas, torch.device("cpu"))
    R1.launches = 0
    _, move_s = sync_s(lambda: [tlas.set_transform(k, m)
                                for k, m in moves.items()])
    lr = R1.launches
    check(lr == 100, f"(a) one refit launch per set_transform ({lr})")
    k0 = next(iter(moves))
    split_a = device_split(lambda: tlas.set_transform(k0, moves[k0]),
                           ("refit.set_transforms",))
    ct = tlas._ctlas
    ref_ct = set_transforms(cpu_ct, [i.transform for i in tlas.instances])
    for f in ("node_box", "iinv", "ifwd"):
        check(bit_equal(getattr(ct, f), getattr(ref_ct, f)),
              f"set_transforms {f}: card == CPU bit for bit")
    for f in ("aabb_min", "aabb_max"):
        check(bit_equal(getattr(ct.pair_bvh, f), getattr(ref_ct.pair_bvh, f)),
              f"pair tree {f}: card == CPU bit for bit")
    refit_ms, refit_call_ms, refit_plain_ms, refit_bound = \
        time_refit_kernel(card, ct)
    B1.launches = 0
    hi, si, _, inst = tlas.cast_rays_instanced(rays)
    torch.cuda.synchronize()
    la = B1.launches
    b1 += la
    check(la == 1 and int(si.stack_drops) == 0,
          f"(a) instanced frame: B1 launches {la}, stack_drops "
          f"{int(si.stack_drops)}")
    moved_tris = world_triangles(tlas, device)
    hb, _ = cast_rays_brute(sub, moved_tris, chunk=8192)
    atol = anchor_atol(old_twin)
    ok = parity(tlas.cast_rays_instanced(sub)[0], hb, atol=atol)
    check(ok, "(a) moved instanced parity vs brute")
    moved_ids = torch.tensor(sorted(moves), dtype=inst.dtype, device=device)
    hit_moved = int(torch.isin(inst, moved_ids).sum())
    check(hit_moved > 0, "(a) the frame sees moved instances")
    err, plain_ms, st = compare_kernel_plain(part, ct, chunk=1 << 20)
    print(f"[{card}] phase 6a set_transform x100: {move_s * 1e3} ms wall "
          f"({move_s * 10} ms a call), refit kernel launches {lr}; the "
          f"kernel alone {refit_ms} ms a launch ({refit_call_ms} through "
          f"its wrapper) against its bound {refit_bound} ms, its plain "
          f"version {refit_plain_ms} ms; one call under torch.profiler "
          f"{json.dumps(split_a)}; tables card == CPU bit for bit; frame: "
          f"B1 launches {la}, hit_rate {float(hi.hit.float().mean())}, "
          f"{hit_moved} pixels on moved instances, parity vs brute (4096 "
          f"rays, t atol {atol}) {ok}; B1 == plain on {part.count} rays, "
          f"max_abs_err {err}, plain {plain_ms} ms", flush=True)

    # ---- (b) refit_tlas of the 1M twin
    stale, _ = old_twin.cast_rays(sub)
    check(parity(stale, cast_rays_brute(sub, old_twin.tris,
                                        chunk=8192)[0]),
          "(b) the twin casts its old transforms before refit_tlas")
    cpu_twin = to_device(old_twin, torch.device("cpu"))
    cpu_in = [t.cpu() for t in (tlas._obj_slots, tlas._slot_inst)]
    _, refit_s = sync_s(tlas.refit_tlas)
    twin = tlas.flat
    split_b = device_split(tlas.refit_tlas, ("refit.tlas", "refit.scene"))
    twin = tlas.flat
    ref = _refit_slots(cpu_twin, *_world_slots(
        *cpu_in, tlas._transforms_tensor().cpu()))
    for name, a, b in (
            [(f"tris.{f}", getattr(twin.tris, f), getattr(ref.tris, f))
             for f in ("v0", "edge1", "edge2", "normal")]
            + [(f"bvh.{f}", getattr(twin.bvh, f), getattr(ref.bvh, f))
               for f in ("aabb_min", "aabb_max")]
            + [(f"cluster.{f}", getattr(twin.cluster, f),
                getattr(ref.cluster, f))
               for f in ("node_box", "tri", "cl_anchor", "cl_aabb")]):
        check(bit_equal(a, b), f"(b) refit {name}: card == CPU bit for bit")
    B1.launches = 0
    hf, sf = twin.cast_rays(rays)
    torch.cuda.synchronize()
    lb = B1.launches
    b1 += lb
    check(int(sf.stack_drops) == 0, "(b) twin frame stack_drops == 0")
    ok_b = parity(twin.cast_rays(sub)[0], hb, atol=atol)
    check(ok_b, "(b) refit twin parity vs brute")
    same, grazes = twin_vs_instanced(hf, hi, rays, moved_tris)
    print(f"[{card}] phase 6b refit_tlas of {twin.num_tris} triangles: "
          f"{refit_s * 1e3} ms wall against the twin's build {twin_s} s "
          f"(build / refit {twin_s / refit_s}); one refit under "
          f"torch.profiler {json.dumps(split_b)}; tables card == CPU bit "
          f"for bit (tris, BVH boxes, node_box, tri, anchors, cluster "
          f"boxes); frame: B1 launches {lb}, prims == instanced on "
          f"{float(same.float().mean())} of rays, off ties only edge "
          f"grazes {json.dumps(grazes)}, parity vs brute {ok_b}",
          flush=True)

    # ---- (c) the pallas scene's terrain displaced through RayScene.refit
    world = ctx["world_tris"].copy()
    ter = tlas._tri_inst < 16                       # the 16 terrain tiles
    world[ter, :, 1] += 0.05 * np.sin(0.7 * world[ter, :, 0])
    disp = pallas.refit(world[:, 0], world[:, 1], world[:, 2])
    _, pallas_s = sync_s(lambda: pallas.refit(world[:, 0], world[:, 1],
                                              world[:, 2]))
    split_c = device_split(lambda: pallas.refit(world[:, 0], world[:, 1],
                                                world[:, 2]),
                           ("refit.scene",))
    B4.launches = 0
    B1.launches = 0
    hp, sp = disp.cast_rays(rays)
    torch.cuda.synchronize()
    lc = B4.launches
    b4 += lc
    check(lc == 1 and B1.launches == 0
          and int(sp.stack_drops) == 0,
          f"(c) pallas frame: B4 launches {lc}, stack_drops "
          f"{int(sp.stack_drops)}")
    hbp, _ = cast_rays_brute(sub, disp.tris, chunk=8192)
    ok_c = parity(disp.cast_rays(sub)[0], hbp)
    check(ok_c, "(c) displaced pallas parity vs brute")
    errc, plainc, _, _ = compare_wide_plain(part, disp.wide, chunk=1 << 20)
    print(f"[{card}] phase 6c pallas terrain displaced "
          f"({int(ter.sum())} triangles): RayScene.refit {pallas_s * 1e3} "
          f"ms wall; under torch.profiler {json.dumps(split_c)}; frame: B4 "
          f"launches {lc}, parity vs brute {ok_c}; B4 == plain on "
          f"{part.count} rays, max_abs_err {errc}, plain {plainc} ms",
          flush=True)

    # ---- (d) the service: set_transform, refit, 524,288 random rays
    svc = ctx["svc"]
    for k, m in moves.items():
        svc.set_transform(k, m)
    _, svc_s = sync_s(svc.refit)
    srays = service_rays(svc.scene, device)
    B1.launches = 0
    rs = svc.submit(RayQuery(srays))
    ru = svc.submit(RayQuery(srays, coherent=True))
    torch.cuda.synchronize()
    ld = B1.launches
    b1 += ld
    check(ld == 2, f"(d) service: one B1 launch per submit ({ld})")
    check(same_hits(rs.hits, ru.hits), "(d) sorted == unsorted bit for bit")
    check(int(rs.stats.stack_drops) == 0, "(d) stack_drops == 0")
    sidx = torch.arange(4096, device=device) * (INCOHERENT // 4096)
    hbs, _ = cast_rays_brute(srays.take(sidx), svc.scene.tris, chunk=8192)
    satol = anchor_atol(svc.scene)
    ok_d = parity(take_hits(rs.hits, sidx), hbs, atol=satol)
    check(ok_d, "(d) service parity vs brute")
    check(bit_equal(svc.scene.cluster.node_box, twin.cluster.node_box),
          "(d) the service's refit twin == the TLAS's")
    print(f"[{card}] phase 6d service set_transform x100 + refit "
          f"{svc_s * 1e3} ms wall; 512K random rays: B1 launches {ld}, "
          f"sorted == unsorted bit for bit, parity vs brute (t atol "
          f"{satol}) {ok_d}, stack_drops 0", flush=True)

    # ---- (e) debug draw modes on a 1920x1080 grid over the refit twin
    w, h = FRAME
    B1.launches = 0
    modes = {}
    for mode in range(7):
        r, mode_s = sync_s(lambda: dbg.cast_debug_rays(
            twin, DEBUG_EYE, DEBUG_FWD, w, h, draw_mode=mode, device=device))
        check(tuple(r.colors.shape) == (w * h, 3)
              and bool(torch.isfinite(r.colors).all())
              and bool(((r.colors >= 0) & (r.colors <= 1)).all()),
              f"(e) mode {mode}: colors in [0, 1]")
        modes[mode] = {"ms": mode_s * 1e3, "cast_ms": r.elapsed_ms,
                       "mean": float(r.colors.mean())}
    torch.cuda.synchronize()
    le = B1.launches
    b1 += le
    check(le == 9, f"(e) B1 launches: 7 casts + 2 heatmap counts ({le})")
    grid = r.rays
    colors, tt, nodes = dbg.per_ray_cost_heatmap(twin, grid)
    _, iout, _ = cluster_cast_plain(grid.origin, grid.direction, grid.t_min,
                                    grid.t_max, twin.cluster, chunk=1 << 20)
    check(torch.equal(tt, iout[2].float()) and torch.equal(
        nodes, iout[4].float()), "(e) heatmap counts == plain version's")
    (segs, depth), wire_s = sync_s(lambda: dbg.bvh_wireframe(twin.bvh))
    check(segs.shape[0] == 12 * twin.bvh.num_nodes
          and int(depth.max()) == len(twin.bvh.levels) - 1,
          "(e) wireframe: 12 edges a node, depths from the levels")
    print(f"[{card}] phase 6e cast_debug_rays 1920x1080 over the refit "
          f"twin, by mode {json.dumps(modes)}; B1 launches {le}; heatmap "
          f"counts == plain version's (tri_tests/ray "
          f"{float(tt.mean())}, node visits/ray {float(nodes.mean())}); "
          f"bvh_wireframe {segs.shape[0]} segments in {wire_s * 1e3} ms",
          flush=True)

    # ---- (f) checkpoint of the refit twin
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/twin.npz"
        _, save_s = sync_s(lambda: save_scene(path, twin))
        size = os.path.getsize(path)
        loaded, load_s = sync_s(lambda: load_scene(path, device=device))
    B1.launches = 0
    hl, _ = loaded.cast_rays(rays)
    torch.cuda.synchronize()
    lf = B1.launches
    b1 += lf
    check(lf == 1 and same_hits(hl, hf),
          "(f) the loaded twin's frame == the saved twin's bit for bit")
    for f in ("v0", "edge1", "edge2", "normal", "prim_id", "layers"):
        check(bit_equal(getattr(loaded.tris, f), getattr(twin.tris, f)),
              f"(f) loaded tris.{f} bit for bit")
    print(f"[{card}] phase 6f checkpoint of the refit twin: save "
          f"{save_s} s, load {load_s} s, file {size} bytes; loaded frame "
          f"== saved frame bit for bit (B1 launches {lf})", flush=True)
    return {"b1": b1, "b4": b4}


# ---------------------------------------------------------------------------
# phase 7: the frontier backends, the two-level casts, multi-device casts
# ---------------------------------------------------------------------------

LOOP_RAYS = 65_536          # rays of the instance-loop cast (215 B1 casts)
SMALL_RAYS = 16_384         # rays of the card-against-CPU casts


def table_bytes(x) -> int:
    """Bytes of every tensor of a table dataclass, tuples included."""
    import dataclasses

    import torch

    total = 0
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        for t in (v if isinstance(v, tuple) else (v,)):
            if isinstance(t, torch.Tensor):
                total += nbytes(t)
    return total


def peak_mib(fn):
    """(result, MiB allocated at the peak of ``fn`` above what was allocated
    before it)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def reset_launches() -> None:
    B1.launches = 0
    B4.launches = 0
    reset_camera()


# the camera kernel's launches in each main path's own run, {path: count}:
# the kernels summary reports their sum
CAMERA_RUNS: dict = {}


def reset_camera() -> None:
    C1.launches = 0


def read_camera(path: str) -> int:
    """The camera kernel's launches since ``reset_camera`` (or
    ``reset_launches``), added to ``CAMERA_RUNS[path]``."""
    n = C1.launches
    CAMERA_RUNS[path] = CAMERA_RUNS.get(path, 0) + n
    return n


def read_launches() -> tuple[int, int]:
    """(B1, B4) launches since ``reset_launches``, after a synchronize."""
    import torch

    torch.cuda.synchronize()
    return B1.launches, B4.launches


def small_tlas(device):
    """A small SceneTLAS: a sphere and a box, 27 instances turned about y
    and scaled, some layer-masked."""
    from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS
    from messyerraytracer_tpu_torch.utils import meshes

    rng = np.random.default_rng(23)
    tlas = SceneTLAS(device=device)
    ids = [tlas.add_mesh(meshes.uv_sphere(1.0, 16, 32)),
           tlas.add_mesh(meshes.box((1.0, 2.0, 1.0)))]
    for i in range(27):
        a, s = rng.uniform(0, 6.3), rng.uniform(0.4, 1.3)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.float32([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                [-np.sin(a), 0, np.cos(a)]]) * s
        m[:3, 3] = rng.uniform(-6, 6, 3)
        tlas.add_instance(ids[i % 2], m, layers=-1 if i % 3 else 0b01)
    tlas.build_tlas()
    return tlas


# The two-level casts and the instanced one are object-space casts with
# different arithmetic (classic Moller-Trumbore against B1's anchored
# Plucker test with its watertight band), so a ray through a shared edge
# can hit the nearer triangle in one and fall through the crack to a
# farther surface in the other (on the H100: 18 of the 2,073,600 frame
# rays after phase 6's moves; PERF.md).  Each such ray's
# nearer hit must lie within CRACK_ULPS ulps of the scene's largest
# coordinate of an edge of its triangle, measured across the ray.
CRACK_ULPS = 16


def crack_grazes(ha, hb_, rays, world_tris):
    """Where the prims of two casts ``ha`` and ``hb_`` differ off exact-t
    ties, check that the nearer of the two hits lies within CRACK_ULPS
    ulps of the scene's largest coordinate of its triangle's nearest edge,
    across the ray (barycentric weight x the triangle's altitude onto that
    edge x |cos| of the angle between the ray and the triangle's normal).
    Brute over ``world_tris`` says which side it takes.  Returns (prims
    equal, a summary)."""
    import torch

    from messyerraytracer_tpu_torch.core.brute import cast_rays_brute

    same = ha.prim_id == hb_.prim_id
    both = ha.hit & hb_.hit
    tie = both & ((ha.t - hb_.t).abs() <= 4e-6 * torch.maximum(
        hb_.t.abs(), torch.ones_like(hb_.t)))
    off = torch.nonzero(~same & ~tie)[:, 0]
    check(off.numel() <= 4096, f"{off.numel()} rays differ off ties")
    if not off.numel():
        return same, {"rays": 0}
    hr, _ = cast_rays_brute(rays.take(off), world_tris, chunk=8192)
    first = ha.t[off] <= hb_.t[off]
    def pick(f):
        return torch.where(first, getattr(ha, f)[off], getattr(hb_, f)[off])

    p = pick("prim_id").long()
    u, v = pick("u").double(), pick("v").double()
    e1, e2 = world_tris.edge1[p].double(), world_tris.edge2[p].double()
    area2 = torch.linalg.vector_norm(torch.linalg.cross(e1, e2), dim=-1)
    dist = torch.stack([
        (1.0 - u - v).abs() * area2 / torch.linalg.vector_norm(e2 - e1,
                                                               dim=-1),
        u.abs() * area2 / torch.linalg.vector_norm(e2, dim=-1),
        v.abs() * area2 / torch.linalg.vector_norm(e1, dim=-1)]).amin(0)
    cos = (world_tris.normal[p].double()
           * rays.direction[off].double()).sum(-1).abs()
    big = float(max(world_tris.v0.abs().max(), world_tris.v1.abs().max(),
                    world_tris.v2.abs().max()))
    ulps = dist * cos / float(np.spacing(np.float32(big)))
    summary = {"rays": off.numel(),
               "brute sides with the first": int(
                   (ha.prim_id[off] == hr.prim_id).sum()),
               "with the second": int((hb_.prim_id[off] == hr.prim_id)
                                      .sum()),
               "nearer hit's edge distance, ulps": float(ulps.max())}
    check(bool((ulps <= CRACK_ULPS).all()),
          f"off ties only cracks at an edge {json.dumps(summary)}")
    return same, summary


def phase_frontier(card: str, device, ctx: dict) -> dict:
    """Phase 7a: the frontier backends on the 1M flat twin at 1080p."""
    import dataclasses

    import torch

    from messyerraytracer_tpu_torch.accel.frontier import (
        cast_rays_frontier)
    from messyerraytracer_tpu_torch.core.brute import TIE_RTOL, parity
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        cast_rays_cluster_v2)

    flat, pallas = ctx["flat"], ctx["pallas"]
    rays, sub, hb = ctx["rays"], ctx["sub"], ctx["hb"]
    n = rays.count
    _, _, _, pr1 = cast_rays_cluster_v2(rays, flat.cluster,
                                        return_per_ray=True)
    hp, sp = pallas.cast_rays(rays)
    ctx["pallas_frame"] = (hp, sp)
    counters = {"B1 tri_tests/ray": float(pr1["tri_tests"].float().mean()),
                "B1 node visits/ray": float(pr1["node_visits"].float()
                                            .mean()),
                "B4 tri_tests/ray": int(sp.tri_tests) / n,
                "B4 pops/ray": int(sp.bvh_nodes_visited) / n}
    out = {}
    for backend in ("frontier", "frontier_q"):
        scene = dataclasses.replace(flat, backend=backend)
        fs, build_s = sync_s(scene._frontier_for_backend)
        # ---- the path's own run: counts reset just before, read after
        reset_launches()
        (h, s), peak = peak_mib(lambda: scene.cast_rays(rays))
        check(read_launches() == (0, 0),
              f"{backend}: the frontier path launches neither B1 nor B4")
        check(scene._frontier_for_backend() is fs,
              f"{backend}: the tables are built once")
        check(int(s.stack_drops) == 0 and bool(torch.isfinite(h.t).all()),
              f"{backend}: finite t")
        _, _, occ, pr = cast_rays_frontier(rays, fs, flat.tris,
                                           any_hit=True,
                                           return_per_ray_stats=True)
        check(torch.equal(occ, h.hit), f"{backend}: any hit == hit")
        _, _, _, pr = cast_rays_frontier(rays, fs, flat.tris,
                                         return_per_ray_stats=True)
        check(int(pr["tri_tests"].sum(dtype=torch.int64))
              == int(s.tri_tests), f"{backend}: per-ray counts sum")
        ms = cuda_ms(lambda: scene.cast_rays(rays), 3)
        split = device_split(lambda: scene.cast_rays(rays), ("cast",))
        hs, _ = scene.cast_rays(sub)
        ok = parity(hs, hb)
        check(ok, f"{backend} parity vs brute (4096 rays)")
        same = hs.prim_id == hb.prim_id
        check(all(bit_equal(getattr(hs, f)[same], getattr(hb, f)[same])
                  for f in HIT_FIELDS),
              f"{backend}: bit-equal to brute where the prims agree")
        diff = h.prim_id != hp.prim_id
        tie = (h.t - hp.t).abs() <= TIE_RTOL * torch.maximum(
            hp.t.abs(), torch.ones_like(hp.t))
        check(parity(h, hp), f"{backend} vs B4 (8-wide) on the frame")
        out[backend] = {
            "ms": ms, "Mrays/s": n / ms / 1e3, "peak MiB": peak,
            "tables MiB": table_bytes(fs) / 2 ** 20, "build s": build_s,
            "tri_tests/ray": float(pr["tri_tests"].float().mean()),
            "nodes/ray": float(pr["nodes_visited"].float().mean()),
            "prims != B4": int(diff.sum()),
            "of which t ties (TIE_RTOL)": int((diff & tie).sum()),
            "parity vs brute": ok,
            "one frame under torch.profiler": {
                key: split[key] for key in ("wall", "device busy",
                                            "idle share", "device events")}}
        print(f"[{card}] phase 7a {backend} 1080p on the 1M flat twin: "
              f"{json.dumps(out[backend])}", flush=True)
    print(f"[{card}] phase 7a per-ray counters beside B1's and B4's "
          f"{json.dumps(counters)}; tri_per_ray_exact_1m "
          f"{out['frontier']['tri_tests/ray']}", flush=True)
    return out


def phase_two_level(card: str, device, ctx: dict) -> int:
    """Phase 7b: the two-level casts on the instanced headline scene,
    against the instanced cast (B1).  Returns B1's launches."""
    import torch

    tlas, rays = ctx["tlas"], ctx["rays"]
    n = rays.count
    ft, build_s = sync_s(tlas.build_two_level)
    world = world_triangles(tlas, device)
    hi, _, _, ii = tlas.cast_rays_instanced(rays)
    # ---- the path's own run: counts reset just before, read after
    reset_launches()
    (h2, s2, occ2, i2), peak = peak_mib(
        lambda: tlas.cast_rays_two_level_fast(rays))
    check(read_launches() == (0, 0),
          "two-level fast: launches neither B1 nor B4")
    check(tlas._two_level is ft, "two-level fast: the tables are reused")
    check(bool(torch.isfinite(h2.t).all()) and torch.equal(h2.hit, i2 >= 0),
          "two-level fast: finite t, an instance id on every hit")
    same, grazes = crack_grazes(h2, hi, rays, world)
    check(torch.equal(i2[same], ii[same]),
          "two-level fast: instance ids == instanced where prims agree")
    ms = cuda_ms(lambda: tlas.cast_rays_two_level_fast(rays), 3)
    split = device_split(lambda: tlas.cast_rays_two_level_fast(rays),
                         ("cast",))
    flat = tlas.flat
    sizes = {"FrontierTLAS MiB": table_bytes(ft) / 2 ** 20,
             "flat twin frontier tables MiB": table_bytes(flat.frontier)
             / 2 ** 20,
             "flat twin cluster tables MiB": table_bytes(flat.cluster)
             / 2 ** 20,
             "flat twin triangles MiB": table_bytes(flat.tris) / 2 ** 20}
    print(f"[{card}] phase 7b cast_rays_two_level_fast 1080p: {ms} ms/frame"
          f" ({n / ms / 1e3} Mrays/s), peak {peak} MiB, build {build_s} s, "
          f"tri_tests/ray {int(s2.tri_tests) / n}, nodes/ray "
          f"{int(s2.bvh_nodes_visited) / n}; prims == instanced on "
          f"{float(same.float().mean())} of rays, off ties only cracks at "
          f"an edge {json.dumps(grazes)}; {json.dumps(sizes)}; one frame "
          f"under torch.profiler {json.dumps(split)}", flush=True)

    # ---- the instance loop on a strided subsample: one B1 cast each
    idx = torch.arange(LOOP_RAYS, device=device) * (n // LOOP_RAYS)
    sub = rays.take(idx)
    reset_launches()
    (hl, il), loop_s = sync_s(lambda: tlas.cast_rays_two_level(sub))
    b1, b4 = read_launches()
    check(b1 == len(tlas.instances) and b4 == 0,
          f"instance loop: one B1 launch per instance ({b1})")
    same_l, grazes_l = crack_grazes(hl, take_hits(hi, idx), sub, world)
    check(torch.equal(il[same_l], ii[idx][same_l]),
          "instance loop: instance ids == instanced where prims agree")
    print(f"[{card}] phase 7b cast_rays_two_level on {LOOP_RAYS} rays: "
          f"{loop_s * 1e3} ms wall, B1 launches {b1}; prims == instanced "
          f"on {float(same_l.float().mean())} of rays, off ties only "
          f"cracks at an edge {json.dumps(grazes_l)}", flush=True)
    return b1


def phase_sharding(card: str, device, ctx: dict) -> dict:
    """Phase 7c: the sharded casts on meshes of 1 and 4 entries of the
    card.  Returns B1's and B4's launches."""
    import torch

    import messyerraytracer_tpu_torch as mrt
    from messyerraytracer_tpu_torch.core.brute import parity
    from messyerraytracer_tpu_torch.parallel.dryrun import dryrun_multichip
    from messyerraytracer_tpu_torch.parallel.sharding import (
        build_sharded_scene, cast_rays_scene_sharded, cast_rays_sharded,
        make_mesh, render_step_sharded)

    flat, pallas, rays = ctx["flat"], ctx["pallas"], ctx["rays"]
    sub, hb = ctx["sub"], ctx["hb"]
    n = rays.count
    single = {"B1": (flat,) + flat.cast_rays(rays),
              "B4": (pallas,) + ctx["pallas_frame"]}
    b1 = b4 = 0
    times = {}
    for k in (1, 4):
        mesh = make_mesh(k, devices=[device] * k)
        for name, (scene, h1, s1) in single.items():
            reset_launches()
            hs, ss, occ = cast_rays_sharded(rays, scene, mesh)
            l1, l4 = read_launches()
            b1, b4 = b1 + l1, b4 + l4
            check((l1, l4) == ((k, 0) if name == "B1" else (0, k)),
                  f"sharded x{k} on {name}: one launch per shard")
            check(same_hits(hs, h1) and torch.equal(occ, h1.hit)
                  and all(int(getattr(ss, f)) == int(getattr(s1, f))
                          for f in ("rays_cast", "tri_tests",
                                    "bvh_nodes_visited", "hits",
                                    "stack_drops")),
                  f"sharded x{k} on {name} == the single cast bit for bit")
            times[f"x{k} {name}"] = cuda_ms(
                lambda: cast_rays_sharded(rays, scene, mesh), 3)
    print(f"[{card}] phase 7c cast_rays_sharded 1080p on meshes of 1 and "
          f"4 x {device}: == the single cast bit for bit (hits, occluded, "
          f"summed stats); ms {json.dumps(times)}", flush=True)

    mesh = make_mesh(4, devices=[device] * 4)
    (stacked, meta, id_maps), build_s = sync_s(
        lambda: build_sharded_scene(ctx["world_tris"], 4, mesh))
    reset_launches()
    hss, sss = cast_rays_scene_sharded(rays, stacked, meta, id_maps, mesh)
    l1, l4 = read_launches()
    b1, b4 = b1 + l1, b4 + l4
    check((l1, l4) == (0, 4), "scene-sharded: one B4 launch per shard")
    check(int(sss.stack_drops) == 0 and parity(hss, single["B4"][1]),
          "scene-sharded x4 vs the unsharded pallas cast")
    ok = parity(cast_rays_scene_sharded(sub, stacked, meta, id_maps,
                                        mesh)[0], hb)
    check(ok, "scene-sharded x4 parity vs brute (4096 rays)")
    ms = cuda_ms(lambda: cast_rays_scene_sharded(rays, stacked, meta,
                                                 id_maps, mesh), 3)
    diff = int((hss.prim_id != single["B4"][1].prim_id).sum())
    print(f"[{card}] phase 7c cast_rays_scene_sharded x4 (shards of "
          f"{[w.leaf_tri.shape[0] for w in stacked]} leaves, build "
          f"{build_s} s): {ms} ms/frame, prims != unsharded pallas on {diff} "
          f"rays (t ties by the parity rule), parity vs brute {ok}",
          flush=True)

    cam = mrt.CameraParams.look_at((0, 26, 55), (0, 1, 0), fov_degrees=60.0)
    lights, env, mats = shading(device)
    reset_launches()
    img, step_s = sync_s(lambda: render_step_sharded(
        flat, cam, *FRAME, mesh, lights=lights, env=env, materials=mats,
        max_bounces=1))
    r1, r4 = read_launches()
    check(tuple(img.shape) == (n, 3) and bool(torch.isfinite(img).all())
          and r1 == 16 and r4 == 0,
          f"render_step_sharded 1080p: finite, 4 B1 casts a shard ({r1})")
    check(read_camera("render_step_sharded") == 1,
          "render_step_sharded: one camera launch")
    reset_launches()
    dry, dry_s = sync_s(lambda: dryrun_multichip(4, device=device))
    d1, d4 = read_launches()
    check(read_camera("dryrun_multichip") == 3, "dryrun_multichip: three "
          "camera launches (its batch, its render step, its sub-frame)")
    b1, b4 = b1 + r1 + d1, b4 + r4 + d4
    print(f"[{card}] phase 7c render_step_sharded 1080p x 1 bounce on 4 "
          f"shards: {step_s * 1e3} ms wall, mean radiance "
          f"{float(img.mean())}, B1 launches {r1}; dryrun_multichip(4) "
          f"{dry_s} s (B1 {d1}, B4 {d4} launches) {json.dumps(dry)}",
          flush=True)
    if torch.cuda.device_count() < 2:
        print(f"[{card}] phase 7e skipped: one card visible, no mesh of "
              f"distinct cards", flush=True)
        return {"b1": b1, "b4": b4}
    c1, c4 = phase_cards(card, device, ctx, img if
                         torch.cuda.device_count() == 4 else None)
    return {"b1": b1 + c1, "b4": b4 + c4}


def all_cards_s(fn, iters: int) -> float:
    """Mean wall seconds per call of ``fn`` over ``iters`` calls after
    one warm-up, every visible card synchronized before and after."""
    import torch

    def sync():
        for k in range(torch.cuda.device_count()):
            torch.cuda.synchronize(k)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def phase_cards(card: str, device, ctx: dict, img_ref) -> tuple[int, int]:
    """Phase 7e, only where more than one card is visible: the sharded
    paths on ``make_mesh()``, one shard on each card, held bit for bit
    against the same paths on as many entries of ``device`` (the shard
    bounds and seeds are the same), and timed beside them.  ``img_ref``
    is that render step's image when phase 7c already made it.  Returns
    B1's and B4's launches."""
    import torch

    import messyerraytracer_tpu_torch as mrt
    from messyerraytracer_tpu_torch.core.brute import parity
    from messyerraytracer_tpu_torch.parallel.dryrun import dryrun_multichip
    from messyerraytracer_tpu_torch.parallel.sharding import (
        _replicas, _shard_bounds, _shard_cast, build_sharded_scene,
        cast_rays_scene_sharded, cast_rays_sharded, make_mesh,
        render_step_sharded)

    cards = make_mesh()
    n_dev = len(cards)
    check(len(set(cards)) == n_dev > 1, f"make_mesh(): {cards}")
    one = make_mesh(n_dev, devices=[device] * n_dev)
    flat, pallas, rays = ctx["flat"], ctx["pallas"], ctx["rays"]
    b1 = b4 = 0
    ms = {}
    for name, scene in (("B1", flat), ("B4", pallas)):
        want = cast_rays_sharded(rays, scene, one)
        reset_launches()
        got = cast_rays_sharded(rays, scene, cards)
        l1, l4 = read_launches()
        b1, b4 = b1 + l1, b4 + l4
        check(same_hits(got[0], want[0]) and torch.equal(got[2], want[2])
              and all(int(getattr(got[1], f)) == int(getattr(want[1], f))
                      for f in ("tri_tests", "bvh_nodes_visited", "hits",
                                "stack_drops")),
              f"sharded on {n_dev} cards == on {n_dev} x {device} ({name})")
        for label, mesh in (("cards", cards), ("one card", one)):
            ms[f"{name} call, {label}"] = all_cards_s(
                lambda: cast_rays_sharded(rays, scene, mesh), 3) * 1e3
            # the casts alone: tables and rays already on each shard's card
            tables = _replicas(
                scene.cluster if name == "B1" else scene.wide, mesh)
            parts = [(tables[k], rays.take(slice(s, e)).to(mesh[k]))
                     for k, s, e in _shard_bounds(rays.count, n_dev)]
            ms[f"{name} casts only, {label}"] = all_cards_s(
                lambda: [_shard_cast(t, r, -1, False) for t, r in parts],
                3) * 1e3
    stacked, meta, id_maps = build_sharded_scene(ctx["world_tris"], n_dev,
                                                 cards)
    reset_launches()
    hss, sss = cast_rays_scene_sharded(rays, stacked, meta, id_maps, cards)
    l1, l4 = read_launches()
    b1, b4 = b1 + l1, b4 + l4
    check(int(sss.stack_drops) == 0 and parity(hss, ctx["pallas_frame"][0])
          and parity(cast_rays_scene_sharded(ctx["sub"], stacked, meta,
                                             id_maps, cards)[0], ctx["hb"]),
          f"scene-sharded on {n_dev} cards: parity vs the pallas frame and "
          f"brute")
    ms["scene-sharded call, cards"] = all_cards_s(
        lambda: cast_rays_scene_sharded(rays, stacked, meta, id_maps,
                                        cards), 3) * 1e3
    cam = mrt.CameraParams.look_at((0, 26, 55), (0, 1, 0), fov_degrees=60.0)
    lights, env, mats = shading(device)
    step = {"lights": lights, "env": env, "materials": mats,
            "max_bounces": 1}
    if img_ref is None:
        img_ref = render_step_sharded(flat, cam, *FRAME, one, **step)
    reset_launches()
    img = render_step_sharded(flat, cam, *FRAME, cards, **step)
    r1, r4 = read_launches()
    read_camera("render_step_sharded")
    check(bit_equal(img, img_ref), f"render_step_sharded on {n_dev} cards "
          f"== on {n_dev} x {device} bit for bit")
    ms["render step, cards"] = all_cards_s(
        lambda: render_step_sharded(flat, cam, *FRAME, cards, **step),
        1) * 1e3
    reset_launches()
    dry = dryrun_multichip(n_dev)
    d1, d4 = read_launches()
    read_camera("dryrun_multichip")
    print(f"[{card}] phase 7e {n_dev} cards {[str(d) for d in cards]}: "
          f"ray-sharded (B1, B4), the render step and the scene-sharded "
          f"cast == / parity with the same on {n_dev} x {device}; "
          f"dryrun_multichip({n_dev}) {json.dumps(dry)}; ms "
          f"{json.dumps(ms)}", flush=True)
    return b1 + r1 + d1, b4 + r4 + d4


def phase_frontier_card_vs_cpu(card: str, device) -> None:
    """Phase 7d: frontier, frontier_q and the two-level fast cast on the
    card and on the CPU, bit for bit on t, u, v, prim ids, instance ids and
    the per-ray counters."""
    import torch

    from messyerraytracer_tpu_torch.accel.frontier import (
        cast_rays_frontier)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    cpu = torch.device("cpu")
    tris, layers = small_flat_tris()
    fields = ("t", "u", "v", "prim_id", "hit_layers")
    for backend in ("frontier", "frontier_q"):
        res = []
        for dev in (device, cpu):
            scene = build_scene_from_tri_array(tris, layers=layers,
                                               backend=backend, device=dev)
            rays = random_rays(SMALL_RAYS, 31, 8.0, dev)
            fs = scene._frontier_for_backend()
            res.append([cast_rays_frontier(rays, fs, scene.tris, mask, ah,
                                           return_per_ray_stats=True)
                        for mask, ah in ((-1, False), (0b10, False),
                                         (-1, True))])
        for (ha, _, oa, pa), (hc, _, oc, pc) in zip(*res):
            check(all(bit_equal(getattr(ha, f), getattr(hc, f))
                      for f in fields) and torch.equal(oa.cpu(), oc)
                  and all(torch.equal(pa[k].cpu(), pc[k]) for k in pa),
                  f"{backend}: card == CPU bit for bit")
    res = []
    for dev in (device, cpu):
        tlas = small_tlas(dev)
        rays = random_rays(SMALL_RAYS, 37, 8.0, dev)
        res.append([tlas.cast_rays_two_level_fast(rays, mask, ah)
                    for mask, ah in ((-1, False), (0b01, False),
                                     (-1, True))])
    for (ha, sa, oa, ia), (hc, sc, oc, ic) in zip(*res):
        check(all(bit_equal(getattr(ha, f), getattr(hc, f)) for f in fields)
              and torch.equal(oa.cpu(), oc) and torch.equal(ia.cpu(), ic)
              and int(sa.tri_tests) == int(sc.tri_tests)
              and int(sa.bvh_nodes_visited) == int(sc.bvh_nodes_visited),
              "two-level fast: card == CPU bit for bit")
    print(f"[{card}] phase 7d frontier, frontier_q (closest, layer mask, "
          f"any hit) and cast_rays_two_level_fast on {SMALL_RAYS} rays: "
          f"card == CPU bit for bit on t, u, v, prims, layers, instance "
          f"ids and counters", flush=True)


# ---------------------------------------------------------------------------
# phase 8: the demo gallery
# ---------------------------------------------------------------------------

# how a demo's u8 image on the card may differ from the CPU's.  The debug
# normals and the layer masks come straight from B1's outputs (bit-equal
# to the plain version's) and must be equal.  Shaded frames may round a
# channel one level apart where the card's and the CPU's transcendental
# functions differ in the last ulp: on an H100 at 700 W, 1 pixel of
# 76,800 (0.0013%) of the normal-mapped AOV, in each of two runs.  The
# path-traced Cornell box draws the same PCG32 streams on both sides and
# was equal on every pixel of 27,648 in the same two runs.  The shares
# below leave room over those readings while still failing a wrong
# shading or bounce path, which moves far more pixels.
EXACT_IMAGES = ("raytracer", "layer")
RASTER_SHARE = 0.0005       # shaded frames: share of pixels that differ
PT_IMAGES = ("gi_comparison",)
PT_SHARE = 0.001            # the path-traced frame: share that differ
IMAGE_RULE = (f"images {EXACT_IMAGES} equal; every other image every "
              f"pixel within 1 level, shaded frames at most "
              f"{RASTER_SHARE:.2%} and path-traced {PT_IMAGES} at most "
              f"{PT_SHARE:.1%} of pixels differing")
HUD_TIMES = ("elapsed_ms", "seconds", "raygen_ms", "trace_ms", "shadow_ms",
             "shade_ms")


def u8_diff(a: np.ndarray, b: np.ndarray) -> tuple[int, float, float]:
    """(largest level difference, share of pixels more than 1 level
    apart, share of pixels that differ) of two (H, W, 3) u8 images."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1)
    return int(d.max()), float((d > 1).mean()), float((d > 0).mean())


def image_ok(name: str, diff) -> bool:
    top, _, any_ = diff
    if name in EXACT_IMAGES:
        return top == 0
    share = PT_SHARE if name in PT_IMAGES else RASTER_SHARE
    return top <= 1 and any_ <= share


def same_hud(a, b, key="") -> bool:
    """HUD numbers equal, integers exactly, floats within the parity rtol
    1e-5; times are not compared."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            k in HUD_TIMES or same_hud(a[k], b[k], k) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_hud(x, y, key)
                                        for x, y in zip(a, b))
    if isinstance(a, float):
        return a == b or abs(a - b) <= 1e-5 * abs(b)
    return a == b


class _Waves:
    """A scene that records the rays of its closest-hit casts."""

    def __init__(self, scene):
        self.scene, self.waves = scene, []

    def cast_rays(self, rays, *a, **kw):
        self.waves.append(rays)
        return self.scene.cast_rays(rays, *a, **kw)

    def any_hit_rays(self, *a, **kw):
        return self.scene.any_hit_rays(*a, **kw)


def phase_gallery(card: str, device) -> int:
    """Phase 8: every demo of the gallery on the card at its own size,
    held against the same demo on the CPU, and B1 against its plain
    version on the gallery's own ray sets.  Returns B1's launches."""
    import torch

    from messyerraytracer_tpu_torch.demos import run_demos
    from messyerraytracer_tpu_torch.render.pathtrace import PathTraceParams

    cpu = torch.device("cpu")
    print(f"[{card}] phase 8 image rule: {IMAGE_RULE}", flush=True)
    total = 0
    for name, demo in run_demos.DEMOS.items():
        # ---- the demo's own run: counts reset just before, read after
        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res, paths = run_demos.run_demo(name, device)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        b1, b4 = read_launches()
        read_camera("demos")
        check(b1 > 0 and b4 == 0, f"{name}: ran B1 ({b1}), not B4 ({b4})")
        total += b1
        check(buf.getvalue() == "".join(x + "\n" for x in res.lines),
              f"{name}: printed its HUD lines")
        ref = demo(cpu)
        check(same_hud(res.hud, ref.hud),
              f"{name}: HUD card == CPU ({res.hud} against {ref.hud})")
        check(res.images.keys() == ref.images.keys()
              and len(paths) == len(res.images), f"{name}: images written")
        diffs = {}
        for stem, img in res.images.items():
            check(img.shape == ref.images[stem].shape
                  and img.dtype == np.uint8, f"{stem}: u8 image shape")
            diffs[stem] = u8_diff(img, ref.images[stem])
            check(image_ok(name, diffs[stem]),
                  f"{stem}: card against CPU {diffs[stem]} (largest level "
                  f"difference, share > 1 level, share differing) breaks "
                  f"the rule")
        hud = " | ".join(x.strip() for x in res.lines) or "(no HUD line)"
        print(f"[{card}] phase 8 {name}: {ms} ms wall, B1 launches {b1}; "
              f"HUD {hud}; card against CPU: HUD equal, images (largest "
              f"level difference, share > 1 level, share differing) "
              f"{json.dumps(diffs)}", flush=True)

    # ---- B1 against its plain version on the gallery's own ray sets
    scene, rays = run_demos.layer_scene(device)
    for mask in (0b01, 0b10):
        err, plain_ms, st = compare_kernel_plain(rays, scene.cluster,
                                                 query_mask=mask)
        print(f"[{card}] phase 8 B1 on the layer demo's {rays.count} rays, "
              f"query_mask {mask:#04b}: kernel == plain, max_abs_err {err}, "
              f"plain {plain_ms} ms", flush=True)
    pt, rays = run_demos.gi_tracer(device)
    pt.scene = _Waves(pt.scene)
    pt.trace_frame(PathTraceParams(run_demos.GI_W, run_demos.GI_H, 3,
                                   sample_index=0), rays)
    wave = pt.scene.waves[1]
    dead = int((wave.t_max < wave.t_min).sum())
    check(dead > 0, "gi bounce 1 wave holds dead rays")
    err, plain_ms, st = compare_kernel_plain(wave, pt.scene.scene.cluster)
    print(f"[{card}] phase 8 B1 on the Cornell box's bounce 1 wave "
          f"({wave.count} rays, {dead} dead): kernel == plain, max_abs_err "
          f"{err}, plain {plain_ms} ms", flush=True)
    return total


def phase_multi(card: str, device, ctx: dict) -> dict:
    """Phase 7: the frontier backends, the two-level casts and the
    multi-device casts.  Returns B1's and B4's launches from its paths'
    own runs."""
    phase_frontier(card, device, ctx)
    b1 = phase_two_level(card, device, ctx)
    p = phase_sharding(card, device, ctx)
    phase_frontier_card_vs_cpu(card, device)
    return {"b1": b1 + p["b1"], "b4": p["b4"]}


@contextlib.contextmanager
def plain_b1():
    """Route every cluster cast to B1's plain version, on any device."""
    from messyerraytracer_tpu_torch.kernels import cluster_v2

    routed = cluster_v2.cluster_cast

    def plain(rays, cs, query_mask=-1, any_hit=False, kstack=None):
        return cluster_v2.cluster_cast_plain(
            rays.origin, rays.direction, rays.t_min, rays.t_max, cs,
            query_mask, any_hit, kstack, chunk=1 << 20)

    cluster_v2.cluster_cast = plain
    try:
        yield
    finally:
        cluster_v2.cluster_cast = routed


def phase_bench(card: str, device, ctx: dict) -> int:
    """Phase 9: the port's headline benchmark
    (``messyerraytracer_tpu_torch/bench.py``, the counterpart of the JAX
    package's bench.py) at full size through ``bench.run``: its JSON line
    on a progress line; every parity flag true, no stack drop at 2M, the
    headline scene's size, the key set and finite numbers checked; its
    headline frame beside phase 2's instanced cast.  Then B1 held bit for
    bit against its plain version on every B1 tier's own rays (the 2M and
    99K 1024x768 frames, the incoherent batch in the dispatcher's sorted
    order), both 640x480 path-traced frames traced with B1 and with its
    plain version (wave rays equal), and the 99K one timed with its
    coherence sort carried, per wave and off.  Returns B1's launches of
    ``bench.run``."""
    import torch

    from messyerraytracer_tpu_torch import bench
    from messyerraytracer_tpu_torch.dispatch.dispatcher import RayDispatcher
    from messyerraytracer_tpu_torch.render.wavefront import (
        WavefrontPathTracer)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    # ---- the bench's own run: counts reset just before, read after
    B1.launches = 0
    reset_camera()
    t0 = time.time()
    out = bench.run(device)
    torch.cuda.synchronize()
    launches = B1.launches
    cam_launches = read_camera("bench.run")
    e = out["extra"]
    print(f"[{card}] phase 9 bench.run {time.time() - t0} s, B1 launches "
          f"{launches}, camera launches {cam_launches}; line: "
          f"{json.dumps(out)}", flush=True)
    check(list(e) == list(bench.EXTRA_KEYS), "bench keys == EXTRA_KEYS")
    check((out["metric"], out["unit"]) == (bench.METRIC, bench.UNIT),
          "bench metric and unit")
    flags = {k: v for k, v in e.items() if k.startswith("parity_")}
    check(len(flags) == 4 and all(v is True for v in flags.values()),
          f"bench parity flags {flags}")
    check(e["stack_drops_2m"] == 0, "bench stack_drops_2m == 0")
    check((e["instances"], e["tlas_world_tris"])
          == (HEADLINE_INSTANCES, HEADLINE_WORLD_TRIS), "bench headline")
    check(launches > 0, "bench launched kernel B1")
    check(device.type != "cuda" or e["device"] == card, "bench device")
    numbers = [out["value"], out["vs_baseline"],
               *e["build_phase_s"].values(),
               *(v for v in e.values() if isinstance(v, (int, float)))]
    check(all(math.isfinite(v) for v in numbers), "bench numbers finite")
    print(f"[{card}] phase 9 headline frame {e['frame_ms']} ms (host clock, "
          f"bench) against phase 2's {ctx['instanced_ms']} ms (CUDA "
          f"events): ratio {e['frame_ms'] / ctx['instanced_ms']}",
          flush=True)

    # ---- B1 against its plain version on each B1 tier's own rays
    def held(what, rays, cs):
        err, plain_ms, st = compare_kernel_plain(rays, cs, chunk=1 << 20)
        print(f"[{card}] phase 9 B1 on {what} ({rays.count} rays, "
              f"T={cs.tcap}, stack_need {cs.stack_need}): kernel == plain, "
              f"max_abs_err {err}, plain {plain_ms} ms; lane occupancy "
              f"{occupancy(st)}", flush=True)

    scene2m = build_scene_from_tri_array(bench.tris_2m(), device=device)
    held("the 2M frame", block_swizzled_frame_rays(
        *bench.FRAME_2M, bench.camera_99k(), device), scene2m.cluster)
    del scene2m
    scene = build_scene_from_tri_array(bench.tris_99k(), device=device)
    held("the 99K frame", block_swizzled_frame_rays(
        *bench.FRAME_99K, bench.camera_99k(), device), scene.cluster)
    srt, _ = RayDispatcher(scene)._sorted(bench.incoherent_rays(device))
    held("the incoherent batch in the dispatcher's sorted order", srt,
         scene.cluster)

    # ---- both path-traced frames traced with B1 and with its plain version
    tlas, _ = bench.headline_tlas(device)
    shading = bench.pt_shading(device)
    pts = {"99K": (WavefrontPathTracer(scene, *shading), bench.camera_99k()),
           "instanced": (WavefrontPathTracer(tlas.instanced_scene(),
                                             *shading),
                         bench.headline_camera())}
    for name, (pt, cam) in pts.items():
        prays = block_swizzled_frame_rays(*bench.PT_FRAME, cam, device)

        def frame():
            return pt.trace_frame(prays, bench.PT_BOUNCES, bench.PT_SAMPLE,
                                  with_counts=True)

        img, wave = frame()
        with plain_b1():
            img_p, wave_p = frame()
        diff = float((img - img_p).abs().max())
        print(f"[{card}] phase 9 PT {name} frame: wave rays {int(wave)} with "
              f"B1, {int(wave_p)} with its plain version; max_abs_err {diff}",
              flush=True)
        check(int(wave) == int(wave_p), f"PT {name} wave rays: B1 == plain")
        check(name != "99K" or int(wave) == e["pt_wave_rays"],
              "PT 99K wave rays == bench's")
        check(diff < 1e-4, f"PT {name} frame B1 against plain, max |diff| "
                           f"{diff}")

    # ---- the 99K PT frame's coherence sort: carried, per wave, none; the
    # same frame, in turns (A B C C B A), host clock as the bench
    pt, bounds = pts["99K"][0], pts["99K"][0].bounds
    prays = block_swizzled_frame_rays(*bench.PT_FRAME, bench.camera_99k(),
                                      device)
    variants = {"carried": (True, bounds), "per wave": (False, bounds),
                "unsorted": (False, None)}
    secs = {k: 0.0 for k in variants}
    outs = {}
    for name in [*variants, *reversed(variants)]:
        carried, pt.bounds = variants[name]
        dt, outs[name] = bench.timed(
            lambda: pt._trace_frame_stages(
                prays, bench.PT_BOUNCES, bench.PT_SAMPLE, with_counts=True,
                carried=carried), bench.PT_ITERS, device)
        secs[name] += dt / 2
    pt.bounds = bounds
    for name, (img, wave) in outs.items():
        diff = float((img - outs["carried"][0]).abs().max())
        check(int(wave) == int(outs["carried"][1]) and diff < 1e-4,
              f"PT 99K {name} == carried (max |diff| {diff})")
    print(f"[{card}] phase 9 PT 99K frame by coherence sort (ms a frame, "
          f"host clock, {bench.PT_ITERS} x 2 calls each): "
          f"{json.dumps({k: v * 1e3 for k, v in secs.items()})}", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    t_start = time.time()
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    device = torch.device("cuda", 0)
    build_kernels(card)
    phase_kernel_vs_plain(card, device)
    cam_ms = phase_camera(card, device)
    key_ms = phase_morton(card, device)
    k1, ctx = phase_main_path(card, device)
    phase_wide_vs_plain(card, device)
    k4 = phase_pallas_path(card, device, ctx)
    t5 = time.time()
    p5 = phase_service(card, device, ctx)
    p5["b1"] += phase_renderer(card, device, ctx)
    p5["b1"] += phase_path_tracers(card, device, ctx)
    phase_card_vs_cpu(card, device)
    print(f"[{card}] phase 5 (serving and rendering) {time.time() - t5} s; "
          f"B1 launches {p5['b1']}, B4 launches {p5['b4']}", flush=True)
    t6 = time.time()
    p6 = phase_dynamic(card, device, ctx)
    print(f"[{card}] phase 6 (dynamic scenes, debug, checkpoints) "
          f"{time.time() - t6} s; B1 launches {p6['b1']}, B4 launches "
          f"{p6['b4']}", flush=True)
    t7 = time.time()
    p7 = phase_multi(card, device, ctx)
    print(f"[{card}] phase 7 (frontier, two-level, multi-device) "
          f"{time.time() - t7} s; B1 launches {p7['b1']}, B4 launches "
          f"{p7['b4']}", flush=True)
    t8 = time.time()
    p8 = phase_gallery(card, device)
    print(f"[{card}] phase 8 (demo gallery) {time.time() - t8} s; B1 "
          f"launches {p8}", flush=True)
    t9 = time.time()
    p9 = phase_bench(card, device, ctx)
    print(f"[{card}] phase 9 (the port's bench) {time.time() - t9} s; B1 "
          f"launches {p9}", flush=True)
    k1["launches"] += p5["b1"] + p6["b1"] + p7["b1"] + p8 + p9
    k4["launches"] += p5["b4"] + p6["b4"] + p7["b4"]
    print(f"[{card}] camera kernel launches by path {json.dumps(CAMERA_RUNS)}",
          flush=True)
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
         **k4},
        {"name": "camera_rays (one thread a ray, 16-byte stores)",
         "route": "cuda", "source": src + "camera_rays.cu",
         "replaces": "none (messyerraytracer_tpu/render/camera.py is jnp)",
         "launches": sum(CAMERA_RUNS.values()),
         "ms": {k: v[0] for k, v in cam_ms.items()},
         "plain_ms": {k: v[2] for k, v in cam_ms.items()},
         "bound_ms": {k: v[3] for k, v in cam_ms.items()},
         "bound_by": "bytes"},
        {"name": "morton_keys (M1: one thread a ray, every step in "
                 "registers)", "route": "cuda",
         "source": src + "morton_keys.cu",
         "replaces": "none (messyerraytracer_tpu/dispatch/morton.py is "
                     "jnp)",
         "ms": {k: v[0] for k, v in key_ms.items()},
         "plain_ms": {k: v[2] for k, v in key_ms.items()},
         "bound_ms": {k: v[3] for k, v in key_ms.items()},
         "bound_by": "bytes"}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
