"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that
the port still builds and runs its main path on the GPU.

    python3 chip_smoke.py

Builds kernel B1 (kernels/csrc/cluster_cast.cu, nvcc -> ctypes) from the
checkout, then:

  1. holds the kernel against its plain PyTorch version on the card, on
     test-sized flat and instanced scenes (closest hit, any hit, a layer
     mask, dead and zero-direction rays, a forced small stack): hits by
     the parity rule, counters and stack_drops exactly;
  2. drives the main path at full size — the 1M-triangle instanced TLAS
     of the JAX package's bench.py headline (4 meshes, 215 instances),
     one block-swizzled 1920x1080 frame through
     ``SceneTLAS.cast_rays_instanced`` and through the flat twin
     ``build_scene_from_tri_array(world_tris).cast_rays`` — counts the
     kernel launches of that run, checks both casts on a 4096-ray
     subsample against the brute oracle, and holds the kernel against its
     plain version on the whole frame at both shapes (instanced T=64 and
     flat T=64), timing each.

Every number is printed beside the card's name and power limit.  The last
two lines are the kernel summary and the result, both JSON.  Exits
non-zero, printing no result, when there is no CUDA card or any check
fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

FRAME = (1920, 1080)


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


def random_rays(n: int, seed: int, extent: float, device):
    """Random rays from a seed, with dead rays (t_max < t_min) and
    zero-direction rays mixed in."""
    from messyerraytracer_tpu_torch.core.types import make_rays

    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 4.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::101] = 0.0
    t_max = np.full(n, 3.402823466e38, np.float32)
    t_max[::97] = -1.0
    return make_rays(o, d, t_max=t_max, device=device)


def compare_kernel_plain(rays, cs, chunk=None, **kw):
    """Run kernel and plain version on the same rays; check the hits by
    the parity rule and every counter exactly.  Returns the largest
    absolute difference of the float outputs and the plain version's ms
    (host clock, fenced by synchronization)."""
    import torch

    from messyerraytracer_tpu_torch.core.brute import parity
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        PLAIN_CHUNK, _hits_from_buffers_v2, cluster_cast_cuda,
        cluster_cast_plain)

    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, cs)
    fk, ik, ck = cluster_cast_cuda(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.time()
    fp, ip, cp = cluster_cast_plain(*args, chunk=chunk or PLAIN_CHUNK, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    hk = _hits_from_buffers_v2(fk, ik, rays)[0]
    hp = _hits_from_buffers_v2(fp, ip, rays)[0]
    check(parity(hk, hp), f"kernel vs plain parity {kw}")
    check(torch.equal(ik[2], ip[2]) and torch.equal(ik[4], ip[4]),
          f"per-ray tri_tests / node_visits kernel == plain {kw}")
    check(torch.equal(ck, cp), f"pops/stack_drops kernel == plain {kw}")
    same = hk.hit == hp.hit
    check(bool(torch.equal(ik[1][same], ip[1][same])),
          f"layers kernel == plain {kw}")
    check(bool(torch.equal(ik[3][same], ip[3][same])),
          f"instance ids kernel == plain {kw}")
    err = float((fk - fp).abs().max()) if fk.numel() else 0.0
    return err, plain_ms


def small_scenes(device):
    from messyerraytracer_tpu_torch.kernels.cluster_tlas import (
        build_cluster_tlas)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)
    from messyerraytracer_tpu_torch.utils import meshes

    g = meshes.plane(16.0, y=0.0, subdiv=80)
    g[:, :, 1] = np.sin(g[:, :, 0]) * 0.6
    sph = meshes.uv_sphere(2.0, 48, 96, center=(0, 2.5, 0))
    layers = np.concatenate([np.full(len(g), 0b01, np.int32),
                             np.full(len(sph), 0b10, np.int32)])
    flat = build_scene_from_tri_array(np.concatenate([g, sph]),
                                      layers=layers, device=device)

    def xform(t, s=1.0):
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.eye(3) * s
        m[:, 3] = t
        return m

    inst = [(0, xform((x, 0.0, z), 0.4)) for x in range(-4, 5, 2)
            for z in range(-4, 5, 2)]
    inst += [(1, xform((-3, 0, 0), 1.2)), (1, xform((3, 0.5, -1), 0.5))]
    ct = build_cluster_tlas(
        [meshes.uv_sphere(1.0, 16, 32), meshes.box((1.0, 2.0, 1.0))],
        inst, tcap=32, device=device)
    return flat, ct


def phase_kernel_vs_plain(card: str, device) -> None:
    """Phase 1: kernel B1 against its plain version on the card."""
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        cluster_cast_cuda)

    flat, ct = small_scenes(device)
    before = cluster_cast_cuda.launches
    worst = 0.0
    for name, cs, extent in (("flat", flat.cluster, 8.0),
                             ("instanced", ct, 5.0)):
        rays = random_rays(8192, 1, extent, device)
        for kw in ({}, {"any_hit": True}, {"query_mask": 0b10},
                   {"kstack": 1}):
            err, _ = compare_kernel_plain(rays, cs, **kw)
            worst = max(worst, err)
            print(f"[{card}] phase 1 {name} {kw or 'closest'}: kernel == "
                  f"plain, max_abs_err {err}", flush=True)
        _, _, counters = cluster_cast_cuda(
            rays.origin, rays.direction, rays.t_min, rays.t_max, cs,
            kstack=1)
        check(int(counters[1]) > 0, f"{name}: forced small stack drops")
    check(cluster_cast_cuda.launches > before, "kernel launch count rose")
    print(f"[{card}] phase 1 ok: worst max_abs_err {worst}", flush=True)


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
    import messyerraytracer_tpu_torch as mrt
    from messyerraytracer_tpu_torch.dispatch.morton import (
        raster_block_permutation)

    w, h = FRAME
    cam = mrt.CameraParams.look_at((0, 26, 55), (0, 1, 0), fov_degrees=60.0)
    perm = raster_block_permutation(w, h, 32)
    return mrt.generate_rays(cam, w, h).take(perm).to(device)


def phase_main_path(card: str, device) -> dict:
    """Phase 2: the headline main path at full size."""
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

    # ---- kernel B1 against its plain version at both frame shapes; the
    # summary keeps the instanced times and the larger error of the two
    k = {"launches": launches, "max_abs_err": 0.0}
    for name, cs in (("instanced", tlas._ctlas), ("flat", flat.cluster)):
        args = (rays.origin, rays.direction, rays.t_min, rays.t_max, cs)
        ms = cuda_ms(lambda: cluster_cast_cuda(*args), 5)
        err, plain_ms = compare_kernel_plain(rays, cs, chunk=1 << 20)
        print(f"[{card}] kernel B1 {name} frame (T={cs.tcap}): kernel "
              f"{ms} ms, plain {plain_ms} ms, kernel == plain, max_abs_err "
              f"{err}", flush=True)
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if name == "instanced":
            k["ms"], k["plain_ms"] = ms, plain_ms
    return k


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card "
                         "(torch.cuda.is_available() is false)")
    # fails here, before printing anything, outside a checkout of the repo
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import cuda_library

    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    device = torch.device("cuda", 0)
    t0 = time.time()
    cuda_library()
    print(f"[{card}] kernel build {time.time() - t0} s", flush=True)
    phase_kernel_vs_plain(card, device)
    k = phase_main_path(card, device)
    print(json.dumps({"kernels": [{
        "name": "cluster_cast",
        "route": "cuda",
        "source": "messyerraytracer_tpu_torch/kernels/csrc/cluster_cast.cu",
        "replaces": "messyerraytracer_tpu/kernels/cluster_v2.py:81 "
                    "(+ messyerraytracer_tpu/kernels/cluster.py:1262, "
                    "fused)",
        **k}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
