"""Headline benchmark of the port: the counterpart of the repo's root
bench.py (the JAX package's benchmark), on one CUDA card.

    python -m messyerraytracer_tpu_torch.bench

Prints ONE JSON line with bench.py's shape (bench.py:376-382):
``{"metric": "primary_ray_throughput_1m_instanced_tlas_1080p", "value":
Mrays/s, "unit": "Mrays/s", "vs_baseline": value / 27.0, "extra": {...}}``.
Progress lines, with unrounded times and each tier's kernel B1 launches,
go to standard error.  It needs a card: ``run()`` raises without one, and
only ``run(device="cpu")`` (the tests, at patched sizes) runs the plain
versions.

The tiers, at bench.py's own sizes, seeds and iteration counts (the
module constants below, one group per tier):

  headline   the 1M-triangle instanced TLAS (4 meshes, 215 instances,
             seed 11; bench.py:118-167) and its flat twin, one
             block-swizzled 1920x1080 frame through each, parity of both
             against brute on a 4096-ray strided subsample, the frontier
             backend's per-ray tri_tests on 2048 rays (:169-231);
  warm       a second build of the flat twin and of the instanced tables
             (:233-244).  The port builds on the host and compiles
             nothing per shape, so "warm" is the second build in the same
             process;
  99K        the composite ~99K scene at 1024x768 (:246-282);
  2M         the 2M-triangle terrain at 1024x768, parity and stack drops
             (:284-305);
  incoherent 524,288 random rays through ``RayDispatcher`` (:307-323);
  PT         640x480 wavefront path-traced frames, 3 bounces, on the 99K
             scene and on the instanced headline scene (:325-374).

Every cast of a cluster scene runs kernel B1 (``cluster_cast_cuda``) on
the card.  Timing (``timed``): one warm-up call, ``torch.cuda.synchronize``,
the host clock around ``iters`` calls, ``synchronize``: bench.py's wall
time per call, fenced the way CUDA fences.

Two keys keep bench.py's names and change their meaning, as in the rest
of the port: ``tri_per_ray_1m`` counts B1's triangle tests per ray
(~54 on the headline frame), where the JAX kernel counted a 2048-ray
tile's row footprint (191.2); ``pops_99k`` sums per-ray node pops, where
JAX counted a tile's pops.  ``TPU_ONLY_KEYS`` names the keys of bench.py
that are not computed here, with the reason.  bench.py turns a failed
frontier cast into nan and a failed path-traced tier into ``pt_error``;
here every tier raises, and the run exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from .accel.frontier import cast_rays_frontier
from .accel.tlas import SceneTLAS
from .core.brute import cast_rays_brute, parity
from .core.types import DEFAULT_DEVICE, Rays, make_rays
from .dispatch.dispatcher import RayDispatcher
from .dispatch.morton import raster_block_permutation
from .kernels import cluster_v2
from .render.camera import CameraParams, generate_rays
from .render.shade import (
    LIGHT_DIRECTIONAL,
    default_materials,
    make_environment,
    make_lights,
)
from .render.wavefront import WavefrontPathTracer
from .scene.scene import build_scene_from_tri_array
from .utils import meshes

METRIC = "primary_ray_throughput_1m_instanced_tlas_1080p"
UNIT = "Mrays/s"
BASELINE_CPU_MRAYS = 27.0  # the reference's SSE + thread-pool path

# headline (bench.py:118-231)
FRAME = (1920, 1080)
EYE, TARGET, FOV = (0, 26, 55), (0, 1, 0), 60.0
TERRAIN_SUBDIV = 100       # 20K triangles a tile, 16 tiles
SPHERE_HI = 64             # rings = segments: 8,064 triangles, 60 copies
SPHERE_LO = 32             # 1,984 triangles, 99 copies
SCENE_SEED = 11
PARITY_RAYS = 4096
EXACT_RAYS = 2048          # the frontier's per-ray-exact subsample
ITERS = 5

# the ~99K flat scene (bench.py:246-282)
FRAME_99K = (1024, 768)
EYE_99K, TARGET_99K = (0, 14, 30), (0, 2, 0)
GROUND_SUBDIV_99K = 158
SPHERE_99K = 112
BOXES_99K = 2000
SEED_99K = 7
ITERS_99K = 10

# the 2M-triangle capacity tier (bench.py:284-305), on the 99K camera
SUBDIV_2M = 1004
FRAME_2M = (1024, 768)
PARITY_RAYS_2M = 2048
ITERS_2M = 2

# incoherent rays through the dispatcher (bench.py:307-323)
INCOHERENT_RAYS = 512 * 1024
SEED_INCOHERENT = 3
ITERS_INCOHERENT = 3

# wavefront path-traced frames (bench.py:325-374)
PT_FRAME = (640, 480)
PT_BOUNCES = 3
PT_SAMPLE = 1
PT_ITERS = 3

# triangles per step of the brute oracle (chip_smoke.py's 1M subsample)
BRUTE_CHUNK = 8192

# keys of bench.py's extra that this module does not compute
TPU_ONLY_KEYS = {
    "issued_vpu_gflop_per_frame": "a cost model of the TPU's VPU (pops x "
                                  "8 children x 27 flops x 2048 lanes, "
                                  "bench.py:270-273); B1 runs one ray per "
                                  "CUDA thread",
    "vpu_peak_frac": "that model over the v5e VPU's 3.9 TFLOP/s peak "
                     "(bench.py:281); no H100 counterpart is defined",
}

# the keys of extra, in bench.py's order
EXTRA_KEYS = (
    "device", "instances", "meshes", "tlas_world_tris", "rays", "frame_ms",
    "parity_tlas_vs_brute", "hit_rate", "build_tlas_s", "build_phase_s",
    "mrays_1m_flat", "parity_1m_flat", "build_1m_flat_s",
    "instanced_vs_flat", "tri_per_ray_1m", "tri_per_ray_exact_1m",
    "build_1m_warm_s", "build_instanced_warm_s", "mrays_99k_flat",
    "parity_99k", "tris_99k", "pops_99k", "tri_per_ray_99k",
    "mrays_2m_tris", "parity_2m", "stack_drops_2m", "stack_need_2m",
    "tris_2m", "mrays_incoherent_512k", "pt_frame_ms_640x480_3b",
    "pt_wave_rays", "pt_mrays", "pt_instanced_frame_ms_640x480_3b",
    "pt_instanced_mrays",
)


def card_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# kernel B1's library, whose ``launches`` the progress lines read
_B1 = cluster_v2.cuda_library


def _say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def headline_camera() -> CameraParams:
    return CameraParams.look_at(EYE, TARGET, fov_degrees=FOV)


def camera_99k() -> CameraParams:
    """The camera of the 99K, 2M and 99K path-traced frames."""
    return CameraParams.look_at(EYE_99K, TARGET_99K, fov_degrees=FOV)


def block_swizzled_frame_rays(w: int, h: int, cam: CameraParams,
                              device=DEFAULT_DEVICE) -> Rays:
    """A w x h camera frame in 32x32 raster blocks (bench.py:34-45): the
    dispatcher's coherent order."""
    perm = torch.as_tensor(raster_block_permutation(w, h, 32),
                           device=device).long()
    return generate_rays(cam, w, h, device=device).take(perm)


def subsample(rays: Rays, n: int) -> Rays:
    """``n`` rays strided over the whole batch (bench.py:48-56): the first
    rays of a block-swizzled frame are the top-left sky blocks."""
    idx = torch.arange(n, device=rays.origin.device) * (rays.count // n)
    return rays.take(idx)


def timed(fn, iters: int, device: torch.device):
    """(seconds per call, last output): one warm-up call, synchronize,
    the host clock around ``iters`` calls, synchronize."""
    out = fn()
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _fence(device)
    return (time.perf_counter() - t0) / iters, out


def _xf(tx, ty, tz, s=1.0) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    m[:3, 3] = (tx, ty, tz)
    return m


def headline_recipe():
    """The headline scene without a build (bench.py:122-157): its 4
    object-space meshes (terrain, sphere hi, sphere lo, rock) and its 215
    instances as (mesh index, 4x4 float32 transform)."""
    terrain = meshes.plane(20.0, y=0.0, subdiv=TERRAIN_SUBDIV)
    terrain[:, :, 1] = (np.sin(terrain[:, :, 0] * 0.9)
                        * np.cos(terrain[:, :, 2] * 0.8))
    mesh_list = [terrain, meshes.uv_sphere(1.6, SPHERE_HI, SPHERE_HI),
                 meshes.uv_sphere(1.0, SPHERE_LO, SPHERE_LO),
                 meshes.box((1.4, 1.0, 1.2))]
    rng = np.random.default_rng(SCENE_SEED)
    inst = [(0, _xf((gx - 1.5) * 20, 0.0, (gz - 1.5) * 20))
            for gx in range(4) for gz in range(4)]
    for _ in range(60):
        c = rng.uniform(-35, 35, 2)
        inst.append((1, _xf(c[0], rng.uniform(1.5, 4.0), c[1],
                            s=rng.uniform(0.6, 1.4))))
    for _ in range(99):
        c = rng.uniform(-35, 35, 2)
        inst.append((2, _xf(c[0], rng.uniform(0.8, 2.5), c[1],
                            s=rng.uniform(0.5, 1.5))))
    for _ in range(40):
        c = rng.uniform(-35, 35, 2)
        inst.append((3, _xf(c[0], 0.5, c[1])))
    return mesh_list, inst


def headline_tlas(device=DEFAULT_DEVICE):
    """The headline ``SceneTLAS``, built as bench.py builds it
    (bench.py:136-164), and its build seconds: {"meshes", "flatten",
    "instanced"} (bench.py's ``build_phase_s``) and "build_tlas_s"."""
    mesh_list, inst = headline_recipe()
    times = {}
    t0 = time.time()
    tlas = SceneTLAS(backend="cluster", device=device)
    for m in mesh_list:
        tlas.add_mesh(m)
    times["meshes"] = time.time() - t0
    for blas_id, xf in inst:
        tlas.add_instance(blas_id, xf)
    t1 = time.time()
    tlas.build_tlas()
    times["flatten"] = time.time() - t1
    t1 = time.time()
    tlas.build_instanced()
    _fence(tlas.device)
    times["instanced"] = time.time() - t1
    times["build_tlas_s"] = time.time() - t0
    return tlas, times


def tris_99k() -> np.ndarray:
    """The composite ~99K scene (bench.py:248-259): a height-field ground,
    a sphere and 2000 boxes from seed 7."""
    g = meshes.plane(40.0, y=0.0, subdiv=GROUND_SUBDIV_99K)
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.6) * np.cos(g[:, :, 2] * 0.5)) * 1.5
    sph = meshes.uv_sphere(4.0, SPHERE_99K, SPHERE_99K, center=(0, 6, 0))
    rng = np.random.default_rng(SEED_99K)
    boxes = []
    for _ in range(BOXES_99K):
        c = rng.uniform(-18, 18, 2)
        hgt = rng.uniform(0.5, 4.0)
        boxes.append(meshes.box(
            (rng.uniform(0.5, 2), hgt, rng.uniform(0.5, 2)),
            center=(c[0], hgt / 2, c[1])))
    return np.concatenate([g, sph] + boxes)


def tris_2m() -> np.ndarray:
    """The 2M-triangle height-field terrain (bench.py:286-288)."""
    g = meshes.plane(40.0, y=0.0, subdiv=SUBDIV_2M)
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.7) * np.cos(g[:, :, 2] * 0.6)) * 1.5
    return g


def incoherent_rays(device=DEFAULT_DEVICE) -> Rays:
    """Random origins in +-20 (y = |y| + 0.5) and normalized Gaussian
    directions from seed 3 (bench.py:311-320)."""
    rng = np.random.default_rng(SEED_INCOHERENT)
    o = rng.uniform(-20, 20, (INCOHERENT_RAYS, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.standard_normal((INCOHERENT_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = o.shape[0]
    return make_rays(o, d, t_min=np.full(n, 1e-3, np.float32),
                     t_max=np.full(n, 3e38, np.float32), device=device)


def _brute(rays: Rays, tris):
    return cast_rays_brute(rays, tris, chunk=BRUTE_CHUNK)[0]


def _headline(device, extra: dict) -> tuple[float, SceneTLAS]:
    """The headline, its flat twin and the warm rebuilds; returns the
    headline's Mrays/s and its TLAS."""
    b1 = _B1.launches
    tlas, times = headline_tlas(device)
    world_tris = tlas._world_tris_np()
    rays = block_swizzled_frame_rays(*FRAME, headline_camera(), device)
    n = rays.count
    t0 = time.time()
    flat = build_scene_from_tri_array(world_tris, device=device)
    _fence(device)
    build_flat_s = time.time() - t0
    _say(f"headline scene: {len(tlas.instances)} instances, "
         f"{world_tris.shape[0]} world triangles, {n} rays; build s "
         f"{json.dumps(times)}, flat twin {build_flat_s}")

    sub = subsample(rays, PARITY_RAYS)
    hb = _brute(sub, flat.tris)
    parity_tlas = parity(tlas.cast_rays_instanced(sub)[0], hb)
    dt, out = timed(lambda: tlas.cast_rays_instanced(rays), ITERS, device)
    dt_flat, out_flat = timed(lambda: flat.cast_rays(rays), ITERS, device)
    parity_flat = parity(flat.cast_rays(sub)[0], hb)
    _, fstats, _ = cast_rays_frontier(subsample(rays, EXACT_RAYS),
                                      flat.frontier, flat.tris)
    tri_per_ray = float(out_flat[1].tri_tests) / n
    tri_per_ray_exact = float(fstats.tri_tests) / EXACT_RAYS
    _say(f"headline: instanced {dt * 1e3} ms/frame, flat {dt_flat * 1e3} "
         f"ms/frame, parity {parity_tlas} / {parity_flat}, tri_tests/ray "
         f"{tri_per_ray} (frontier {tri_per_ray_exact})")
    mrays = n / dt / 1e6
    extra.update({
        "instances": len(tlas.instances),
        "meshes": len(tlas.meshes),
        "tlas_world_tris": int(world_tris.shape[0]),
        "rays": n,
        "frame_ms": round(dt * 1e3, 2),
        "parity_tlas_vs_brute": parity_tlas,
        "hit_rate": round(float((out[0].prim_id >= 0).float().mean()), 3),
        "build_tlas_s": round(times["build_tlas_s"], 2),
        "build_phase_s": {k: round(times[k], 2)
                          for k in ("meshes", "flatten", "instanced")},
        "mrays_1m_flat": round(n / dt_flat / 1e6, 3),
        "parity_1m_flat": parity_flat,
        "build_1m_flat_s": round(build_flat_s, 2),
        "instanced_vs_flat": round(dt_flat / dt, 3),
        "tri_per_ray_1m": round(tri_per_ray, 1),
        "tri_per_ray_exact_1m": round(tri_per_ray_exact, 1),
    })
    del flat

    t0 = time.time()
    flat2 = build_scene_from_tri_array(world_tris, device=device)
    _fence(device)
    extra["build_1m_warm_s"] = round(time.time() - t0, 2)
    del flat2
    t0 = time.time()
    tlas.build_instanced()
    _fence(device)
    extra["build_instanced_warm_s"] = round(time.time() - t0, 2)
    _say(f"headline tier: B1 launches {_B1.launches - b1}")
    return mrays, tlas


def _flat_99k(device, extra: dict):
    """The ~99K scene at 1024x768; returns the scene for the later tiers."""
    b1 = _B1.launches
    tris = tris_99k()
    t0 = time.time()
    scene = build_scene_from_tri_array(tris, device=device)
    _fence(device)
    build_s = time.time() - t0
    rays = block_swizzled_frame_rays(*FRAME_99K, camera_99k(), device)
    sub = subsample(rays, PARITY_RAYS)
    ok = parity(scene.cast_rays(sub)[0], _brute(sub, scene.tris))
    dt, (_, stats) = timed(lambda: scene.cast_rays(rays), ITERS_99K, device)
    pops = int(stats.bvh_nodes_visited)
    extra.update({
        "mrays_99k_flat": round(rays.count / dt / 1e6, 3),
        "parity_99k": ok,
        "tris_99k": int(scene.num_tris),
        "pops_99k": pops,
        "tri_per_ray_99k": round(int(stats.tri_tests) / rays.count, 1),
    })
    _say(f"99K tier: {scene.num_tris} triangles built in {build_s} s, "
         f"{dt * 1e3} ms/frame, parity {ok}, pops/ray {pops / rays.count}; "
         f"B1 launches {_B1.launches - b1}")
    return scene


def _capacity_2m(device, extra: dict) -> None:
    b1 = _B1.launches
    tris = tris_2m()
    t0 = time.time()
    scene = build_scene_from_tri_array(tris, device=device)
    _fence(device)
    build_s = time.time() - t0
    _say(f"2M tier: tris_2m {scene.num_tris} built in {build_s} s")
    rays = block_swizzled_frame_rays(*FRAME_2M, camera_99k(), device)
    sub = subsample(rays, PARITY_RAYS_2M)
    hs, s_sub = scene.cast_rays(sub)
    t0 = time.time()
    hb = _brute(sub, scene.tris)
    _fence(device)
    brute_s = time.time() - t0
    dt, (_, stats) = timed(lambda: scene.cast_rays(rays), ITERS_2M, device)
    # a dropped stack push may lose a hit: the gate reads the counter too
    drops = int(s_sub.stack_drops) + int(stats.stack_drops)
    ok = parity(hs, hb) and drops == 0
    extra.update({
        "mrays_2m_tris": round(rays.count / dt / 1e6, 3),
        "parity_2m": ok,
        "stack_drops_2m": drops,
        "stack_need_2m": int(scene.cluster.stack_need),
        "tris_2m": int(scene.num_tris),
    })
    _say(f"2M tier: {dt * 1e3} ms/frame, parity {ok}, stack drops {drops}, "
         f"brute {brute_s} s; B1 launches {_B1.launches - b1}")


def _incoherent(device, extra: dict, scene) -> None:
    b1 = _B1.launches
    rays = incoherent_rays(device)
    disp = RayDispatcher(scene)
    dt, _ = timed(lambda: disp.cast_rays(rays), ITERS_INCOHERENT, device)
    extra["mrays_incoherent_512k"] = round(rays.count / dt / 1e6, 3)
    _say(f"incoherent: {rays.count} rays, {dt * 1e3} ms a batch; B1 "
         f"launches {_B1.launches - b1}")


def pt_shading(device=DEFAULT_DEVICE) -> tuple:
    """(lights, environment, materials) of the path-traced frames
    (bench.py:335-340): one directional light, the default sky and
    material."""
    lights = make_lights([{
        "type": LIGHT_DIRECTIONAL, "direction": (-0.4, -1.0, -0.2),
        "color": (1.0, 1.0, 1.0), "energy": 1.5,
    }], device=device)
    return lights, make_environment(device=device), default_materials(device)


def _path_traced(device, extra: dict, scene, tlas) -> None:
    b1 = _B1.launches
    shading = pt_shading(device)
    runs = {}
    for name, sc, cam in (("99k", scene, camera_99k()),
                          ("instanced", tlas.instanced_scene(),
                           headline_camera())):
        pt = WavefrontPathTracer(sc, *shading)
        rays = block_swizzled_frame_rays(*PT_FRAME, cam, device)
        dt, (img, wave) = timed(
            lambda: pt.trace_frame(rays, max_bounces=PT_BOUNCES,
                                   sample_index=PT_SAMPLE, with_counts=True),
            PT_ITERS, device)
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"path-traced frame on {name}: a pixel is "
                               f"not finite")
        runs[name] = (dt, int(wave))
        _say(f"PT {name}: {dt * 1e3} ms/frame, {int(wave)} wave rays")
    (dt, wave), (dti, wavei) = runs["99k"], runs["instanced"]
    extra.update({
        "pt_frame_ms_640x480_3b": round(dt * 1e3, 2),
        "pt_wave_rays": wave,
        "pt_mrays": round(wave / dt / 1e6, 2),
        "pt_instanced_frame_ms_640x480_3b": round(dti * 1e3, 2),
        "pt_instanced_mrays": round(wavei / dti / 1e6, 2),
    })
    _say(f"PT tier: B1 launches {_B1.launches - b1}")


def run(device=None) -> dict:
    """Every tier at this module's sizes on ``device`` (default: the CUDA
    card; raises without one).  Returns bench.py's JSON object."""
    device = torch.device(DEFAULT_DEVICE if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench needs a CUDA card "
                           "(torch.cuda.is_available() is false)")
    extra = {"device": (card_name_and_power() if device.type == "cuda"
                        else str(device))}
    mrays, tlas = _headline(device, extra)
    scene99 = _flat_99k(device, extra)
    _capacity_2m(device, extra)
    _incoherent(device, extra, scene99)
    _path_traced(device, extra, scene99, tlas)
    if set(extra) != set(EXTRA_KEYS):
        raise RuntimeError(f"extra's keys differ from EXTRA_KEYS: "
                           f"{sorted(set(extra) ^ set(EXTRA_KEYS))}")
    return {
        "metric": METRIC,
        "value": round(mrays, 3),
        "unit": UNIT,
        "vs_baseline": round(mrays / BASELINE_CPU_MRAYS, 3),
        "extra": dict(sorted(extra.items(),
                             key=lambda kv: EXTRA_KEYS.index(kv[0]))),
    }


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
