"""Headless demo gallery on the port: the 11 demos of the JAX package's
``demos/run_demos.py`` (counterparts of the reference's Godot demos,
project/demos/*.gd), on PyTorch and CUDA.

    python -m messyerraytracer_tpu_torch.demos.run_demos [--device cuda|cpu] [demo ...]
    ls demos/out/torch/

Each demo renders the scenario of its JAX counterpart (demos/run_demos.py:
78-359) with the same scene, camera, lights, materials, textures and size,
prints the HUD line the JAX demo prints and writes the same PPM images.
Every scene is built with the default ``cluster`` backend, so on the card
each demo's casts run kernel B1: ``cast_debug_rays``, ``RayRenderer``,
masked ``cast_rays``, the service, ``PathTracer`` and ``RTReflections``.

``--device`` defaults to ``cuda`` and raises without a card, as every
entry point of the port does; ``--device cpu`` runs the plain versions.
A demo function returns a ``DemoResult`` (its images as arrays, the
numbers of its HUD line and the line itself); ``run_demo`` prints the
lines and writes the images to ``OUT``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..api.service import RayTracerService, probe_cast
from ..core.attributes import make_attributes
from ..debug.debug import DRAW_NORMALS, cast_debug_rays
from ..render import framebuffer as fbch
from ..render.camera import CameraParams, generate_rays
from ..render.hdr import load_panorama, write_hdr
from ..render.pathtrace import PathTracer, PathTraceParams
from ..render.reflections import RTReflections
from ..render.renderer import RayRenderer, RenderSettings
from ..render.shade import (
    LIGHT_DIRECTIONAL,
    LIGHT_POINT,
    LIGHT_SPOT,
    make_environment,
    make_lights,
    make_materials,
)
from ..render.textures import TextureRegistry
from ..scene.scene import build_scene_from_tri_array
from ..utils import meshes

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(_REPO, "demos", "out", "torch")
W, H = 320, 240
GI_W, GI_H = 192, 144       # the gi_comparison frame
GI_SPP = 4                  # its samples per pixel (3 bounces each)


@dataclasses.dataclass
class DemoResult:
    images: dict            # file stem -> (H, W, 3) uint8
    hud: dict               # the numbers the HUD lines print, unrounded
    lines: list             # the HUD lines, as the JAX demo prints them


def save_ppm(name: str, img_u8: np.ndarray) -> str:
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{name}.ppm")
    h, w = img_u8.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img_u8[..., :3].astype(np.uint8).tobytes())
    return path


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _u8(x: torch.Tensor, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 of float colors in [0, 1], truncated as the JAX
    demos do."""
    img = np.clip(x.cpu().numpy(), 0, 1).reshape(h, w, 3)
    return (img * 255).astype(np.uint8)


def _rgb(fb, channel=fbch.COLOR) -> np.ndarray:
    """(H, W, 3) uint8 of a framebuffer channel (the PPM's bytes)."""
    return fb.to_u8(channel)[..., :3]


def room_with_sphere():
    return np.concatenate(
        [
            meshes.cornell_room(4.0),
            meshes.uv_sphere(0.8, 16, 32, center=(0, -1.2, 0)),
        ]
    )


def sun(device, energy=1.3):
    return make_lights(
        [{"type": LIGHT_DIRECTIONAL, "direction": (0.35, 1.0, 0.5),
          "energy": energy}], device=device)


# ---------------------------------------------------------------------------
def demo_raytracer(device) -> DemoResult:
    """Server + debug grid (project/demos/raytracer_demo.gd)."""
    scene = build_scene_from_tri_array(room_with_sphere(), device=device)
    d = cast_debug_rays(scene, (0, 0, 5.0), (0, 0, -1), 64, 48, 60.0,
                        draw_mode=DRAW_NORMALS, device=device)
    img = (d.colors.cpu().numpy().reshape(48, 64, 3) * 255).astype(np.uint8)
    hud = {"tri_per_ray": d.tri_tests_per_ray, "hit_rate": d.hit_rate,
           "elapsed_ms": d.elapsed_ms}
    return DemoResult({"raytracer": img}, hud, [
        f"  tri/ray={d.tri_tests_per_ray:.1f} hit_rate={d.hit_rate:.2f} "
        f"elapsed={d.elapsed_ms:.1f}ms"])


def demo_renderer(device) -> DemoResult:
    """Full-frame AOV renderer (renderer_demo.gd)."""
    scene = build_scene_from_tri_array(room_with_sphere(), device=device)
    cam = CameraParams.look_at((0, 0.3, 5.4), (0, -0.3, 0), fov_degrees=60)
    r = RayRenderer(scene, cam, lights=sun(device),
                    env=make_environment(tonemap_mode=3, device=device),
                    settings=RenderSettings(width=W, height=H),
                    device=device)
    fb = r.render_frame()
    return DemoResult({"renderer": _rgb(fb)}, dict(r.timings), [
        f"  timings: { {k: round(v, 1) for k, v in r.timings.items()} }"])


def demo_lighting(device) -> DemoResult:
    """Point + spot lights (lighting_demo.gd)."""
    scene = build_scene_from_tri_array(room_with_sphere(), device=device)
    cam = CameraParams.look_at((0, 0.3, 5.4), (0, -0.3, 0), fov_degrees=60)
    lights = make_lights(
        [
            {"type": LIGHT_POINT, "position": (1.2, 1.2, 1.2),
             "color": (1.0, 0.6, 0.3), "energy": 6.0, "range": 8.0},
            {"type": LIGHT_SPOT, "position": (-1.4, 1.6, 0.5),
             "direction": (0.5, -1.0, -0.2), "color": (0.4, 0.6, 1.0),
             "energy": 8.0, "range": 10.0, "spot_angle": 0.6},
        ], device=device)
    r = RayRenderer(scene, cam, lights=lights,
                    env=make_environment(ambient_energy=0.15, tonemap_mode=3,
                                         device=device),
                    settings=RenderSettings(width=W, height=H),
                    device=device)
    return DemoResult({"lighting": _rgb(r.render_frame())}, {},
                      [])


def demo_pbr(device) -> DemoResult:
    """Material sweep: metallic x roughness spheres over a checkerboard-
    textured floor sampled through the atlas (pbr_demo.gd)."""
    spheres, mat_ids, mats_albedo, mats_metal, mats_rough = [], [], [], [], []
    k = 0
    for i, metal in enumerate(np.linspace(0, 1, 4)):
        for j, rough in enumerate(np.linspace(0.05, 0.9, 4)):
            c = (-2.4 + i * 1.6, -1.2 + j * 0.9, 0)
            s = meshes.uv_sphere(0.38, 10, 20, center=c)
            spheres.append(s)
            mat_ids.append(np.full(s.shape[0], k, np.int32))
            mats_albedo.append([0.9, 0.3, 0.2])
            mats_metal.append(metal)
            mats_rough.append(rough)
            k += 1
    floor = meshes.plane(10.0, y=-1.8, subdiv=2)
    spheres.append(floor)
    mat_ids.append(np.full(floor.shape[0], k, np.int32))
    mats_albedo.append([1.0, 1.0, 1.0])
    mats_metal.append(0.0)
    mats_rough.append(0.8)
    tris = np.concatenate(spheres)
    scene = build_scene_from_tri_array(tris, device=device)

    # checkerboard albedo for the floor, sampled via per-vertex UVs
    s = 64
    yy, xx = np.mgrid[0:s, 0:s]
    checker = np.where(((xx // 8 + yy // 8) % 2)[..., None],
                       np.float32([0.85, 0.85, 0.9]),
                       np.float32([0.25, 0.3, 0.35]))
    reg = TextureRegistry(size=s)
    cid = reg.add(checker)
    t_all = tris.shape[0]
    uv = np.zeros((t_all, 3, 2), np.float32)
    uv[-floor.shape[0]:] = floor[:, :, [0, 2]] / 10.0 + 0.5
    # vertex normals default to face normals (flat-shading degradation,
    # triangle_normals.h:8-11) so sphere shading matches the geometric path
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    attrs = make_attributes(t_all, uv=uv, face_normals=fn, device=device)
    tex_ids = [0] * k + [cid]

    mats = make_materials(mats_albedo, metallic=np.float32(mats_metal),
                          roughness=np.float32(mats_rough),
                          albedo_tex=np.int32(tex_ids), device=device)
    cam = CameraParams.look_at((0, 0.1, 6.0), (0, 0.1, 0), fov_degrees=45)
    r = RayRenderer(scene, cam, lights=sun(device, 2.0),
                    env=make_environment(tonemap_mode=3, device=device),
                    materials=mats,
                    mat_id_of_prim=torch.as_tensor(np.concatenate(mat_ids),
                                                   device=device),
                    attributes=attrs, atlas=reg.build(device=device),
                    settings=RenderSettings(width=W, height=H),
                    device=device)
    return DemoResult({"pbr": _rgb(r.render_frame())}, {}, [])


def demo_normal_map(device) -> DemoResult:
    """Normal-mapped shading via the FULL pipeline — per-vertex UVs +
    tangents, a normal-map texture in the atlas, TBN perturbation inside
    extract_surface (normal_map_demo.gd; shade_pass.h:527-553)."""
    tri = meshes.plane(6.0, y=0.0, subdiv=8)
    t = tri.shape[0]
    scene = build_scene_from_tri_array(tri, device=device)
    # planar UVs, +Y vertex normals, +X tangents (bitangent sign +1)
    uv = (tri[:, :, [0, 2]] / 6.0 + 0.5).astype(np.float32)
    normals = np.broadcast_to(
        np.float32([0, 1, 0]), (t, 3, 3)).copy()
    tangents = np.broadcast_to(
        np.float32([1, 0, 0, 1]), (t, 3, 4)).copy()
    attrs = make_attributes(t, uv=uv, normals=normals, tangents=tangents,
                            device=device)
    # procedural ridged normal map, encoded [0,1] like an image asset
    s = 128
    yy, xx = np.mgrid[0:s, 0:s] / s
    nm = np.stack(
        [0.35 * np.sin(xx * 40.0), 0.35 * np.sin(yy * 40.0),
         np.ones((s, s))], axis=-1
    )
    nm = nm / np.linalg.norm(nm, axis=-1, keepdims=True)
    reg = TextureRegistry(size=s)
    nid = reg.add((nm * 0.5 + 0.5).astype(np.float32))
    mats = make_materials([[0.72, 0.72, 0.78]], roughness=0.35,
                          normal_tex=[nid], device=device)
    cam = CameraParams.look_at((0, 3.5, 4.5), (0, 0, 0), fov_degrees=50)
    r = RayRenderer(
        scene, cam, lights=sun(device, 1.8),
        env=make_environment(tonemap_mode=3, device=device),
        materials=mats,
        mat_id_of_prim=torch.zeros((t,), dtype=torch.int32, device=device),
        attributes=attrs, atlas=reg.build(device=device),
        settings=RenderSettings(width=W, height=H,
                                channels=(fbch.COLOR, fbch.NORMAL)),
        device=device,
    )
    fb = r.render_frame()
    return DemoResult({"normal_map_normals": _rgb(fb, fbch.NORMAL),
                       "normal_map": _rgb(fb)}, {}, [])


def demo_panorama(device) -> DemoResult:
    """HDR panorama environment (panorama_demo.gd).

    Exercises the real .hdr asset path: the panorama is written to disk
    as a Radiance RGBE file and loaded back through the cached
    ``load_panorama`` (the reference loads gradient_sky.hdr through its
    panorama cache, ray_renderer.cpp:679-704)."""
    # procedural sky panorama: horizontal hue gradient + bright band
    ph, pw = 64, 128
    yy, xx = np.mgrid[0:ph, 0:pw]
    pan = np.stack(
        [0.5 + 0.5 * np.sin(xx / pw * 6.28),
         0.4 + 0.3 * np.cos(xx / pw * 12.56),
         np.clip(1.2 - yy / ph, 0, 1)], axis=-1
    ).astype(np.float32)
    os.makedirs(OUT, exist_ok=True)
    hdr_path = os.path.join(OUT, "sky.hdr")
    write_hdr(hdr_path, pan)
    pan = load_panorama(hdr_path, device=device)
    env = make_environment(panorama=pan, panorama_energy=1.0, tonemap_mode=3,
                           device=device)
    scene = build_scene_from_tri_array(
        meshes.uv_sphere(1.0, 16, 32, center=(0, 0, 0)), device=device)
    cam = CameraParams.look_at((0, 0.4, 4), (0, 0, 0), fov_degrees=70)
    r = RayRenderer(scene, cam, lights=sun(device), env=env,
                    settings=RenderSettings(width=W, height=H),
                    device=device)
    return DemoResult({"panorama": _rgb(r.render_frame())}, {},
                      [])


def layer_scene(device):
    """The layer demo's two spheres (layer 0b01 left, 0b10 right) and its
    W x H camera rays."""
    s1 = meshes.uv_sphere(0.9, 12, 24, center=(-1.2, 0, 0))
    s2 = meshes.uv_sphere(0.9, 12, 24, center=(1.2, 0, 0))
    tris = np.concatenate([s1, s2])
    layers = np.concatenate(
        [np.full(s1.shape[0], 0b01, np.int32),
         np.full(s2.shape[0], 0b10, np.int32)]
    )
    scene = build_scene_from_tri_array(tris, layers=layers, device=device)
    cam = CameraParams.look_at((0, 0, 5), (0, 0, 0), fov_degrees=60)
    return scene, generate_rays(cam, W, H, device=device)


def demo_layer(device) -> DemoResult:
    """Layer-mask filtering (layer_demo.gd)."""
    scene, rays = layer_scene(device)
    h1, _ = scene.cast_rays(rays, query_mask=0b01)
    h2, _ = scene.cast_rays(rays, query_mask=0b10)
    m1, m2 = h1.hit.cpu().numpy(), h2.hit.cpu().numpy()
    img = np.zeros((W * H, 3), np.float32)
    img[m1] = [1.0, 0.3, 0.2]
    img[m2] = [0.2, 0.5, 1.0]
    hud = {"layer1_hits": int(m1.sum()), "layer2_hits": int(m2.sum())}
    return DemoResult(
        {"layer": (img.reshape(H, W, 3) * 255).astype(np.uint8)}, hud,
        [f"  layer1 hits={hud['layer1_hits']} "
         f"layer2 hits={hud['layer2_hits']}"])


PROBE_ZS = (4.0, 2.0, 0.5)


def probe_transform(z: float) -> np.ndarray:
    """The probe demo's node transform at depth ``z``."""
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (0.11, 0.07, z)
    return m


def demo_probe(device) -> DemoResult:
    """RayTracerProbe-style transform casts (probe_demo.gd)."""
    svc = RayTracerService(device=device)
    svc.register_mesh(room_with_sphere())
    svc.build()
    probes, lines = [], []
    for z in PROBE_ZS:
        r = probe_cast(svc, probe_transform(z))
        probes.append({"z": z, "hit": r["hit"], "distance": r["distance"],
                       "prim_id": r["prim_id"]})
        lines.append(f"  probe at z={z}: hit={r['hit']} "
                     f"distance={r['distance']:.2f}")
    stats = svc.get_last_stats()
    lines.append(f"  stats: {stats}")
    return DemoResult({}, {"probes": probes, "stats": stats}, lines)


def gi_tracer(device):
    """The gi_comparison demo's Cornell box: its ``PathTracer`` and its
    GI_W x GI_H camera rays."""
    room = meshes.cornell_room(4.0)
    ball = meshes.uv_sphere(0.7, 12, 24, center=(0.6, -1.3, -0.4))
    box = meshes.box((0.8, 1.6, 0.8), center=(-0.8, -1.2, 0.6))
    tris = np.concatenate([room, ball, box])
    # classic red/green side walls: per-tri materials
    mat = np.zeros(tris.shape[0], np.int32)
    mat[6:8] = 1   # left wall red
    mat[8:10] = 2  # right wall green
    mats = make_materials(
        [[0.73, 0.73, 0.73], [0.65, 0.05, 0.05], [0.12, 0.45, 0.15]],
        roughness=[0.8, 0.8, 0.8], device=device,
    )
    scene = build_scene_from_tri_array(tris, device=device)
    # mat ids follow the BVH reorder via prim_id lookup
    cam = CameraParams.look_at((0, 0, 5.4), (0, 0, 0), fov_degrees=55)
    rays = generate_rays(cam, GI_W, GI_H, device=device)
    pt = PathTracer(scene, sun(device, 2.0),
                    make_environment(tonemap_mode=3, device=device), mats,
                    mat_id_of_prim=torch.as_tensor(mat, device=device))
    return pt, rays


def demo_gi_comparison(device) -> DemoResult:
    """Cornell-box path tracing (gi_comparison_demo.gd)."""
    pt, rays = gi_tracer(device)
    w, h, spp = GI_W, GI_H, GI_SPP
    t0 = time.time()
    acc = None
    for s in range(spp):
        img = pt.trace_frame_srgb(PathTraceParams(w, h, 3, sample_index=s),
                                  rays)
        acc = img if acc is None else acc + (img - acc) / (s + 1)
    _wait(rays.origin.device)
    secs = time.time() - t0
    return DemoResult({"gi_comparison": _u8(acc, h, w)},
                      {"spp": spp, "width": w, "height": h, "seconds": secs},
                      [f"  {spp}spp {w}x{h} in {secs:.1f}s"])


def demo_rt_graphics(device) -> DemoResult:
    """RT reflections compositor pipeline (rt_graphics_demo.gd)."""
    tris = np.concatenate(
        [meshes.plane(16.0, y=-1.0, subdiv=2),
         meshes.uv_sphere(1.0, 14, 28, center=(0, 0.4, 0))]
    )
    scene = build_scene_from_tri_array(tris, device=device)
    env = make_environment(tonemap_mode=3, device=device)
    cam = CameraParams.look_at((0, 1.4, 6), (0, -0.2, 0), fov_degrees=55)
    r = RayRenderer(scene, cam, lights=sun(device), env=env,
                    settings=RenderSettings(width=W, height=H,
                                            accumulate=False),
                    device=device)
    fb = r.render_frame()
    rays = generate_rays(cam, W, H, device=device)
    hits, _ = scene.cast_rays(rays)
    rt = RTReflections(scene, env)
    base = fb.get(fbch.COLOR)[:, :3].reshape(H, W, 3)
    rough = torch.full((H, W), 0.15, dtype=torch.float32, device=device)
    out = rt.render(hits, rays.direction, base, rough, W, H)
    return DemoResult({"rt_graphics": _u8(out, H, W)}, {}, [])


EXAMPLE_ORIGIN, EXAMPLE_DIRECTION = (0.11, 0.07, 4), (0, 0, -1)


def demo_example(device) -> DemoResult:
    """Minimal API walkthrough (example_demo.gd)."""
    svc = RayTracerService(device=device)
    svc.register_mesh(meshes.uv_sphere(1.0, 12, 24))
    svc.build()
    hit = svc.cast_ray(EXAMPLE_ORIGIN, EXAMPLE_DIRECTION)
    hud = {"hit": hit["hit"], "distance": hit["distance"],
           "prim_id": hit["prim_id"]}
    return DemoResult({}, hud, [
        f"  cast_ray -> {{hit: {hit['hit']}, distance: "
        f"{hit['distance']:.3f}, prim_id: {hit['prim_id']}}}"])


DEMOS = {
    "raytracer": demo_raytracer,
    "renderer": demo_renderer,
    "lighting": demo_lighting,
    "pbr": demo_pbr,
    "normal_map": demo_normal_map,
    "panorama": demo_panorama,
    "layer": demo_layer,
    "probe": demo_probe,
    "gi_comparison": demo_gi_comparison,
    "rt_graphics": demo_rt_graphics,
    "example": demo_example,
}


def run_demo(name: str, device) -> tuple[DemoResult, list]:
    """Run one demo on ``device``, print its HUD lines and write its
    images; returns (its result, the paths written)."""
    res = DEMOS[name](torch.device(device))
    for line in res.lines:
        print(line)
    return res, [save_ppm(stem, img) for stem, img in res.images.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every scene and ray (default "
                         "cuda; cpu runs the plain versions)")
    ap.add_argument("demos", nargs="*", metavar="demo",
                    help=f"demos to run (default: all): {', '.join(DEMOS)}")
    args = ap.parse_args(argv)
    unknown = [n for n in args.demos if n not in DEMOS]
    if unknown:
        ap.error(f"unknown demos {unknown}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card "
                           "(torch.cuda.is_available() is false); pass "
                           "--device cpu to run the plain versions")
    for name in args.demos or list(DEMOS):
        print(f"[{name}]")
        t0 = time.time()
        _, paths = run_demo(name, device)
        extra = "".join(f" -> {os.path.relpath(p)}" for p in paths[-1:])
        print(f"  done in {time.time()-t0:.1f}s{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
