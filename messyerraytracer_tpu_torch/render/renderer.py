"""RayRenderer — full-frame orchestration (trace -> shadow -> shade -> AOVs).

PyTorch counterpart of the JAX package's render/renderer.py; per frame:

  1. jittered camera raygen — Halton(2,3) subpixel offsets; a camera change
     resets the accumulation
  2. closest-hit trace through the scene
  3. one batched any-hit cast for the shadow rays of all lights, laid out
     [light][pixel]
  4. vectorized shade of the selected AOV channel(s) — Cook-Torrance with
     next-event estimation + ambient + emission for COLOR, plus 10 debug
     channels
  5. temporal accumulation as an incremental mean over frames

``timings`` are host-clock intervals around each stage: on a CUDA device
they measure the launches, not the device work (nothing waits).  The same
stages run inside the profiler ranges ``render.raygen``, ``render.trace``,
``render.shadows`` and ``render.shade``, whose device time a profile reads.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..core.types import DEFAULT_DEVICE, Rays
from ..utils.trace import span
from . import framebuffer as fbch
from .camera import CameraParams, generate_rays
from .framebuffer import RayImage
from .shade import (
    EnvironmentData,
    Lights,
    Materials,
    ambient_color_at,
    cook_torrance_multi_light,
    default_materials,
    extract_surface,
    light_sample,
    make_environment,
    sky_color,
    to_srgb,
    tonemap,
)

SHADOW_EPS = 1e-3  # shadow-ray origin offset along the normal
_M32 = 0xFFFFFFFF


def halton(index: int, base: int) -> float:
    """Halton low-discrepancy sequence."""
    f, r = 1.0, 0.0
    i = index
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def shadow_rays(hits, lights: Lights, alive: torch.Tensor) -> Rays:
    """The shadow rays of every light from every hit, [light][pixel];
    a pixel that is not ``alive`` or a light that is not valid there gets
    a dead ray (t_max < t_min, an instant miss)."""
    n = hits.t.shape[0]
    origins, dirs, tmaxs = [], [], []
    o = hits.position + hits.normal * SHADOW_EPS
    for li in range(lights.count):
        ldir, _, valid, dist = light_sample(hits.position, lights, li)
        tmax = torch.where(lights.type[li] == 0, 1e30,
                           dist - 2.0 * SHADOW_EPS)
        origins.append(o)
        dirs.append(ldir)
        tmaxs.append(torch.where(alive & valid, tmax, -1.0))
    t_min = torch.full((n * lights.count,), SHADOW_EPS,
                       dtype=torch.float32, device=hits.t.device)
    return Rays(origin=torch.cat(origins), direction=torch.cat(dirs),
                t_min=t_min, t_max=torch.cat(tmaxs))


def prim_id_colors(prim_id: torch.Tensor) -> torch.Tensor:
    """(N,3) stable colors hashed from prim ids: the 32-bit integer hash
    in int64, masked to 32 bits after each step; bytes / 255."""
    h = prim_id.to(torch.int64) & _M32
    h = (((h >> 16) ^ h) * 0x45D9F3B) & _M32
    h = (((h >> 16) ^ h) * 0x45D9F3B) & _M32
    h = (h >> 16) ^ h
    rgb = torch.stack([(h >> s) & 0xFF for s in (0, 8, 16)], dim=1)
    rgb = rgb.to(torch.float32)
    # a tensor divisor: CUDA turns a division by a Python scalar into a
    # multiply by its reciprocal, which rounds differently from the CPU
    return rgb / torch.full_like(rgb, 255.0)


@dataclasses.dataclass
class RenderSettings:
    width: int = 320
    height: int = 240
    channels: tuple = (fbch.COLOR,)
    accumulate: bool = True     # temporal AA accumulation
    depth_range: float = 20.0   # DEPTH channel normalization
    position_range: float = 4.0  # POSITION channel wrap cell size
    shadows: bool = True


class RayRenderer:
    """Frame renderer over a scene object exposing cast_rays/any_hit_rays
    (a ``RayScene``, an ``InstancedScene`` or a ``RayDispatcher``).  Rays
    and state live on ``device``, which must be the scene's."""

    def __init__(self, scene, camera: CameraParams,
                 lights: Lights | None = None,
                 env: EnvironmentData | None = None,
                 materials: Materials | None = None,
                 mat_id_of_prim: torch.Tensor | None = None,
                 attributes=None, atlas=None,
                 settings: RenderSettings | None = None,
                 device=DEFAULT_DEVICE):
        self.scene = scene
        self.camera = camera
        self.device = torch.device(device)
        self.lights = lights
        self.env = env if env is not None else make_environment(
            device=self.device)
        self.materials = (materials if materials is not None
                          else default_materials(device=self.device))
        self.mat_id_of_prim = mat_id_of_prim
        self.attributes = attributes
        self.atlas = atlas
        self.settings = settings if settings is not None else RenderSettings()
        self._accum: torch.Tensor | None = None
        self._accum_frames = 0
        self._last_cam = camera
        self.timings: dict[str, float] = {}

    # -- public API -----------------------------------------------------
    def reset_accumulation(self) -> None:
        self._accum = None
        self._accum_frames = 0

    def render_frame(self) -> RayImage:
        """Render one frame; returns the AOV framebuffer.  Accumulation
        advances by one sample when ``settings.accumulate``; a camera
        change resets it."""
        st = self.settings
        if self.camera != self._last_cam:
            self.reset_accumulation()
            self._last_cam = self.camera

        t0 = time.perf_counter()
        frame = self._accum_frames
        jitter = ((halton(frame + 1, 2), halton(frame + 1, 3))
                  if st.accumulate else (0.5, 0.5))
        with span("render.raygen"):
            rays = generate_rays(self.camera, st.width, st.height,
                                 jitter=jitter, device=self.device)
        t1 = time.perf_counter()

        with span("render.trace"):
            hits, _ = self.scene.cast_rays(rays)
        t2 = time.perf_counter()

        lit_mask = None
        if st.shadows and self.lights is not None and \
                fbch.COLOR in st.channels:
            with span("render.shadows"):
                lit_mask = self._trace_shadows(hits)
        t3 = time.perf_counter()

        with span("render.shade"):
            fb = self._shade(rays, hits, lit_mask)
        t4 = time.perf_counter()

        if st.accumulate and fbch.COLOR in st.channels:
            color = fb.get(fbch.COLOR)
            if self._accum is None:
                self._accum = color
            else:
                k = self._accum_frames
                self._accum = self._accum + (color - self._accum) / (k + 1)
            self._accum_frames += 1
            fb.write(fbch.COLOR, self._accum)

        self.timings = {
            "raygen_ms": (t1 - t0) * 1e3,
            "trace_ms": (t2 - t1) * 1e3,
            "shadow_ms": (t3 - t2) * 1e3,
            "shade_ms": (t4 - t3) * 1e3,
        }
        return fb

    # -- internals ------------------------------------------------------
    def _trace_shadows(self, hits) -> torch.Tensor:
        """(L, N) lit mask via one batched any-hit cast for all lights."""
        occluded = self.scene.any_hit_rays(
            shadow_rays(hits, self.lights, hits.hit))
        return ~occluded.reshape(self.lights.count, hits.t.shape[0])

    def _mat_ids(self, hits) -> torch.Tensor:
        pid = hits.prim_id.clamp_min(0).long()
        if self.mat_id_of_prim is not None:
            return self.mat_id_of_prim[pid]
        return torch.zeros_like(pid)

    def _shade(self, rays, hits, lit_mask) -> RayImage:
        st = self.settings
        fb = RayImage(st.width, st.height)
        hit = hits.hit
        hit3 = hit[:, None]
        ones = torch.ones((hits.t.shape[0], 1), dtype=torch.float32,
                          device=hits.t.device)

        def rgba(rgb):
            return torch.cat([rgb, ones], dim=1)

        def grey(v):
            return rgba(v[:, None].expand(-1, 3))

        surf = None
        needs_surf = (fbch.COLOR, fbch.FRESNEL, fbch.ALBEDO, fbch.UV,
                      fbch.NORMAL)
        if any(ch in st.channels for ch in needs_surf):
            surf = extract_surface(
                hits, rays.direction, self.materials, self._mat_ids(hits),
                attrs=self.attributes, atlas=self.atlas)

        env = self.env
        for ch in st.channels:
            if ch == fbch.COLOR:
                out = torch.zeros_like(surf.position)
                if self.lights is not None:
                    out = cook_torrance_multi_light(surf, self.lights,
                                                    lit_mask)
                amb = ambient_color_at(surf.normal, env)
                out = out + (surf.diff * amb * env.ambient_color
                             * env.ambient_energy)
                out = to_srgb(tonemap(out + surf.emission,
                                      env.tonemap_mode))
                sky = to_srgb(tonemap(sky_color(rays.direction, env),
                                      env.tonemap_mode))
                fb.write(ch, rgba(torch.where(hit3, out, sky)))
            elif ch == fbch.NORMAL:
                # shading normal when attributes are wired, else geometric
                nrm = (surf.normal if self.attributes is not None
                       else hits.normal)
                fb.write(ch, rgba(torch.where(hit3, nrm * 0.5 + 0.5, 0.0)))
            elif ch == fbch.DEPTH:
                d = (1.0 - hits.t / st.depth_range).clamp(0.0, 1.0)
                fb.write(ch, grey(torch.where(hit, d, 0.0)))
            elif ch == fbch.BARYCENTRIC:
                w = 1.0 - hits.u - hits.v
                bary = torch.stack([hits.u, hits.v, w], dim=1)
                fb.write(ch, rgba(torch.where(hit3, bary, 0.0)))
            elif ch == fbch.POSITION:
                f = hits.position / st.position_range
                fb.write(ch, rgba(torch.where(hit3, f - torch.floor(f),
                                              0.0)))
            elif ch == fbch.PRIM_ID:
                rgb = prim_id_colors(hits.prim_id)
                fb.write(ch, rgba(torch.where(hit3, rgb, 0.0)))
            elif ch == fbch.HIT_MASK:
                fb.write(ch, grey(hit.to(torch.float32)))
            elif ch == fbch.ALBEDO:
                fb.write(ch, rgba(torch.where(hit3, surf.albedo, 0.0)))
            elif ch == fbch.WIREFRAME:
                w0 = 1.0 - hits.u - hits.v
                d = torch.minimum(torch.minimum(w0, hits.u), hits.v)
                t = ((d - 0.01) / 0.02).clamp(0.0, 1.0)
                edge = 1.0 - t * t * (3.0 - 2.0 * t)
                fb.write(ch, grey(torch.where(hit, 0.08 + edge * 0.92,
                                              0.0)))
            elif ch == fbch.UV:
                # interpolated texture UVs when attributes are wired;
                # barycentric u/v otherwise
                if self.attributes is not None:
                    uvz = torch.cat([surf.uv, torch.zeros_like(surf.uv[:, :1])],
                                    dim=1)
                else:
                    uvz = torch.stack([hits.u, hits.v,
                                       torch.zeros_like(hits.u)], dim=1)
                fb.write(ch, rgba(torch.where(hit3, uvz, 0.0)))
            elif ch == fbch.FRESNEL:
                ndv = surf.n_dot_v.clamp(0.0, 1.0)
                base = torch.stack([ndv, ndv, 0.3 + 0.7 * ndv], dim=1)
                fb.write(ch, rgba(torch.where(hit3, base, 0.0)))
            else:
                raise ValueError(f"unknown channel {ch}")
        return fb
