"""Vectorized shading library.

PyTorch counterpart of the JAX package's render/shade.py: every per-pixel
shading function is a batched tensor expression over (N,)-shaped pixel
arrays, with the same constants:

  * sky: analytic zenith/horizon/ground gradient or an equirect HDR
    panorama with bilinear sampling
  * Cook-Torrance pieces: GGX NDF, Schlick Fresnel, height-correlated
    Smith GGX (1e-7 denominators)
  * Godot-matching distance/spot attenuation
  * ``cook_torrance_multi_light``: next-event estimation over <= 16
    lights with per-light shadow masks
  * surface extraction: F0 = 0.04*specular*2 lerp metallic->albedo,
    metals have no diffuse
  * 5 tonemappers (LINEAR/REINHARD/FILMIC/ACES/AGX) + sRGB gamma

Each struct has a ``*_from_jax`` converter that takes the JAX struct's
fields as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import DEFAULT_DEVICE
from ..utils.trace import span

PI = 3.14159265358979


def _put(x, device, dtype=np.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype), device=device)


class _Struct:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(
        torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-12)


# ============================================================================
# Environment
# ============================================================================

@dataclasses.dataclass(frozen=True)
class EnvironmentData(_Struct):
    """Sky + ambient description.  When ``has_panorama`` the (H, W, 3)
    float32 ``panorama`` is sampled equirect; otherwise the analytic
    gradient is used."""

    sky_zenith: torch.Tensor    # (3,)
    sky_horizon: torch.Tensor   # (3,)
    sky_ground: torch.Tensor    # (3,)
    ambient_color: torch.Tensor  # (3,)
    ambient_energy: torch.Tensor  # ()
    panorama: torch.Tensor      # (H, W, 3) or (1, 1, 3) placeholder
    panorama_energy: torch.Tensor  # ()
    tonemap_mode: int = 0       # 0=LINEAR 1=REINHARD 2=FILMIC 3=ACES 4=AGX
    has_panorama: bool = False


def environment_from_jax(*, sky_zenith, sky_horizon, sky_ground,
                         ambient_color, ambient_energy, panorama,
                         panorama_energy, tonemap_mode=0,
                         has_panorama=False,
                         device=DEFAULT_DEVICE) -> EnvironmentData:
    """The port's environment from a JAX ``EnvironmentData``'s fields
    (numpy arrays; the panorama included)."""
    return EnvironmentData(
        sky_zenith=_put(sky_zenith, device),
        sky_horizon=_put(sky_horizon, device),
        sky_ground=_put(sky_ground, device),
        ambient_color=_put(ambient_color, device),
        ambient_energy=_put(ambient_energy, device),
        panorama=_put(panorama, device),
        panorama_energy=_put(panorama_energy, device),
        tonemap_mode=int(tonemap_mode),
        has_panorama=bool(has_panorama),
    )


def make_environment(
    sky_zenith=(0.38, 0.45, 0.55),
    sky_horizon=(0.64, 0.65, 0.67),
    sky_ground=(0.2, 0.17, 0.13),
    ambient_color=(1.0, 1.0, 1.0),
    ambient_energy=1.0,
    panorama=None,
    panorama_energy=1.0,
    tonemap_mode=0,
    device=DEFAULT_DEVICE,
) -> EnvironmentData:
    has_pan = panorama is not None
    if panorama is None:
        panorama = np.zeros((1, 1, 3), np.float32)
    elif isinstance(panorama, torch.Tensor):
        panorama = panorama.cpu().numpy()
    return environment_from_jax(
        sky_zenith=sky_zenith, sky_horizon=sky_horizon,
        sky_ground=sky_ground, ambient_color=ambient_color,
        ambient_energy=ambient_energy, panorama=panorama,
        panorama_energy=panorama_energy, tonemap_mode=tonemap_mode,
        has_panorama=has_pan, device=device)


def direction_to_equirect_uv(d):
    """Unit direction -> equirect (u, v) in [0,1)."""
    u = (torch.atan2(d[:, 0], -d[:, 2]) / (2.0 * PI)) + 0.5
    v = torch.acos(d[:, 1].clamp(-1.0, 1.0)) / PI
    return u, v


def sample_panorama(pan: torch.Tensor, u, v, energy):
    """Bilinear equirect sample with repeat wrap in u, clamp in v."""
    h, w = pan.shape[0], pan.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0w, x1w = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    c00 = pan[y0c, x0w]
    c10 = pan[y0c, x1w]
    c01 = pan[y1c, x0w]
    c11 = pan[y1c, x1w]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return (top * (1 - fy) + bot * fy) * energy


def sky_color(directions: torch.Tensor,
              env: EnvironmentData) -> torch.Tensor:
    """(N,3) sky radiance for (N,3) directions."""
    if env.has_panorama:
        u, v = direction_to_equirect_uv(directions)
        return sample_panorama(env.panorama, u, v, env.panorama_energy)
    t = directions[:, 1] * 0.5 + 0.5
    s_hi = ((t - 0.5) * 2.0)[:, None]
    s_lo = (t * 2.0)[:, None]
    upper = env.sky_horizon + (env.sky_zenith - env.sky_horizon) * s_hi
    lower = env.sky_ground + (env.sky_horizon - env.sky_ground) * s_lo
    return torch.where((t > 0.5)[:, None], upper, lower)


def ambient_color_at(normals: torch.Tensor,
                     env: EnvironmentData) -> torch.Tensor:
    """Hemisphere ambient (or panorama IBL sample) per surface normal."""
    if env.has_panorama:
        u, v = direction_to_equirect_uv(normals)
        return sample_panorama(env.panorama, u, v, env.panorama_energy)
    blend = (normals[:, 1] * 0.5 + 0.5)[:, None]
    return env.sky_ground + (env.sky_zenith - env.sky_ground) * blend


# ============================================================================
# Materials / lights (SoA)
# ============================================================================

@dataclasses.dataclass(frozen=True)
class Materials(_Struct):
    """PBR material table, SoA over material ids.  ``albedo_tex`` /
    ``normal_tex`` index a ``TextureAtlas``: id 0 is reserved white, so an
    untextured material uses albedo_tex=0, and normal_tex=0 means "no
    normal map"."""

    albedo: torch.Tensor       # (M, 3)
    metallic: torch.Tensor     # (M,)
    roughness: torch.Tensor    # (M,)
    specular: torch.Tensor     # (M,)
    emission: torch.Tensor     # (M, 3) premultiplied by emission energy
    albedo_tex: torch.Tensor   # (M,) int32 atlas id (0 = white)
    normal_tex: torch.Tensor   # (M,) int32 atlas id (0 = none)
    normal_scale: torch.Tensor  # (M,) normal-map strength


_INT_FIELDS = ("albedo_tex", "normal_tex", "type")


def _struct_from_jax(cls, fields: dict, device):
    return cls(**{k: _put(v, device, np.int32 if k in _INT_FIELDS
                          else np.float32) for k, v in fields.items()})


def materials_from_jax(*, device=DEFAULT_DEVICE, **fields) -> Materials:
    """The port's material table from a JAX ``Materials``'s fields
    (numpy arrays)."""
    return _struct_from_jax(Materials, fields, device)


def make_materials(albedo, metallic=None, roughness=None, specular=None,
                   emission=None, albedo_tex=None, normal_tex=None,
                   normal_scale=None, device=DEFAULT_DEVICE) -> Materials:
    albedo = np.asarray(albedo, np.float32).reshape(-1, 3)
    m = albedo.shape[0]

    def arr(x, default, dtype=np.float32):
        if x is None:
            return np.full((m,), default, dtype)
        return np.broadcast_to(np.asarray(x, dtype), (m,))

    emission = (np.zeros((m, 3), np.float32) if emission is None
                else np.asarray(emission, np.float32).reshape(-1, 3))
    return materials_from_jax(
        albedo=albedo, metallic=arr(metallic, 0.0),
        roughness=arr(roughness, 0.7), specular=arr(specular, 0.5),
        emission=emission, albedo_tex=arr(albedo_tex, 0, np.int32),
        normal_tex=arr(normal_tex, 0, np.int32),
        normal_scale=arr(normal_scale, 1.0), device=device)


def default_materials(device=DEFAULT_DEVICE) -> Materials:
    """Single default material (Godot BaseMaterial3D defaults)."""
    return make_materials(albedo=[[0.75, 0.75, 0.75]], device=device)


LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2
MAX_SCENE_LIGHTS = 16


@dataclasses.dataclass(frozen=True)
class Lights(_Struct):
    """Scene light table, SoA.  ``direction`` for DIRECTIONAL points
    toward the light; ``color`` is premultiplied color x energy, linear."""

    type: torch.Tensor        # (L,) int32
    position: torch.Tensor    # (L, 3)
    direction: torch.Tensor   # (L, 3)
    color: torch.Tensor       # (L, 3)
    range: torch.Tensor       # (L,)
    attenuation: torch.Tensor  # (L,)
    spot_angle: torch.Tensor  # (L,) outer half-angle, radians
    spot_atten: torch.Tensor  # (L,)

    @property
    def count(self) -> int:
        return self.type.shape[0]


def lights_from_jax(*, device=DEFAULT_DEVICE, **fields) -> Lights:
    """The port's light table from a JAX ``Lights``'s fields (numpy
    arrays)."""
    return _struct_from_jax(Lights, fields, device)


def make_lights(entries, device=DEFAULT_DEVICE) -> Lights:
    """Build a light table from dicts with keys
    type/position/direction/color/energy/range/attenuation/spot_angle/
    spot_angle_attenuation."""
    n = len(entries)
    if not 0 < n <= MAX_SCENE_LIGHTS:
        raise ValueError(f"1..{MAX_SCENE_LIGHTS} lights, got {n}")
    typ = np.zeros((n,), np.int32)
    pos = np.zeros((n, 3), np.float32)
    dirn = np.zeros((n, 3), np.float32)
    col = np.zeros((n, 3), np.float32)
    rng = np.full((n,), 10.0, np.float32)
    att = np.ones((n,), np.float32)
    sa = np.full((n,), 0.785398, np.float32)
    saa = np.ones((n,), np.float32)
    for i, e in enumerate(entries):
        typ[i] = e.get("type", LIGHT_DIRECTIONAL)
        pos[i] = e.get("position", (0, 0, 0))
        d = np.asarray(e.get("direction", (0, -1, 0)), np.float32)
        dirn[i] = d / max(np.linalg.norm(d), 1e-12)
        col[i] = np.asarray(e.get("color", (1, 1, 1)),
                            np.float32) * e.get("energy", 1.0)
        rng[i] = e.get("range", 10.0)
        att[i] = e.get("attenuation", 1.0)
        sa[i] = e.get("spot_angle", 0.785398)
        saa[i] = e.get("spot_angle_attenuation", 1.0)
    return lights_from_jax(type=typ, position=pos, direction=dirn,
                           color=col, range=rng, attenuation=att,
                           spot_angle=sa, spot_atten=saa, device=device)


# ============================================================================
# BRDF pieces — all batched
# ============================================================================

def distribution_ggx(n_dot_h, roughness):
    a = roughness * roughness
    a2 = a * a
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom + 1e-7)


def fresnel_schlick(cos_theta, f0):
    t = 1.0 - cos_theta
    t2 = t * t
    return f0 + (1.0 - f0) * (t2 * t2 * t)


def geometry_smith_ggx(n_dot_v, n_dot_l, roughness):
    a = roughness * roughness
    a2 = a * a

    def g1(ndx):
        return 2.0 * ndx / (ndx + torch.sqrt(a2 + (1.0 - a2) * ndx * ndx)
                            + 1e-7)

    return g1(n_dot_v) * g1(n_dot_l)


def distance_attenuation(distance, rng, exp):
    """Godot OmniLight falloff."""
    ratio = distance / rng
    base = torch.clamp_min(1.0 - ratio * ratio, 0.0)
    return torch.pow(base, exp)


def spot_attenuation(light_to_point_dir, spot_forward, spot_angle, exp):
    """Spot cone falloff."""
    cos_outer = torch.cos(spot_angle)
    cos_angle = ((-light_to_point_dir) * spot_forward).sum(dim=-1)
    t = (cos_angle - cos_outer) / (1.0 - cos_outer)
    return torch.where(cos_angle <= cos_outer, 0.0,
                       torch.pow(torch.clamp_min(t, 0.0), exp))


# ============================================================================
# Surface extraction
# ============================================================================

@dataclasses.dataclass(frozen=True)
class Surface(_Struct):
    """Batched surface info: everything shading needs per hit pixel."""

    position: torch.Tensor   # (N, 3)
    normal: torch.Tensor     # (N, 3)
    view_dir: torch.Tensor   # (N, 3) toward camera
    n_dot_v: torch.Tensor    # (N,)
    albedo: torch.Tensor     # (N, 3)
    metallic: torch.Tensor   # (N,)
    roughness: torch.Tensor  # (N,)
    f0: torch.Tensor         # (N, 3)
    diff: torch.Tensor       # (N, 3)
    emission: torch.Tensor   # (N, 3)
    uv: torch.Tensor         # (N, 2) texture UVs (0 when no attributes)


def extract_surface(hits, ray_dirs, materials: Materials,
                    mat_ids: torch.Tensor, attrs=None,
                    atlas=None) -> Surface:
    """Batched surface prep: smooth-normal interpolation, faceforward,
    normal-map perturbation via TBN, albedo texture sample, F0/diffuse
    derivation.

    ``mat_ids``: (N,) material index per pixel (already gathered by prim).
    ``attrs``: optional ``TriangleAttributes``; ``atlas``: optional
    ``TextureAtlas`` sampled by the material's texture ids.
    """
    uv = torch.zeros((hits.t.shape[0], 2), dtype=torch.float32,
                     device=hits.t.device)
    if attrs is not None:
        from ..core.attributes import (
            interpolate_normal,
            interpolate_tangent,
            interpolate_uv,
            perturb_normal,
        )

        pid = hits.prim_id.clamp_min(0)
        n = interpolate_normal(attrs, pid, hits.u, hits.v)
        uv = interpolate_uv(attrs, pid, hits.u, hits.v)
    else:
        n = hits.normal
    # face-forward: flip the shading normal toward the viewer
    with span("surface.normal"):
        flip = (n * ray_dirs).sum(dim=-1) > 0.0
        n = torch.where(flip[:, None], -n, n)

    with span("surface.material"):
        mat_ids = mat_ids.long()
        albedo = materials.albedo[mat_ids]
        metallic = materials.metallic[mat_ids]
        roughness = torch.clamp_min(materials.roughness[mat_ids], 0.04)
        specular = materials.specular[mat_ids]
        emission = materials.emission[mat_ids]

    if atlas is not None and attrs is not None:
        # textures need real UVs, so the whole block is gated on attrs
        from .textures import sample_bilinear

        albedo = albedo * sample_bilinear(
            atlas, materials.albedo_tex[mat_ids], uv[:, 0], uv[:, 1])
        ntex = materials.normal_tex[mat_ids]
        nsamp = sample_bilinear(atlas, ntex, uv[:, 0], uv[:, 1])
        tang, sign, has_t = interpolate_tangent(attrs, pid, hits.u, hits.v)
        perturbed = perturb_normal(
            n, tang, sign, nsamp * 2.0 - 1.0,
            materials.normal_scale[mat_ids][:, None])
        n = torch.where(((ntex > 0) & has_t)[:, None], perturbed, n)

    with span("surface.lobes"):
        view = -ray_dirs
        n_dot_v = torch.clamp_min((n * view).sum(dim=-1), 1e-4)
        dielectric_f0 = (0.04 * specular * 2.0)[:, None]
        f0 = (dielectric_f0 * (1.0 - metallic[:, None])
              + albedo * metallic[:, None])
        diff = albedo * (1.0 - metallic[:, None])
        return Surface(
            position=hits.position, normal=n, view_dir=view,
            n_dot_v=n_dot_v, albedo=albedo, metallic=metallic,
            roughness=roughness, f0=f0, diff=diff, emission=emission,
            uv=uv,
        )


def light_sample(surf_pos, lights: Lights, li: int):
    """Per-light direction/attenuation/validity at surface points for
    light ``li``.  Returns (light_dir (N,3), radiance_scale (N,), valid
    (N,), dist (N,))."""
    is_dir = lights.type[li] == LIGHT_DIRECTIONAL
    to_light = lights.position[li] - surf_pos
    dist = torch.linalg.vector_norm(to_light, dim=-1)
    pdir = to_light / torch.clamp_min(dist, 1e-12)[:, None]
    ldir = torch.where(is_dir, lights.direction[li], pdir)
    atten = distance_attenuation(dist, lights.range[li],
                                 lights.attenuation[li])
    spot = spot_attenuation(-pdir, lights.direction[li],
                            lights.spot_angle[li], lights.spot_atten[li])
    atten = torch.where(lights.type[li] == LIGHT_SPOT, atten * spot, atten)
    atten = torch.where(is_dir, 1.0, atten)
    valid = is_dir | ((dist > 1e-6) & (dist <= lights.range[li]))
    valid = valid & (atten >= 1e-6)
    return ldir, atten, valid, dist


def light_sample_picked(surf_pos, lights: Lights, li: torch.Tensor):
    """Per-pixel picked-light sampling: ``li`` is an (N,) index array.
    One gathered evaluation of the stochastic single-light estimator.
    Returns (light_dir (N,3), atten (N,), valid (N,), dist (N,), color
    (N,3), is_directional (N,))."""
    with span("light.direction"):
        li = li.long()
        typ = lights.type[li]
        is_dir = typ == LIGHT_DIRECTIONAL
        to_light = lights.position[li] - surf_pos
        dist = torch.linalg.vector_norm(to_light, dim=-1)
        pdir = to_light / torch.clamp_min(dist, 1e-12)[:, None]
        ldirn = lights.direction[li]
        ldir = torch.where(is_dir[:, None], ldirn, pdir)
    with span("light.falloff"):
        atten = distance_attenuation(dist, lights.range[li],
                                     lights.attenuation[li])
    with span("light.spot"):
        spot = spot_attenuation(-pdir, ldirn, lights.spot_angle[li],
                                lights.spot_atten[li])
    with span("light.valid"):
        atten = torch.where(typ == LIGHT_SPOT, atten * spot, atten)
        atten = torch.where(is_dir, 1.0, atten)
        valid = is_dir | ((dist > 1e-6) & (dist <= lights.range[li]))
        valid = valid & (atten >= 1e-6)
        return ldir, atten, valid, dist, lights.color[li], is_dir


def cook_torrance_single(surf: Surface, ldir, radiance):
    """Cook-Torrance BRDF x radiance x n_dot_l for one light direction per
    pixel.  Returns (contrib (N,3), n_dot_l (N,)); the caller applies
    validity/shadow masks."""
    with span("brdf.angles"):
        n_dot_l = (surf.normal * ldir).sum(dim=-1)
        h = _unit(surf.view_dir + ldir)
        n_dot_h = torch.clamp_min((surf.normal * h).sum(dim=-1), 0.0)
        v_dot_h = torch.clamp_min((surf.view_dir * h).sum(dim=-1), 0.0)
    with span("brdf.ndf"):
        d_term = distribution_ggx(n_dot_h, surf.roughness)
    with span("brdf.geometry"):
        g_term = geometry_smith_ggx(surf.n_dot_v, n_dot_l, surf.roughness)
    with span("brdf.fresnel"):
        f = fresnel_schlick(v_dot_h[:, None], surf.f0)
        spec_scale = (d_term * g_term
                      / (4.0 * surf.n_dot_v * n_dot_l + 1e-7))[:, None]
    with span("brdf.sum"):
        contrib = ((surf.diff * (1.0 - f) / PI + f * spec_scale) * radiance
                   * n_dot_l[:, None])
        return contrib, n_dot_l


def cook_torrance_multi_light(surf: Surface, lights: Lights,
                              lit_mask: torch.Tensor | None) -> torch.Tensor:
    """Direct illumination summed over all lights.  ``lit_mask``: (L, N)
    bool visibility from shadow rays (None = all lit).  Returns (N,3)
    linear radiance."""
    out = torch.zeros_like(surf.position)
    for li in range(lights.count):
        ldir, atten, valid, _ = light_sample(surf.position, lights, li)
        contrib, n_dot_l = cook_torrance_single(
            surf, ldir, lights.color[li] * atten[:, None])
        valid = valid & (n_dot_l > 0.0)
        if lit_mask is not None:
            valid = valid & lit_mask[li]
        out = out + torch.where(valid[:, None], contrib, 0.0)
    return out


# ============================================================================
# Tone mapping + gamma
# ============================================================================

TONEMAP_LINEAR = 0
TONEMAP_REINHARD = 1
TONEMAP_FILMIC = 2
TONEMAP_ACES = 3
TONEMAP_AGX = 4


def _hable_partial(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def tonemap(c: torch.Tensor, mode: int) -> torch.Tensor:
    """Apply tonemapper ``mode`` to linear RGB (N,3)."""
    if mode == TONEMAP_LINEAR:
        return c
    if mode == TONEMAP_REINHARD:
        return c / (c + 1.0)
    if mode == TONEMAP_FILMIC:
        return _hable_partial(c) / _hable_partial(11.2)
    if mode == TONEMAP_ACES:
        mapped = (c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59) + 0.14)
        return mapped.clamp(0.0, 1.0)
    if mode == TONEMAP_AGX:
        x = torch.clamp_min(c, 0.0)
        x2 = x * x
        return torch.clamp_max(x2 / (x2 + 0.09 * x + 0.0009), 1.0)
    raise ValueError(f"tonemap mode {mode}")


def to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB gamma approximation."""
    return torch.pow(torch.clamp_min(c, 0.0), 1.0 / 2.2)
