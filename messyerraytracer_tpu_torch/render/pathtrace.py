"""Multi-bounce path tracer.

PyTorch counterpart of the JAX package's render/pathtrace.py: all pixels
advance through each bounce together as dense tensors — trace the whole
batch, one batched shadow cast for all lights, one shade pass, sample all
bounce directions at once.  Inactive pixels carry dead rays (t_max <
t_min, an instant miss), so batch shapes stay fixed.

  * branchless ONB (Duff et al. 2017)
  * cosine-weighted hemisphere sampling (Malley)
  * GGX half-vector sampling, D cancelled in the weight
  * probabilistic lobe select spec_prob = m + (1-m)(1-r)*0.5 in
    [0.05, 0.95]
  * Russian roulette from bounce 2, survival = min(max(throughput), 0.95)
  * PCG32 with pixel*1009 + frame*6529 + 7 seeding, one state per pixel,
    bit-exact with the JAX package's uint32 streams: torch has too few
    uint32 operations, so the state is int64 holding a value < 2^32,
    masked to 32 bits after every multiply and add
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import Rays
from ..utils.trace import span
from .renderer import SHADOW_EPS, shadow_rays
from .shade import (
    EnvironmentData,
    Lights,
    Materials,
    _unit,
    ambient_color_at,
    cook_torrance_multi_light,
    extract_surface,
    fresnel_schlick,
    geometry_smith_ggx,
    sky_color,
    to_srgb,
    tonemap,
)

PI = 3.14159265358979
_M32 = 0xFFFFFFFF


# ============================================================================
# PCG32, vectorized: int64 states < 2^32
# ============================================================================

def pcg32_seed(seed: torch.Tensor) -> torch.Tensor:
    """Vectorized ``PCG32::seed``: state=0; next(); state+=seed; next()."""
    with span("rng.seed"):
        state = torch.zeros_like(seed, dtype=torch.int64)
        state, _ = pcg32_next(state)
        state = (state + (seed.to(torch.int64) & _M32)) & _M32
        state, _ = pcg32_next(state)
        return state


def pcg32_next(state: torch.Tensor):
    """Advance the state; returns (new_state, output word), both int64
    values < 2^32.  Every product is < 2^32 * 2^30, inside int64."""
    with span("rng.next"):
        old = state
        new = (old * 747796405 + 2891336453) & _M32
        word = ((((old >> ((old >> 28) + 4)) ^ old) * 277803737) & _M32)
        return new, (word >> 22) ^ word


def pcg32_float(state: torch.Tensor):
    """Returns (new_state, float32 in [0,1)): the unsigned word rounded to
    float32, times 2^-32."""
    with span("rng.float"):
        state, word = pcg32_next(state)
        return state, word.to(torch.float32) * (1.0 / 4294967296.0)


def pixel_seeds(n: int, sample_index: int, device) -> torch.Tensor:
    """PCG32 states of ``n`` pixels for one sample: seeded with
    pixel*1009 + sample_index*6529 + 7 (mod 2^32)."""
    with span("rng.seed"):
        pixel = torch.arange(n, dtype=torch.int64, device=device)
        seed = (pixel * 1009 + (int(sample_index) * 6529 & _M32) + 7) & _M32
    return pcg32_seed(seed)


# ============================================================================
# Sampling
# ============================================================================

def construct_onb(n: torch.Tensor):
    """Branchless ONB (Duff 2017).  n: (N,3)."""
    with span("sample.onb"):
        sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0)
        a = -1.0 / (sign + n[:, 2])
        b = n[:, 0] * n[:, 1] * a
    with span("sample.onb"):
        tangent = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a,
                               sign * b, -sign * n[:, 0]], dim=1)
        bitangent = torch.stack([b, sign + n[:, 1] * n[:, 1] * a,
                                 -n[:, 1]], dim=1)
        return tangent, bitangent


def cosine_hemisphere_sample(normal, u1, u2):
    """Malley's method."""
    with span("sample.disk"):
        r = torch.sqrt(u1)
        phi = 2.0 * PI * u2
        x = r * torch.cos(phi)
        y = r * torch.sin(phi)
        z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    t, b = construct_onb(normal)
    with span("sample.unit"):
        return _unit(t * x[:, None] + b * y[:, None] + normal * z[:, None])


def ggx_sample_half(normal, roughness, u1, u2):
    """GGX NDF inverse-CDF half-vector sample."""
    with span("sample.ggx"):
        a = roughness * roughness
        a2 = a * a
        cos_t = torch.sqrt((1.0 - u1) / (1.0 + (a2 - 1.0) * u1 + 1e-8))
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        phi = 2.0 * PI * u2
        lx = sin_t * torch.cos(phi)
        ly = sin_t * torch.sin(phi)
    t, b = construct_onb(normal)
    with span("sample.unit"):
        return _unit(t * lx[:, None] + b * ly[:, None]
                     + normal * cos_t[:, None])


def sample_bounce(surf, rng_state):
    """Batched lobe select + importance sample.  Returns (rng_state,
    direction (N,3), weight (N,3), valid (N,))."""
    rng_state, u_sel = pcg32_float(rng_state)
    rng_state, u1 = pcg32_float(rng_state)
    rng_state, u2 = pcg32_float(rng_state)

    with span("bounce.lobe"):
        spec_prob = (surf.metallic + (1.0 - surf.metallic)
                     * (1.0 - surf.roughness) * 0.5).clamp(0.05, 0.95)
        do_spec = u_sel < spec_prob

    # specular branch (computed for all, selected by mask)
    h = ggx_sample_half(surf.normal, surf.roughness, u1, u2)
    with span("bounce.specular"):
        v_dot_h = torch.clamp_min((surf.view_dir * h).sum(dim=-1), 0.0)
        spec_dir = _unit(h * (2.0 * v_dot_h)[:, None] - surf.view_dir)
        spec_ndl = (surf.normal * spec_dir).sum(dim=-1)
        n_dot_h = torch.clamp_min((surf.normal * h).sum(dim=-1), 0.0)
    with span("bounce.weight"):
        g = geometry_smith_ggx(surf.n_dot_v, spec_ndl, surf.roughness)
    with span("bounce.fresnel"):
        f = fresnel_schlick(v_dot_h[:, None], surf.f0)
        common = g * v_dot_h / (surf.n_dot_v * n_dot_h * spec_prob + 1e-8)
        spec_w = f * common[:, None]
        spec_valid = spec_ndl > 0.0

    # diffuse branch
    diff_dir = cosine_hemisphere_sample(surf.normal, u1, u2)
    with span("bounce.select"):
        diff_ndl = (surf.normal * diff_dir).sum(dim=-1)
        diff_w = surf.diff / (1.0 - spec_prob)[:, None]
        diff_valid = diff_ndl > 0.0
        direction = torch.where(do_spec[:, None], spec_dir, diff_dir)
        weight = torch.where(do_spec[:, None], spec_w, diff_w)
        valid = torch.where(do_spec, spec_valid, diff_valid)
    return rng_state, direction, weight, valid


def russian_roulette(throughput, active, rng):
    """Russian roulette: survival = min(max(throughput), 0.95); survivors
    are reweighted by 1/survival.  Returns (throughput, active, rng)."""
    survival = torch.clamp_max(throughput.amax(dim=-1), 0.95)
    rng, u = pcg32_float(rng)
    survive = u < survival
    throughput = torch.where(
        (active & survive)[:, None],
        throughput / torch.clamp_min(survival, 1e-6)[:, None], throughput)
    return throughput, active & survive, rng


def bounce_rays(hits, surf, direction) -> Rays:
    """Next-bounce rays from the hit points, offset along the normal."""
    n = hits.t.shape[0]
    dev = hits.t.device
    return Rays(origin=hits.position + surf.normal * SHADOW_EPS,
                direction=direction,
                t_min=torch.full((n,), 1e-3, dtype=torch.float32, device=dev),
                t_max=torch.full((n,), 3.0e38, dtype=torch.float32,
                                 device=dev))


def dead_unless(rays: Rays, active: torch.Tensor) -> Rays:
    """``rays`` with t_max = -1 (an instant miss) where not ``active``."""
    return Rays(rays.origin, rays.direction, rays.t_min,
                torch.where(active, rays.t_max, -1.0))


# ============================================================================
# Path tracer
# ============================================================================

@dataclasses.dataclass
class PathTraceParams:
    width: int
    height: int
    max_bounces: int = 3
    sample_index: int = 0  # frame number for RNG decorrelation


class PathTracer:
    """Iterative wavefront path tracer.

    ``trace_frame(params, rays) -> (N,3) linear radiance`` then the caller
    tonemaps, or ``trace_frame_srgb`` for the display-ready image.
    ``sort_secondary`` Morton-sorts bounce rays by direction before each
    cast (and unshuffles the hits).
    """

    def __init__(self, scene, lights: Lights | None, env: EnvironmentData,
                 materials: Materials, mat_id_of_prim=None,
                 attributes=None, atlas=None,
                 sort_secondary: bool = False):
        self.scene = scene
        self.lights = lights
        self.env = env
        self.materials = materials
        self.mat_id_of_prim = mat_id_of_prim
        self.attributes = attributes
        self.atlas = atlas
        self.sort_secondary = sort_secondary

    def _mat_ids(self, hits):
        pid = hits.prim_id.clamp_min(0).long()
        if self.mat_id_of_prim is not None:
            return self.mat_id_of_prim[pid]
        return torch.zeros_like(pid)

    def trace_frame(self, params: PathTraceParams,
                    rays: Rays) -> torch.Tensor:
        """One sample per pixel of full path-traced radiance, linear RGB:
        trace -> shadows -> shade/emit -> sample bounce -> Russian
        roulette, with inactive lanes masked (not compacted)."""
        n = rays.count
        rng = pixel_seeds(n, params.sample_index, rays.origin.device)
        throughput = torch.ones_like(rays.origin)
        accum = torch.zeros_like(rays.origin)
        active = torch.ones((n,), dtype=torch.bool,
                            device=rays.origin.device)
        cur = rays
        env = self.env

        for bounce in range(params.max_bounces + 1):
            cast = dead_unless(cur, active)
            if bounce >= 1 and self.sort_secondary:
                from ..dispatch.morton import (sort_rays_by_direction,
                                               unshuffle_hits)

                sorted_rays, perm = sort_rays_by_direction(cast)
                hits_s, _ = self.scene.cast_rays(sorted_rays)
                hits = unshuffle_hits(hits_s, perm)
            else:
                hits, _ = self.scene.cast_rays(cast)
            hit = hits.hit & active

            # miss -> sky, the path ends
            sky = sky_color(cur.direction, env)
            accum = accum + torch.where((active & ~hits.hit)[:, None],
                                        throughput * sky, 0.0)

            surf = extract_surface(hits, cur.direction, self.materials,
                                   self._mat_ids(hits),
                                   attrs=self.attributes, atlas=self.atlas)
            accum = accum + torch.where(hit[:, None],
                                        throughput * surf.emission, 0.0)

            # direct lighting with shadow rays
            if self.lights is not None:
                occ = self.scene.any_hit_rays(
                    shadow_rays(hits, self.lights, hit))
                lit = ~occ.reshape(self.lights.count, n)
                direct = cook_torrance_multi_light(surf, self.lights, lit)
                accum = accum + torch.where(hit[:, None],
                                            throughput * direct, 0.0)

            # ambient only on primary hits
            if bounce == 0:
                amb = ambient_color_at(surf.normal, env)
                accum = accum + torch.where(
                    hit[:, None],
                    throughput * surf.diff * amb * env.ambient_color
                    * env.ambient_energy, 0.0)

            if bounce == params.max_bounces:
                break

            rng, bdir, bweight, bvalid = sample_bounce(surf, rng)
            active = hit & bvalid
            throughput = torch.where(active[:, None], throughput * bweight,
                                     throughput)
            if bounce >= 1:
                throughput, active, rng = russian_roulette(throughput,
                                                           active, rng)
            cur = bounce_rays(hits, surf, bdir)

        return accum

    def trace_frame_srgb(self, params: PathTraceParams, rays: Rays):
        """trace + tonemap + gamma."""
        linear = self.trace_frame(params, rays)
        return to_srgb(tonemap(linear, self.env.tonemap_mode))
