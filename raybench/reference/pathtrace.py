"""A path-traced frame re-traced path by path: a frozen copy of the
wavefront path tracer's per-path math (PCG32 streams, next-event
estimation with one picked light, GGX and cosine lobes, Russian roulette
from bounce 2) over ``reference.cast`` on the world triangles.

Every path is independent of the others, so the frame's order of waves,
sorts and gathers does not enter.  The shading runs in ``dtype`` (float64
for the reference, bfloat16 for the control); the PCG32 words are exact
integers, turned into float32 uniforms as the program does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cast as rcast

PI = 3.14159265358979
M32 = 0xFFFFFFFF
SHADOW_EPS = 1e-3
BOUNCE_T_MIN = 1e-3
BOUNCE_T_MAX = 3.0e38
DIRECTIONAL_T_MAX = 1e30


def pcg32_next(state):
    new = (state * 747796405 + 2891336453) & M32
    word = ((((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32)
    return new, (word >> 22) ^ word


def pcg32_uniform(state, dtype):
    state, word = pcg32_next(state)
    u = word.to(torch.float32) * (1.0 / 4294967296.0)
    return state, u.to(dtype)


def pixel_seeds(n: int, sample_index: int, device):
    """PCG32 states seeded with pixel*1009 + sample*6529 + 7 (mod 2^32):
    state 0, one step, add the seed, one step."""
    pixel = torch.arange(n, dtype=torch.int64, device=device)
    seed = (pixel * 1009 + (int(sample_index) * 6529 & M32) + 7) & M32
    state, _ = pcg32_next(torch.zeros_like(seed))
    state, _ = pcg32_next((state + seed) & M32)
    return state


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _unit(v):
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True), 1e-12)


def _onb(n):
    sign = torch.where(n[:, 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b,
                     -sign * n[:, 0]], dim=1)
    bt = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=1)
    return t, bt


def _g_smith(n_dot_v, n_dot_l, rough):
    a2 = (rough * rough) ** 2

    def g1(x):
        return 2.0 * x / (x + torch.sqrt(a2 + (1.0 - a2) * x * x) + 1e-7)

    return g1(n_dot_v) * g1(n_dot_l)


def _fresnel(cos_theta, f0):
    t = 1.0 - cos_theta
    return f0 + (1.0 - f0) * (t * t * t * t * t)


def _d_ggx(n_dot_h, rough):
    a2 = (rough * rough) ** 2
    den = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * den * den + 1e-7)


def _sky(d, sky):
    t = d[:, 1] * 0.5 + 0.5
    zen, hor, gnd = sky
    upper = hor + (zen - hor) * ((t - 0.5) * 2.0)[:, None]
    lower = gnd + (hor - gnd) * (t * 2.0)[:, None]
    return torch.where((t > 0.5)[:, None], upper, lower)


def _sample_bounce(n, view, n_dot_v, mat, rng, dtype):
    rng, u_sel = pcg32_uniform(rng, dtype)
    rng, u1 = pcg32_uniform(rng, dtype)
    rng, u2 = pcg32_uniform(rng, dtype)
    metal, rough = mat["metallic"], mat["roughness"]
    spec_prob = min(max(metal + (1.0 - metal) * (1.0 - rough) * 0.5, 0.05),
                    0.95)
    do_spec = u_sel < spec_prob
    tb, bb = _onb(n)
    # specular: a GGX half vector
    a2 = (rough * rough) ** 2
    cos_t = torch.sqrt((1.0 - u1) / (1.0 + (a2 - 1.0) * u1 + 1e-8))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * PI * u2
    h = _unit(tb * (sin_t * torch.cos(phi))[:, None]
              + bb * (sin_t * torch.sin(phi))[:, None] + n * cos_t[:, None])
    v_dot_h = torch.clamp_min(_dot(view, h), 0.0)
    spec_dir = _unit(h * (2.0 * v_dot_h)[:, None] - view)
    spec_ndl = _dot(n, spec_dir)
    n_dot_h = torch.clamp_min(_dot(n, h), 0.0)
    g = _g_smith(n_dot_v, spec_ndl, rough)
    f = _fresnel(v_dot_h[:, None], mat["f0"])
    spec_w = f * (g * v_dot_h
                  / (n_dot_v * n_dot_h * spec_prob + 1e-8))[:, None]
    # diffuse: cosine-weighted (Malley)
    r = torch.sqrt(u1)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    diff_dir = _unit(tb * (r * torch.cos(phi))[:, None]
                     + bb * (r * torch.sin(phi))[:, None] + n * z[:, None])
    diff_w = (mat["diff"] / (1.0 - spec_prob)).expand_as(spec_w)
    direction = torch.where(do_spec[:, None], spec_dir, diff_dir)
    weight = torch.where(do_spec[:, None], spec_w, diff_w)
    valid = torch.where(do_spec, spec_ndl > 0.0, _dot(n, diff_dir) > 0.0)
    return rng, direction, weight, valid


def _cast(o, d, tmin, tmax, live, tris, dtype, any_hit):
    """Cast the ``live`` rays only; the rest miss."""
    idx = live.nonzero()[:, 0]
    n = o.shape[0]
    if any_hit:
        out = torch.zeros((n,), dtype=torch.bool, device=o.device)
        if idx.numel():
            out[idx] = rcast.cast(o[idx], d[idx], tmin[idx], tmax[idx], tris,
                                  dtype, any_hit=True)
        return out
    t = torch.full((n,), float("inf"), dtype=dtype, device=o.device)
    p = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    if idx.numel():
        t[idx], p[idx] = rcast.cast(o[idx], d[idx], tmin[idx], tmax[idx],
                                    tris, dtype)
    return t, p


def shading_inputs(light: dict, sky: dict, material: dict, device, dtype):
    """Light, sky and material as tensors of ``dtype``, prepared from the
    traffic's values as the program's tables are (float32 first)."""
    f = np.float32
    ld = np.asarray(light["direction"], f)
    ld = ld / max(np.linalg.norm(ld), 1e-12)
    col = np.asarray(light["color"], f) * light["energy"]
    put = lambda x: torch.as_tensor(np.asarray(x, f), device=device,  # noqa
                                    dtype=dtype)
    alb = np.asarray(material["albedo"], f)
    metal, rough = f(material["metallic"]), f(max(material["roughness"],
                                                  0.04))
    spec = f(material["specular"])
    f0 = (f(0.04) * spec * f(2.0)) * (f(1.0) - metal) + alb * metal
    return {
        "light_dir": put(ld), "light_color": put(col),
        "sky": tuple(put(sky[k]) for k in ("zenith", "horizon", "ground")),
        "mat": {"metallic": float(metal), "roughness": float(rough),
                "f0": put(f0), "diff": put(alb * (f(1.0) - metal)),
                "emission": put(material.get("emission", (0.0, 0.0, 0.0)))},
    }


def trace_frame(origin, direction, tris, shading: dict, sample_index: int,
                max_bounces: int, dtype=torch.float64):
    """(linear RGB (N, 3) float32, wave rays): the frame of the camera
    rays (origin, direction; float32, pixel order) as the wavefront tracer
    defines it, with light, sky and material from ``shading_inputs``."""
    dev, n = origin.device, origin.shape[0]
    tris = tris.to(device=dev, dtype=dtype)
    mat = shading["mat"]
    ldir, lcol = shading["light_dir"], shading["light_color"]
    o, d = origin.to(dtype), direction.to(dtype)
    tmin = torch.full((n,), 1e-3, dtype=dtype, device=dev)
    tmax = torch.full((n,), 3.402823466e38, device=dev).to(dtype)
    throughput = torch.ones((n, 3), dtype=dtype, device=dev)
    accum = torch.zeros((n, 3), dtype=dtype, device=dev)
    pending = torch.zeros_like(accum)
    rng = pixel_seeds(n, sample_index, dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    visible = torch.zeros_like(active)
    wave = 0
    for bounce in range(max_bounces + 1):
        t, prim = _cast(o, d, tmin, tmax, active, tris, dtype, False)
        hit = active & (prim >= 0)
        wave += int(active.sum())
        accum = accum + torch.where(visible[:, None], pending, 0.0)
        accum = accum + torch.where((active & ~hit)[:, None],
                                    throughput * _sky(d, shading["sky"]), 0.0)
        accum = accum + torch.where(hit[:, None],
                                    throughput * mat["emission"], 0.0)
        tri = tris[prim.clamp_min(0)]
        nrm = rcast.face_normal(tri)
        pos = o + d * torch.where(hit, t, 0.0)[:, None]
        nrm = torch.where((_dot(nrm, d) > 0.0)[:, None], -nrm, nrm)
        view = -d
        n_dot_v = torch.clamp_min(_dot(nrm, view), 1e-4)
        # next-event estimation towards the one light
        rng, _ = pcg32_uniform(rng, dtype)
        ndl = _dot(nrm, ldir.expand_as(nrm))
        h = _unit(view + ldir)
        ndh = torch.clamp_min(_dot(nrm, h), 0.0)
        vdh = torch.clamp_min(_dot(view, h), 0.0)
        f = _fresnel(vdh[:, None], mat["f0"])
        spec = (_d_ggx(ndh, mat["roughness"])
                * _g_smith(n_dot_v, ndl, mat["roughness"])
                / (4.0 * n_dot_v * ndl + 1e-7))[:, None]
        contrib = ((mat["diff"] * (1.0 - f) / PI + f * spec) * lcol
                   * ndl[:, None])
        lvalid = ndl > 0.0
        shadow_valid = hit & lvalid
        pending = torch.where(shadow_valid[:, None],
                              throughput * torch.where(lvalid[:, None],
                                                       contrib, 0.0), 0.0)
        s_o = pos + nrm * SHADOW_EPS
        s_tmax = torch.where(shadow_valid, DIRECTIONAL_T_MAX, -1.0).to(dtype)
        # the bounce
        rng, bdir, bweight, bvalid = _sample_bounce(nrm, view, n_dot_v, mat,
                                                    rng, dtype)
        active = hit & bvalid
        throughput = torch.where(active[:, None], throughput * bweight,
                                 throughput)
        if bounce >= 1:
            survival = torch.clamp_max(throughput.amax(dim=-1), 0.95)
            rng, u = pcg32_uniform(rng, dtype)
            live = u < survival
            throughput = torch.where(
                (active & live)[:, None],
                throughput / torch.clamp_min(survival, 1e-6)[:, None],
                throughput)
            active = active & live
        wave += int(shadow_valid.sum())
        occluded = _cast(s_o, ldir.expand_as(s_o),
                         torch.full_like(tmin, SHADOW_EPS), s_tmax,
                         shadow_valid, tris, dtype, True)
        visible = ~occluded & shadow_valid
        o, d = pos + nrm * SHADOW_EPS, bdir
        tmin = torch.full_like(tmin, BOUNCE_T_MIN)
        tmax = torch.full_like(tmax, BOUNCE_T_MAX)
    accum = accum + torch.where(visible[:, None], pending, 0.0)
    return accum.to(torch.float32), wave


def pixel_gaps(image, ref) -> torch.Tensor:
    """Per pixel, the largest channel gap over 1e-3 + 1e-3 |reference|."""
    ref = ref.to(image.device, torch.float64)
    gap = (image.to(torch.float64) - ref).abs() - 1e-3 * ref.abs()
    return gap.amax(dim=-1)
