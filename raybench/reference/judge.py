"""The comparisons that decide ``correct``, and the answers of the control.

``bad_ray_share``: of the sampled rays, the share whose hit disagrees with
the float64 reference.  A ray agrees when both miss (prim_id -1), or when
both hit and

  * t lies within ``T_RTOL`` * t + ``ANCHOR_ULPS`` float32 ulps of the
    scene's largest coordinate of the reference's t;
  * the triangle it names is hit by the ray in float64 (barycentric slack
    ``BARY_SLACK``) at such a t too, so a tie on a shared edge may name
    either triangle;
  * u, v, the normal (unit, geometric, ``(v1 - v0) x (v2 - v0)``) and the
    position (``o + d t``) agree with that triangle's, and hit_layers
    with its layers.

The limits each number is held to are in ``limits.json`` beside this
file, with the readings they were set from.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import cast as rcast

T_RTOL = 1e-5
ANCHOR_ULPS = 8
BARY_SLACK = 1e-4
UV_TOL = 1e-3
NORMAL_TOL = 1e-3
HIT_FIELDS = ("t", "position", "normal", "u", "v", "prim_id", "hit_layers")

with open(os.path.join(os.path.dirname(__file__), "limits.json")) as _f:
    LIMITS = {k: v["limit"] for k, v in json.load(_f).items()}


def control_hits(origin, direction, t_min, t_max, tris, layer=-1,
                 dtype=torch.bfloat16) -> dict:
    """The reference in the program's place, computed in ``dtype``: the
    answers the control gives for these rays (float32 fields)."""
    t, p = rcast.cast(origin, direction, t_min, t_max, tris, dtype)
    hit = p >= 0
    o, d = origin.to(dtype), direction.to(dtype)
    tri = tris.to(device=origin.device, dtype=dtype)[p.clamp_min(0)]
    _, u, v, _ = rcast.moller_trumbore(o, d, tri)
    z = torch.zeros_like(u)
    f32 = torch.float32
    return {
        "t": torch.where(hit, t.to(f32), 3.402823466e38),
        "position": torch.where(hit[:, None], o + d * t[:, None],
                                z[:, None]).to(f32),
        "normal": torch.where(hit[:, None], rcast.face_normal(tri),
                              z[:, None]).to(f32),
        "u": torch.where(hit, u, z).to(f32),
        "v": torch.where(hit, v, z).to(f32),
        "prim_id": torch.where(hit, p, -1).to(torch.int32),
        "hit_layers": torch.where(hit, layer, 0).to(torch.int32),
    }


def bad_rays(hits: dict, origin, direction, t_min, t_max, tris,
             layer=-1) -> dict:
    """Judge the program's ``hits`` (a dict of HIT_FIELDS tensors for the
    sampled rays) against the float64 reference on the same rays, which
    the caller re-derived.  Returns counts: rays, bad, and why."""
    dev = origin.device
    tris = tris.to(device=dev, dtype=torch.float64)
    f64 = torch.float64
    t_ref, p_ref = rcast.cast(origin, direction, t_min, t_max, tris, f64)
    o, d = origin.to(f64), direction.to(f64)
    h = {k: hits[k].to(dev) for k in HIT_FIELDS}
    prim = h["prim_id"].long()
    hit_p, hit_r = prim >= 0, p_ref >= 0
    atol = ANCHOR_ULPS * float(np.finfo(np.float32).eps) * float(
        tris.abs().max())
    tp = h["t"].to(f64)
    tol = T_RTOL * t_ref.abs().nan_to_num(posinf=0.0) + atol
    tri = tris[prim.clamp(0, tris.shape[0] - 1)]
    t_c, u_c, v_c, ok_c = rcast.moller_trumbore(o, d, tri)
    inside = (ok_c & (u_c >= -BARY_SLACK) & (v_c >= -BARY_SLACK)
              & (u_c + v_c <= 1.0 + BARY_SLACK))
    both = hit_p & hit_r
    checks = {
        "hit_or_miss": hit_p != hit_r,
        "t": both & ((tp - t_ref).abs() > tol),
        "prim": both & ~(inside & ((t_c - t_ref).abs() <= tol)),
        "uv": both & (((h["u"].to(f64) - u_c).abs() > UV_TOL)
                      | ((h["v"].to(f64) - v_c).abs() > UV_TOL)),
        "normal": both & ((h["normal"].to(f64) - rcast.face_normal(tri))
                          .abs().amax(-1) > NORMAL_TOL),
        "position": both & ((h["position"].to(f64) - (o + d * t_ref[:, None]))
                            .abs().amax(-1) > tol * d.abs().amax(-1) + atol),
        "layers": torch.where(hit_p, h["hit_layers"] != layer,
                              h["hit_layers"] != 0),
    }
    bad = torch.zeros_like(hit_p)
    for v in checks.values():
        bad |= v
    out = {"rays": int(prim.numel()), "bad": int(bad.sum()),
           "hits": int(hit_r.sum())}
    out.update({f"bad_{k}": int(v.sum()) for k, v in checks.items()})
    return out


def share(counts: list[dict]) -> float:
    """Bad rays over sampled rays, over every judged unit."""
    rays = sum(c["rays"] for c in counts)
    return sum(c["bad"] for c in counts) / max(rays, 1)
