"""Hybrid ray-traced reflections.

PyTorch counterpart of the JAX package's render/reflections.py, four
passes per frame over the primary-hit arrays (the G-buffer):

  1. trace     — reflect the view ray at each hit and trace it (one cast)
  2. denoise   — 5x5 cross-bilateral filter guided by depth + normal
  3. temporal  — EMA history accumulation with depth rejection
  4. composite — Fresnel-weighted, roughness-faded blend into the color
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import Rays
from .shade import EnvironmentData, fresnel_schlick, sky_color


@dataclasses.dataclass
class ReflectionSettings:
    intensity: float = 1.0
    max_roughness: float = 0.6    # fade out above this roughness
    temporal_blend: float = 0.1   # EMA alpha
    depth_sigma: float = 0.5      # spatial bilateral guides
    normal_sigma: float = 16.0
    spatial_radius: int = 2       # 5x5 kernel
    ray_bias: float = 1e-3


class RTReflections:
    """Stateful reflections pass (temporal history across frames)."""

    def __init__(self, scene, env: EnvironmentData,
                 settings: ReflectionSettings | None = None):
        self.scene = scene
        self.env = env
        self.settings = settings or ReflectionSettings()
        self._history: torch.Tensor | None = None   # (H, W, 3)
        self._history_depth: torch.Tensor | None = None

    def reset(self):
        self._history = None
        self._history_depth = None

    # -- pass 1: trace --------------------------------------------------
    def trace(self, hits, view_dirs, width, height,
              shade_fn=None) -> torch.Tensor:
        """Reflect primary rays at hit points and trace them.
        ``shade_fn(hits2, dirs) -> (N,3)`` colors the reflection hits
        (defaults to sky + flat normal shading).  Returns (H, W, 3)."""
        st = self.settings
        n = hits.t.shape[0]
        nrm = hits.normal
        refl = view_dirs - 2.0 * (view_dirs * nrm).sum(
            dim=-1, keepdim=True) * nrm
        alive = hits.hit
        rays = Rays(
            origin=hits.position + nrm * st.ray_bias,
            direction=refl,
            t_min=torch.full((n,), 1e-3, dtype=torch.float32,
                             device=hits.t.device),
            t_max=torch.where(alive, 3.0e38, -1.0),
        )
        hits2, _ = self.scene.cast_rays(rays)
        if shade_fn is None:
            sky = sky_color(refl, self.env)
            lit = 0.5 + 0.5 * hits2.normal[:, 1:2].clamp(-1, 1)
            base = torch.where(hits2.hit[:, None], lit * 0.8, sky)
        else:
            base = shade_fn(hits2, refl)
        out = torch.where(alive[:, None], base, 0.0)
        return out.reshape(height, width, 3)

    # -- pass 2: spatial cross-bilateral denoise ------------------------
    def denoise_spatial(self, color, depth, normal) -> torch.Tensor:
        """5x5 bilateral filter guided by depth + normal similarity.  All
        (H, W, C) tensors."""
        st = self.settings
        r = st.spatial_radius
        acc = torch.zeros_like(color)
        wsum = torch.zeros(color.shape[:2] + (1,), dtype=torch.float32,
                           device=color.device)
        inv_2ds = 1.0 / (2.0 * st.depth_sigma * st.depth_sigma)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                c = torch.roll(color, (dy, dx), (0, 1))
                d = torch.roll(depth, (dy, dx), (0, 1))
                nn = torch.roll(normal, (dy, dx), (0, 1))
                wd = torch.exp(-(d - depth) ** 2 * inv_2ds)
                ndot = (nn * normal).sum(dim=-1, keepdim=True).clamp(0.0,
                                                                     1.0)
                w = wd * ndot ** st.normal_sigma
                acc = acc + c * w
                wsum = wsum + w
        return acc / torch.clamp_min(wsum, 1e-6)

    # -- pass 3: temporal EMA -------------------------------------------
    def temporal(self, color, depth) -> torch.Tensor:
        """History EMA (blend alpha) with depth rejection."""
        st = self.settings
        if self._history is None:
            self._history = color
            self._history_depth = depth
            return color
        reject = (depth - self._history_depth).abs() > 4.0 * st.depth_sigma
        blended = (self._history * (1.0 - st.temporal_blend)
                   + color * st.temporal_blend)
        out = torch.where(reject, color, blended)
        self._history = out
        self._history_depth = depth
        return out

    # -- pass 4: composite ----------------------------------------------
    def composite(self, base_color, reflection, n_dot_v, roughness,
                  hit_mask) -> torch.Tensor:
        """Fresnel-weighted, roughness-faded additive blend."""
        st = self.settings
        f = fresnel_schlick(n_dot_v.clamp(0.0, 1.0), 0.04)
        fade = (1.0 - roughness / st.max_roughness).clamp(0.0, 1.0)
        w = (f * fade * st.intensity * hit_mask)[..., None]
        return base_color * (1.0 - w) + reflection * w

    # -- full frame ------------------------------------------------------
    def render(self, hits, view_dirs, base_color, roughness, width, height,
               shade_fn=None) -> torch.Tensor:
        """Run all 4 passes.  ``base_color``: (H, W, 3); ``roughness``:
        (H, W); returns composited (H, W, 3)."""
        depth = hits.t.reshape(height, width, 1)
        depth = torch.where(torch.isfinite(depth), depth, 0.0)
        normal = hits.normal.reshape(height, width, 3)
        refl = self.trace(hits, view_dirs, width, height, shade_fn)
        refl = self.denoise_spatial(refl, depth, normal)
        refl = self.temporal(refl, depth)
        ndv = (-(view_dirs * hits.normal).sum(dim=-1)).clamp(
            0.0, 1.0).reshape(height, width)
        hm = hits.hit.reshape(height, width).to(torch.float32)
        return self.composite(base_color, refl, ndv, roughness, hm)
