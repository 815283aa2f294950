"""Texture sampling.

PyTorch counterpart of the JAX package's render/textures.py: textures live
in a fixed-shape atlas (K, H, W, C) on the device, so a frame's samples
are one gather — per-pixel (texture id, uv) in, (N, C) texels out, with
repeat wrap.  Textures of other sizes are resampled into the atlas at
registration (nearest).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import DEFAULT_DEVICE


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    """(K, H, W, 3) float32 texture stack; id 0 is reserved white."""

    data: torch.Tensor

    @property
    def count(self) -> int:
        return self.data.shape[0]

    def replace(self, **kw) -> "TextureAtlas":
        return dataclasses.replace(self, **kw)


def atlas_from_jax(*, data, device=DEFAULT_DEVICE) -> TextureAtlas:
    """The port's atlas from a JAX ``TextureAtlas``'s field (numpy)."""
    return TextureAtlas(data=torch.tensor(np.asarray(data, np.float32),
                                          device=device))


class TextureRegistry:
    """Host-side builder for a TextureAtlas."""

    def __init__(self, size: int = 256):
        self.size = size
        self._textures = [np.ones((size, size, 3), np.float32)]  # id 0: white

    def add(self, image: np.ndarray) -> int:
        """Register an (H, W, 3[+]) float image; returns its texture id."""
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        img = img[..., :3]
        h, w = img.shape[:2]
        if (h, w) != (self.size, self.size):
            yi = (np.arange(self.size) * h // self.size).clip(0, h - 1)
            xi = (np.arange(self.size) * w // self.size).clip(0, w - 1)
            img = img[yi][:, xi]
        self._textures.append(img.astype(np.float32))
        return len(self._textures) - 1

    def build(self, device=DEFAULT_DEVICE) -> TextureAtlas:
        return atlas_from_jax(data=np.stack(self._textures), device=device)


def _wrap01(x: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x)


def sample_nearest(atlas: TextureAtlas, tex_id, u, v) -> torch.Tensor:
    """(N,3) nearest-neighbor samples with repeat wrap."""
    h, w = atlas.data.shape[1], atlas.data.shape[2]
    x = (_wrap01(u) * w).to(torch.int64).clamp(0, w - 1)
    y = (_wrap01(v) * h).to(torch.int64).clamp(0, h - 1)
    return atlas.data[tex_id.long(), y, x]


def sample_bilinear(atlas: TextureAtlas, tex_id, u, v) -> torch.Tensor:
    """(N,3) bilinear samples with repeat wrap."""
    h, w = atlas.data.shape[1], atlas.data.shape[2]
    x = _wrap01(u) * w - 0.5
    y = _wrap01(v) * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0w, x1w = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    y0w, y1w = torch.remainder(y0, h), torch.remainder(y0 + 1, h)
    k = tex_id.long()
    c00 = atlas.data[k, y0w, x0w]
    c10 = atlas.data[k, y0w, x1w]
    c01 = atlas.data[k, y1w, x0w]
    c11 = atlas.data[k, y1w, x1w]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy
