"""AOV framebuffer (PyTorch counterpart of the JAX package's
render/framebuffer.py): each of the 11 channels is a dense (H*W, 4)
float32 tensor produced by one vectorized shade pass, and ``to_u8`` is the
RGBA8 conversion."""

from __future__ import annotations

import numpy as np
import torch

# Channel ids
COLOR = "color"
NORMAL = "normal"
DEPTH = "depth"
BARYCENTRIC = "barycentric"
POSITION = "position"
PRIM_ID = "prim_id"
HIT_MASK = "hit_mask"
ALBEDO = "albedo"
WIREFRAME = "wireframe"
UV = "uv"
FRESNEL = "fresnel"

ALL_CHANNELS = (
    COLOR, NORMAL, DEPTH, BARYCENTRIC, POSITION, PRIM_ID, HIT_MASK,
    ALBEDO, WIREFRAME, UV, FRESNEL,
)


class RayImage:
    """Dict of AOV channels, each (H*W, 4) float32 (on the frame's
    device)."""

    def __init__(self, width: int, height: int):
        if width <= 0 or height <= 0:
            raise ValueError(f"bad image size {width}x{height}")
        self.width = width
        self.height = height
        self.channels: dict[str, torch.Tensor] = {}

    @property
    def pixel_count(self) -> int:
        return self.width * self.height

    def write(self, channel: str, rgba: torch.Tensor) -> None:
        if channel not in ALL_CHANNELS:
            raise ValueError(f"unknown channel {channel!r}")
        if tuple(rgba.shape) != (self.pixel_count, 4):
            raise ValueError(f"channel {channel}: shape {tuple(rgba.shape)}"
                             f" != {(self.pixel_count, 4)}")
        self.channels[channel] = rgba

    def get(self, channel: str) -> torch.Tensor:
        return self.channels[channel]

    def to_u8(self, channel: str = COLOR) -> np.ndarray:
        """(H, W, 4) uint8 image (clamped)."""
        img = np.clip(self.to_f32(channel), 0.0, 1.0)
        return (img * 255.0 + 0.5).astype(np.uint8)

    def to_f32(self, channel: str = COLOR) -> np.ndarray:
        return self.channels[channel].cpu().numpy().reshape(
            self.height, self.width, 4)
