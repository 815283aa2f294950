"""Camera rays and the block swizzle, re-derived from the camera's
parameters.  Every step is one float32 operation (numpy float32
arithmetic is correctly rounded), the ray generation of the port's
camera as it stood when this benchmark was defined."""

from __future__ import annotations

import numpy as np

F32 = np.float32


def look_at(eye, target, fov_degrees, up=(0.0, 1.0, 0.0)):
    """(origin (3,), basis (3, 3) with columns right, up, back), float32."""
    o = np.asarray(eye, F32)
    fwd = np.asarray(target, F32) - o
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, F32)
    if abs(float(np.dot(fwd, upv) / np.linalg.norm(upv))) > 0.999:
        upv = np.array([1.0, 0.0, 0.0], F32)
    right = np.cross(fwd, upv)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    basis = np.stack([right, true_up, -fwd], axis=1).astype(F32)
    return o.astype(F32), basis


def block_permutation(width: int, height: int, block: int = 32,
                      patch=(16, 8)) -> np.ndarray:
    """Raster index of the ray at each position of a block-swizzled frame:
    ``block`` x ``block`` screen blocks, ``patch`` sub-patches inside."""
    ys, xs = np.mgrid[0:height, 0:width]
    by, bx = ys // block, xs // block
    yb, xb = ys % block, xs % block
    bkey = by * ((width + block - 1) // block) + bx
    pw, ph = min(patch[0], block), min(patch[1], block)
    pidx = (yb // ph) * (block // pw) + (xb // pw)
    inkey = (pidx * ph + yb % ph) * pw + xb % pw
    key = bkey * (block * block) + inkey
    return np.argsort(key.reshape(-1), kind="stable")


def frame_rays(eye, target, fov_degrees, width, height, raster_idx):
    """(origin, direction) float32 (n, 3) of the pixels ``raster_idx``
    (raster order, row-major) of a perspective frame: pixel centres,
    vertical field of view, directions normalized."""
    origin, basis = look_at(eye, target, fov_degrees)
    raster_idx = np.asarray(raster_idx, np.int64)
    x = (raster_idx % width).astype(F32)
    y = (raster_idx // width).astype(F32)
    u = (x + F32(0.5)) * F32(2.0) / F32(width) - F32(1.0)
    v = F32(1.0) - (y + F32(0.5)) * F32(2.0) / F32(height)
    tan_half = float(np.tan(np.deg2rad(fov_degrees) * 0.5))
    a = (u * F32(tan_half * (width / height)))[:, None]
    b = (v * F32(tan_half))[:, None]
    world = (a * basis[:, 0] + b * basis[:, 1]) - basis[:, 2]
    sq = world * world
    n2 = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
    d = world / np.sqrt(n2)[:, None]
    o = np.broadcast_to(origin, d.shape).copy()
    return o.astype(F32), d.astype(F32)

