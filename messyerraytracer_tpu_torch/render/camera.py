"""Batch ray generation (PyTorch counterpart of the JAX package's
render/camera.py; same semantics):

  * pixel center at +0.5, NDC u = 2*(x+jx)/w - 1, v = 1 - 2*(y+jy)/h
  * perspective: view dir (u*half_w, v*half_h, -1) with
    half_h = tan(fov/2), half_w = half_h * aspect (vertical FOV),
    transformed by the camera basis, normalized
  * orthographic: uniform forward direction, origin offset in the camera
    XY plane
  * debug grid: half_w = tan(fov/2), half_h = half_w * (h/w), v NOT
    flipped (positive v = camera up)

Rays come out in row-major raster order, built on ``device``.  Each step
is one float32 operation, computed in float64 and rounded to float32
(``_r32``): for +, -, *, / and sqrt of float32 operands that gives the
correctly rounded float32 result (float64 carries more than twice
float32's precision).  Neither device's own float32 code is: PyTorch's CPU
sqrt misses the nearest float32 on some inputs, and CUDA turns a
division by a scalar into a multiply by its reciprocal.  The CPU and the
card so give the same rays, bit for bit: those of exact float32
arithmetic done step by step.

On a card ``generate_rays`` is one launch of the camera kernel
(kernels/camera_rays.py, ``csrc/camera_rays.cu``): the same float32
steps in the same order, each correctly rounded, so the same bits, with
every scalar passed by value (no host to device copy, no stream sync).
``_generate_rays`` is the plain version: the CPU's path, and what the
tests hold the kernel against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import DEFAULT_DEVICE, Rays, make_rays
from ..kernels.camera_rays import camera_rays_cuda
from ..utils.trace import span


def _r32(x: torch.Tensor) -> torch.Tensor:
    """Round float64 values to the nearest float32, kept in float64 (the
    module docstring says why every step of the camera is float64)."""
    return x.to(torch.float32).to(torch.float64)  # lint: off


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| for float32 values held in float64, rounded to float32
    after every operation."""
    with span("camera.length"):
        sq = _r32(v * v)
        n2 = _r32(_r32(sq[..., 0:1] + sq[..., 1:2]) + sq[..., 2:3])
    with span("camera.unit"):
        return _r32(v / _r32(torch.sqrt(n2)))


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Plain-float camera description.

    basis: (3,3) columns are camera-space right / up / back (-forward),
    i.e. the camera looks along -Z.
    """

    origin: tuple
    basis: tuple  # 3x3 nested tuple: basis[:, i] = axis i
    fov_degrees: float = 75.0
    ortho: bool = False
    ortho_size: float = 4.0  # full vertical extent in world units

    @staticmethod
    def look_at(origin, target, up=(0.0, 1.0, 0.0), fov_degrees=75.0,
                ortho=False, ortho_size=4.0) -> "CameraParams":
        """Construct a camera basis looking from origin toward target."""
        with span("camera.look_at"):
            o = np.asarray(origin, np.float32)
            fwd = np.asarray(target, np.float32) - o
            fwd = fwd / np.linalg.norm(fwd)
            upv = np.asarray(up, np.float32)
            if abs(float(np.dot(fwd, upv) / np.linalg.norm(upv))) > 0.999:
                upv = np.array([1.0, 0.0, 0.0], np.float32)
            right = np.cross(fwd, upv)
            right = right / np.linalg.norm(right)
            true_up = np.cross(right, fwd)
            basis = np.stack([right, true_up, -fwd], axis=1)  # -Z = forward
            return CameraParams(
                origin=tuple(float(x) for x in o),
                basis=tuple(tuple(float(x) for x in row) for row in basis),
                fov_degrees=fov_degrees,
                ortho=ortho,
                ortho_size=ortho_size,
            )


def generate_rays(cam: CameraParams, width: int, height: int,
                  jitter=(0.5, 0.5), device=DEFAULT_DEVICE) -> Rays:
    """Generate width*height rays in raster order (row-major, top-left
    first).  ``jitter`` is the sub-pixel offset in [0,1): a pair of
    scalars or of (H, W) arrays.  On a CUDA device one launch of the
    camera kernel, with no host sync (and, for scalar jitter, no host to
    device copy); elsewhere the plain version.  The card's rays equal the
    CPU's bit for bit."""
    dev = torch.device(device)
    with span("camera.rays"):
        if dev.type == "cuda":
            return _generate_rays_cuda(cam, width, height, jitter, dev)
        return _generate_rays(cam, width, height, jitter, dev)


def _plane_scales(cam: CameraParams, width: int, height: int) -> tuple:
    """(sx, sy), Python floats, that scale NDC u and v onto the image
    plane: (half_w, tan(fov/2)) for a perspective camera, (half_w, half_h)
    for an orthographic one."""
    if cam.ortho:
        half_h = cam.ortho_size * 0.5
        return half_h * (width / height), half_h
    tan_half = float(np.tan(np.deg2rad(cam.fov_degrees) * 0.5))
    return tan_half * (width / height), tan_half


def _f64(x, dev: torch.device) -> torch.Tensor:
    """float32 values (a float is rounded to float32 first, as a float32
    operation with a scalar operand does), held in float64."""
    return torch.as_tensor(x, dtype=torch.float32,
                           device=dev).to(torch.float64)  # lint: off


def _jitter_plane(j, width: int, height: int, dev: torch.device):
    """One half of ``jitter`` as the camera kernel takes it: a number as
    it is, an array as a contiguous (H, W) float32 tensor on ``dev`` (a
    host array is copied once)."""
    if not isinstance(j, torch.Tensor) and np.ndim(j) == 0:
        return j
    return torch.as_tensor(j, dtype=torch.float32, device=dev).broadcast_to(
        (height, width)).contiguous()


def _generate_rays_cuda(cam: CameraParams, width: int, height: int, jitter,
                        dev: torch.device) -> Rays:
    """``generate_rays`` on a card: one launch of the camera kernel."""
    o, d, t_min, t_max = camera_rays_cuda(
        width, height, cam.ortho, cam.origin, cam.basis,
        [_jitter_plane(j, width, height, dev) for j in jitter],
        _plane_scales(cam, width, height), dev)
    return Rays(origin=o, direction=d, t_min=t_min, t_max=t_max)


def _generate_rays(cam: CameraParams, width: int, height: int, jitter,
                   dev: torch.device) -> Rays:
    """The plain version of ``generate_rays`` on ``dev``, inside its
    span: each step a float64 op rounded to float32 (module docstring)."""

    def f64(x):
        return _f64(x, dev)

    with span("camera.grid"):
        origin, basis = f64(cam.origin), f64(cam.basis)
        jx, jy = (f64(j) for j in jitter)
        x = torch.arange(width, dtype=torch.float64,  # lint: off
                         device=dev)[None, :]
        y = torch.arange(height, dtype=torch.float64,  # lint: off
                         device=dev)[:, None]
        w64, h64 = f64(width), f64(height)
    with span("camera.ndc"):
        u = _r32(_r32(2.0 * _r32(x + jx)) / w64) - 1.0
        v = 1.0 - _r32(_r32(2.0 * _r32(y + jy)) / h64)
        u, v = torch.broadcast_tensors(_r32(u), _r32(v))
    sx, sy = _plane_scales(cam, width, height)

    if not cam.ortho:
        with span("camera.plane"):
            a = _r32(u * f64(sx))[..., None]
            b = _r32(v * f64(sy))[..., None]
        with span("camera.dirs"):
            world = _r32(_r32(_r32(a * basis[:, 0]) + _r32(b * basis[:, 1]))
                         - basis[:, 2])
        d = _normalize(world)
        with span("camera.make"):
            d = d.to(torch.float32)
            o = origin.to(torch.float32).expand(d.shape)
    else:
        with span("camera.dirs"):
            uw = _r32(u * f64(sx))[..., None]
            vh = _r32(v * f64(sy))[..., None]
            o = _r32(_r32(origin + _r32(basis[:, 0] * uw))
                     + _r32(basis[:, 1] * vh))
            o = o.to(torch.float32)
            d = (-basis[:, 2]).to(torch.float32).expand(o.shape)
    with span("camera.make"):
        return make_rays(o.reshape(-1, 3), d.reshape(-1, 3), device=dev)


def debug_grid_rays(origin, forward, grid_w: int = 16, grid_h: int = 12,
                    fov_degrees: float = 60.0,
                    device=DEFAULT_DEVICE) -> Rays:
    """The debug ray grid: camera basis from forward + world-up hint
    (fallback +X when |dot| > 0.99), pixel centers, v not flipped,
    row-major with y=0 row first."""
    o = np.asarray(origin, np.float32)
    fwd = np.asarray(forward, np.float32)
    fwd = fwd / np.linalg.norm(fwd)
    up_hint = np.array([0.0, 1.0, 0.0], np.float32)
    if abs(float(np.dot(fwd, up_hint))) > 0.99:
        up_hint = np.array([1.0, 0.0, 0.0], np.float32)
    right = np.cross(fwd, up_hint)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    up = up / np.linalg.norm(up)

    half_w = float(np.tan(np.deg2rad(fov_degrees) * 0.5))
    half_h = half_w * (grid_h / grid_w)

    x = torch.arange(grid_w, dtype=torch.float32)[None, :]
    y = torch.arange(grid_h, dtype=torch.float32)[:, None]
    u = (2.0 * (x + 0.5) / grid_w - 1.0) * half_w
    v = (2.0 * (y + 0.5) / grid_h - 1.0) * half_h
    u, v = torch.broadcast_tensors(u, v)
    # normalized in float64 steps rounded to float32 (module docstring)
    d = _normalize((torch.from_numpy(fwd) + torch.from_numpy(right)
                    * u[..., None] + torch.from_numpy(up) * v[..., None]
                    ).to(torch.float64)).to(torch.float32)  # lint: off
    o_arr = torch.from_numpy(o).expand(d.shape)
    return make_rays(o_arr.reshape(-1, 3), d.reshape(-1, 3), device=device)
