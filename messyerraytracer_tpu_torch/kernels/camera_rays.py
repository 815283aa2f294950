"""A frame of camera rays in one launch of ``csrc/camera_rays.cu``.

The JAX package makes its camera rays in jnp
(``messyerraytracer_tpu/render/camera.py``, ``generate_rays``): this kernel
replaces no Pallas kernel.  ``render/camera.py::generate_rays`` calls
``camera_rays_cuda`` for a card and its plain version for the CPU; the
kernel gives the plain version's rays bit for bit (the source's note says
why).  Every scalar goes to the C entry by value, rounded to float32 here
as the plain version rounds it on upload, so a launch makes no host to
device copy and does not wait for the stream; per-pixel jitter goes in as
two (H, W) float32 tensors on the card.
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from ..core.types import T_MAX_DEFAULT, T_MIN_DEFAULT
from ..native import CudaLibrary, check, cuda_device
from ..utils.trace import count

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
cuda_library = CudaLibrary("camera_rays.cu", "libmrt_camera_rays.so", {
    "mrt_camera_rays": (
        [_i, _i, _i]                    # width, height, ortho
        + [_f] * 12                     # origin, basis (row-major)
        + [_f, _f, _p, _p]              # jitter: scalars, planes
        + [_f] * 6                      # w, h, sx, sy, t_min, t_max
        + [_p, _p, _p, _p, _p])})       # outputs, stream


def kernel_args(width: int, height: int, ortho: bool, origin, basis, jitter,
                scale, outs) -> list:
    """The C entry's arguments up to the stream.  ``origin`` (3,),
    ``basis`` (3, 3) rows, ``scale`` (sx, sy) are plain numbers; each half
    of ``jitter`` is a number or an (H, W) float32 tensor (passed by
    pointer); ``outs`` the four output tensors.  Every float is rounded to
    float32 here, as ``torch.as_tensor(x, dtype=torch.float32)`` rounds
    it, and passed as a Python float that a C float holds exactly."""
    planes = [j.data_ptr() if isinstance(j, torch.Tensor) else None
              for j in jitter]
    scalars = [0.0 if isinstance(j, torch.Tensor) else j for j in jitter]
    f32 = np.array([*origin, *itertools.chain.from_iterable(basis),
                    *scalars, width, height, *scale, T_MIN_DEFAULT,
                    T_MAX_DEFAULT], np.float32).tolist()
    return ([int(width), int(height), int(bool(ortho))] + f32[:14] + planes
            + f32[14:] + [t.data_ptr() for t in outs])


def camera_rays_cuda(width: int, height: int, ortho: bool, origin, basis,
                     jitter, scale, device) -> tuple:
    """(origin (N, 3), direction (N, 3), t_min (N,), t_max (N,)) of the
    width x height frame in raster order, N = width * height, in new
    tensors on the card ``device``: one launch of the camera kernel on the
    current stream, without synchronizing; raises if the launch is
    refused.  Arguments as ``kernel_args``; ``scale`` is (half_w,
    tan(fov / 2)) for a perspective camera, (half_w, half_h) for an
    orthographic one."""
    cuda_device(device, "camera_rays_cuda")
    n, f32 = width * height, torch.float32
    outs = (torch.empty((n, 3), dtype=f32, device=device),
            torch.empty((n, 3), dtype=f32, device=device),
            torch.empty((n,), dtype=f32, device=device),
            torch.empty((n,), dtype=f32, device=device))
    dev = outs[0].device
    for j in jitter:
        if isinstance(j, torch.Tensor):
            check(j, "per-pixel jitter", f32, (height, width), dev)
    args = kernel_args(width, height, ortho, origin, basis, jitter, scale,
                       outs)
    cuda_library.launch("mrt_camera_rays", args, dev, "camera.launch")
    count("camera.kernel_rays", n)
    return outs
