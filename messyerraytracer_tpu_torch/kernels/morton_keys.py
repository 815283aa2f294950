"""Ray sort keys in one launch of ``csrc/morton_keys.cu`` (kernel M1).

The JAX package computes its Morton sort keys in jnp
(``messyerraytracer_tpu/dispatch/morton.py``): this kernel replaces no
Pallas kernel.  ``dispatch/morton.py`` calls ``morton_keys_cuda`` for rays
on a card and its plain versions for the CPU; the kernel gives the plain
versions' keys bit for bit (the source's note says why), as int32.  The key
kind, the direction bits and N go to the C entry by value and the box
``lo``, ``hi`` by pointer, so a launch makes no host to device copy and
does not wait for the stream.
"""

from __future__ import annotations

import ctypes

import torch

from ..native import CudaLibrary, check_tables, cuda_device
from ..utils.trace import count

# the key kinds of the C entry
OCTANT_MAJOR, ORIGIN_MAJOR, DIRECTION = 0, 1, 2
MAX_DIR_BITS = 9        # the origin keeps 28 - 3 b > 0 bits of the key

_p, _i = ctypes.c_void_p, ctypes.c_int
cuda_library = CudaLibrary("morton_keys.cu", "libmrt_morton_keys.so", {
    "mrt_morton_keys": (
        [_i, _i, _i]        # n, kind, dir_bits
        + [_p] * 7)})       # origin, direction, lo, hi, live, keys, stream


def check_dir_bits(dir_bits: int) -> None:
    """Raise ``ValueError`` unless ``dir_bits`` is in 1..MAX_DIR_BITS."""
    if not 1 <= dir_bits <= MAX_DIR_BITS:
        raise ValueError(f"dir_bits must be in 1..{MAX_DIR_BITS}, "
                         f"got {dir_bits}")


def morton_keys_cuda(origin, direction, lo, hi, kind: int,
                     dir_bits: int = 1, live=None) -> torch.Tensor:
    """(N,) int32 sort keys of N rays in a new tensor on their card: one
    launch of M1 on the current stream, without synchronizing.  ``kind``
    is OCTANT_MAJOR (``dir_bits`` direction bits an axis above the origin
    Morton bits), ORIGIN_MAJOR (the direction octant minor) or DIRECTION
    (``origin``, ``lo`` and ``hi`` unused, may be None).  ``origin`` and
    ``direction`` are contiguous (N, 3) float32 tensors, ``lo`` and ``hi``
    the box's (3,) float32 rows on the same card; where ``live`` (bool
    (N,)) is false the key is DEAD_KEY.  Raises ``ValueError`` for any
    other input, ``RuntimeError`` if the launch is refused."""
    if kind not in (OCTANT_MAJOR, ORIGIN_MAJOR, DIRECTION):
        raise ValueError(f"unknown key kind {kind}")
    check_dir_bits(dir_bits)
    n, f32 = direction.shape[0], torch.float32
    if n >= 1 << 31:
        raise ValueError(f"{n} rays: the kernel takes fewer than 2^31")
    inputs = [("direction", direction, f32, (n, 3))]
    if kind != DIRECTION:
        inputs += [("origin", origin, f32, (n, 3)), ("lo", lo, f32, (3,)),
                   ("hi", hi, f32, (3,))]
    if live is not None:
        inputs.append(("live", live, torch.bool, (n,)))
    check_tables("morton_keys_cuda", inputs)
    dev = cuda_device(direction.device, "morton_keys_cuda")
    keys = torch.empty((n,), dtype=torch.int32, device=dev)
    ptrs = {name: t.data_ptr() for name, t, _, _ in inputs}
    cuda_library.launch("mrt_morton_keys", [
        n, kind, dir_bits, ptrs.get("origin"), ptrs["direction"],
        ptrs.get("lo"), ptrs.get("hi"), ptrs.get("live"), keys.data_ptr()],
        dev, "key.launch")
    count("key.kernel_rays", n)
    return keys
