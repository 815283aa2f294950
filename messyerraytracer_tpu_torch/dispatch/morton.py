"""Morton-code ray sorting for traversal coherence, and the pixel-block
swizzle for coherent primary rays.

PyTorch counterpart of the JAX package's dispatch/morton.py: the same bit
spread, quantization and keys, bit for bit.  The sort keys of rays on a
card (``sort_perm_6d``, ``sort_rays_6d``, ``sort_rays_by_direction``,
``ray_6d_morton``, ``ray_direction_morton``) are one launch of kernel M1
(``kernels/morton_keys.py``); elsewhere the plain versions (``_keys_6d``,
``_ray_6d_morton``, ``_ray_direction_morton``) compute them in int64 (the
wider type keeps the shifts of the two-pass key in the dispatcher from
overflowing).  Both give the same keys, as int32: every key fits in 31
bits.  The sort is ``torch.sort(..., stable=True)`` of the int32 keys, the
counterpart of the JAX package's stable ``jnp.argsort``; permutations are
int64 index tensors with ``sorted[i] = rays[perm[i]]``.

The key, sort, gather and unshuffle steps run inside ``torch.profiler``
ranges named ``morton.key``, ``morton.sort``, ``morton.gather`` and
``morton.unshuffle``, so a profile of any caller splits its device time by
step; M1's launch is the span ``key.launch`` inside ``morton.key``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import Hits, Rays
from ..kernels import morton_keys as m1
from ..utils.trace import span

DEAD_KEY = 0x7FFFFFFF   # sort key of a dead ray: above every live key


def morton_spread_10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to 30 by inserting 2 zero bits between each bit."""
    with span("key.spread"):
        v = v.to(torch.int64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v


def morton_encode_3d(x, y, z) -> torch.Tensor:
    """30-bit 3D Morton code (int64)."""
    x, y, z = morton_spread_10(x), morton_spread_10(y), morton_spread_10(z)
    with span("key.merge"):
        return (x << 2) | (y << 1) | z


def _quantize(n: torch.Tensor, scale: float) -> torch.Tensor:
    """Unit-box coordinates (clamped to [0, 1]) to integer cells."""
    return (n.clamp(0.0, 1.0) * scale).to(torch.int64)


def _unit_box(origin: torch.Tensor, lo, hi) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=torch.float32, device=origin.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=origin.device)
    return (origin - lo) / torch.clamp_min(hi - lo, 1e-12)


def _box(lo, hi, dev: torch.device) -> tuple:
    """``lo``, ``hi`` as float32 tensors on ``dev``; tensors that already
    are (the BVH root's device rows) pass unchanged, with no copy."""
    return tuple(torch.as_tensor(b, dtype=torch.float32, device=dev)
                 for b in (lo, hi))


def ray_direction_morton(direction: torch.Tensor) -> torch.Tensor:
    """(N,) int32 Morton keys from direction vectors, [-1,1]^3 ->
    [0,1023]^3: on a card one launch of kernel M1, elsewhere the plain
    version."""
    if direction.is_cuda:
        return m1.morton_keys_cuda(None, direction, None, None, m1.DIRECTION)
    return _ray_direction_morton(direction)


def _ray_direction_morton(direction: torch.Tensor) -> torch.Tensor:
    """The plain version of ``ray_direction_morton``."""
    q = _quantize((direction + 1.0) * 0.5, 1023.0)
    return morton_encode_3d(q[:, 0], q[:, 1], q[:, 2]).to(torch.int32)


def ray_position_morton(origin: torch.Tensor, lo, hi) -> torch.Tensor:
    """(N,) int32 origin Morton keys over a scene AABB (lo, hi)."""
    q = _quantize(_unit_box(origin, lo, hi), 1023.0)
    return morton_encode_3d(q[:, 0], q[:, 1], q[:, 2]).to(torch.int32)


def _octant(direction: torch.Tensor) -> torch.Tensor:
    """3-bit direction octant (x sign high), int64."""
    neg = (direction < 0).to(torch.int64)
    return (neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2]


def ray_6d_morton(origin: torch.Tensor, direction: torch.Tensor,
                  lo, hi) -> torch.Tensor:
    """Origin-major 6D coherence key (int32): 27-bit origin Morton (9
    bits/axis over the scene AABB) with the 3-bit direction octant as the
    minor bits.  On a card one launch of kernel M1, elsewhere the plain
    version."""
    if direction.is_cuda:
        return m1.morton_keys_cuda(origin, direction,
                                   *_box(lo, hi, direction.device),
                                   m1.ORIGIN_MAJOR)
    return _ray_6d_morton(origin, direction, lo, hi)


def _ray_6d_morton(origin: torch.Tensor, direction: torch.Tensor,
                   lo, hi) -> torch.Tensor:
    """The plain version of ``ray_6d_morton``."""
    q = _quantize(_unit_box(origin, lo, hi), 511.0)
    okey = morton_encode_3d(q[:, 0], q[:, 1], q[:, 2])
    return ((okey << 3) | _octant(direction)).to(torch.int32)


def _stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    """The stable sort permutation of the int32 ``keys``."""
    with span("morton.sort"):
        return torch.sort(keys, stable=True).indices


def sort_rays_by_direction(rays: Rays) -> tuple[Rays, torch.Tensor]:
    """Stable-sort rays by direction Morton key.  Returns (sorted_rays,
    perm) with ``sorted[i] = rays[perm[i]]``."""
    with span("morton.key"):
        keys = ray_direction_morton(rays.direction)
    perm = _stable_argsort(keys)
    return apply_permutation(rays, perm), perm


def sort_rays_6d(rays: Rays, lo, hi, octant_major: bool = True,
                 dir_bits: int = 1) -> tuple[Rays, torch.Tensor]:
    """Stable-sort rays by the 6D key (incoherent batches): octant-major
    (``dir_bits`` direction Morton bits per axis above the origin Morton
    bits, 1..9; another raises ``ValueError``) by default, origin-major
    with the octant minor otherwise; the keys are int32, on a card one
    launch of kernel M1.  Returns (sorted_rays, perm) with ``sorted[i] =
    rays[perm[i]]``."""
    perm = sort_perm_6d(rays, lo, hi, octant_major=octant_major,
                        dir_bits=dir_bits)
    return apply_permutation(rays, perm), perm


def sort_perm_6d(rays: Rays, lo, hi, octant_major: bool = True,
                 dir_bits: int = 1, live=None) -> torch.Tensor:
    """The 6D coherence-sort permutation alone (no gathers applied), for
    callers that permute a larger carried state themselves.

    ``live`` (bool (N,), optional): dead rays get ``DEAD_KEY``, above every
    live key (< 2^28), so the stable sort puts them at the end in their
    input order.  ``dir_bits`` is 1..9; another raises ``ValueError``."""
    with span("morton.key"):
        keys = sort_keys_6d(rays, lo, hi, octant_major, dir_bits, live)
    return _stable_argsort(keys)


def sort_keys_6d(rays: Rays, lo, hi, octant_major: bool = True,
                 dir_bits: int = 1, live=None) -> torch.Tensor:
    """The (N,) int32 sort keys of ``sort_perm_6d``: on a card one launch
    of kernel M1, which reads ``lo`` and ``hi`` on the card (pass the box's
    device rows, or they are copied there first); elsewhere the plain
    version ``_keys_6d``."""
    if rays.direction.is_cuda:
        return m1.morton_keys_cuda(
            rays.origin, rays.direction,
            *_box(lo, hi, rays.direction.device),
            m1.OCTANT_MAJOR if octant_major else m1.ORIGIN_MAJOR,
            dir_bits, live)
    keys = _keys_6d(rays, lo, hi, octant_major, dir_bits)
    if live is not None:
        with span("key.merge"):
            keys = torch.where(live, keys, torch.full_like(keys, DEAD_KEY))
    return keys.to(torch.int32)


def _keys_6d(rays: Rays, lo, hi, octant_major: bool = True,
             dir_bits: int = 1) -> torch.Tensor:
    """The int64 sort keys of ``sort_perm_6d`` (live rays only), the plain
    version; ``dir_bits`` outside 1..9 raises ``ValueError``."""
    m1.check_dir_bits(dir_bits)
    if octant_major:
        b = dir_bits
        qmax = (1 << b) - 1
        with span("key.quantize"):
            nd = ((rays.direction + 1.0) * 0.5).clamp(0.0, 1.0)
            qd = torch.clamp_max((nd * float(qmax + 1)).to(torch.int64),
                                 qmax).unbind(1)
        dirm = morton_encode_3d(*qd)
        with span("key.quantize"):
            qo = _quantize(_unit_box(rays.origin, lo, hi), 511.0).unbind(1)
        okey = morton_encode_3d(*qo)  # 27 bits
        minor = 28 - 3 * b
        with span("key.merge"):
            keys = (dirm << minor) | (okey >> (27 - minor))
    else:
        keys = _ray_6d_morton(rays.origin, rays.direction, lo,
                              hi).to(torch.int64)
    return keys


def apply_permutation(rays: Rays, perm: torch.Tensor) -> Rays:
    """``rays[perm]`` as a new batch."""
    with span("morton.gather"):
        return rays.take(perm)


def _unpermute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The inverse of ``x = y[perm]``: ``out[perm[i]] = x[i]``."""
    out = torch.empty_like(x)
    out[perm] = x
    return out


def unshuffle_hits(hits: Hits, perm: torch.Tensor) -> Hits:
    """Invert the sort permutation on a Hits batch."""
    with span("morton.unshuffle"):
        return Hits(*(_unpermute(getattr(hits, f), perm) for f in (
            "t", "position", "normal", "u", "v", "prim_id", "hit_layers")))


def unshuffle_flags(flags: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Invert the permutation on a bool array."""
    with span("morton.unshuffle"):
        return _unpermute(flags, perm)


def raster_block_permutation(width: int, height: int, block: int = 32,
                             patch: tuple[int, int] | None = (16, 8)
                             ) -> np.ndarray:
    """Static permutation: raster order -> block-major order.

    ``perm[i]`` = raster index of the ray that should sit at position i, so
    consecutive ``block*block`` rays form one square screen block (pad
    blocks at the right/bottom edges are smaller).  ``patch=(pw, ph)``
    additionally orders pixels within each block by pw x ph sub-patches
    (patch-major, raster within the patch), so neighbouring rays — one
    warp of the cast kernel — cover a compact screen patch.
    """
    ys, xs = np.mgrid[0:height, 0:width]
    by, bx = ys // block, xs // block
    yb, xb = ys % block, xs % block
    bkey = by * ((width + block - 1) // block) + bx
    if patch is None:
        inkey = yb * block + xb
    else:
        pw, ph = min(patch[0], block), min(patch[1], block)
        pidx = (yb // ph) * (block // pw) + (xb // pw)
        inkey = (pidx * ph + yb % ph) * pw + xb % pw
    key = bkey * (block * block) + inkey
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)
