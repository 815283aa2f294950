"""Pixel-block swizzle for coherent primary rays (numpy; the JAX package's
dispatch/morton.py::raster_block_permutation).  The Morton ray sorts wait
for the dispatch slice (ROADMAP A.6)."""

from __future__ import annotations

import numpy as np


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
