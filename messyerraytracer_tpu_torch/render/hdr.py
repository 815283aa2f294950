"""Radiance .hdr (RGBE) environment-map loading + panorama cache.

PyTorch counterpart of the JAX package's render/hdr.py.  The RGBE format
is read and written in pure numpy (both flat and new-style RLE scanlines);
``load_panorama`` caches the decoded float32 tensor on its device, keyed on
(path, mtime, device), so repeated renders never re-decode or re-upload.

Output feeds ``render.shade.sample_panorama`` / ``EnvironmentData``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.types import DEFAULT_DEVICE

_CACHE: dict[tuple[str, float, str], torch.Tensor] = {}


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32 linear radiance."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0.0, np.exp2(e - 136.0), 0.0)  # 2^(e-128) / 256
    return rgbe[..., :3] * scale[..., None]


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file into an (H, W, 3) float32 array."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # header: lines until the blank line, then the resolution line
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res!r}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8, offset=eol + 1)

    out = np.empty((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if (w < 8 or w > 0x7FFF or p + 4 > len(buf)
                or buf[p] != 2 or buf[p + 1] != 2
                or (int(buf[p + 2]) << 8 | int(buf[p + 3])) != w):
            # flat (old-style) scanline: w consecutive RGBE quads
            out[y] = buf[p:p + 4 * w].reshape(w, 4)
            p += 4 * w
            continue
        p += 4
        for ch in range(4):  # new-style RLE, per channel
            x = 0
            while x < w:
                n = int(buf[p])
                p += 1
                if n > 128:  # run of the same byte
                    out[y, x:x + n - 128, ch] = buf[p]
                    p += 1
                    x += n - 128
                else:        # literal span
                    out[y, x:x + n, ch] = buf[p:p + n]
                    p += n
                    x += n
    return _decode_rgbe(out)


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) float32 array as a flat-scanline .hdr file
    (round-trip partner of ``read_hdr``; used by tests and demo export)."""
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    m = img.max(axis=-1)
    e = np.where(m > 1e-32, np.ceil(np.log2(np.maximum(m, 1e-32))) + 1, 0.0)
    scale = np.where(m > 1e-32, np.exp2(8.0 - e), 0.0)
    rgbe = np.empty((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 1e-32, e + 128.0, 0.0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_panorama(path: str, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Load an equirect .hdr panorama as an (H, W, 3) float32 tensor on
    ``device``, decoded once per (file version, device)."""
    apath = os.path.abspath(path)
    key = (apath, os.path.getmtime(path), str(torch.device(device)))
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    # drop stale entries for the same path (the file was rewritten)
    for k in [k for k in _CACHE if k[0] == apath and k[1] != key[1]]:
        del _CACHE[k]
    arr = torch.tensor(read_hdr(path), device=device)
    _CACHE[key] = arr
    return arr
