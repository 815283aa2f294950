"""Native libraries of the port: build at first use, bind through ctypes.

Two kinds of shared library are built into ``BUILD_DIR`` (git-ignored):

  * the host-side binned-SAH BVH builder, ``sah_builder.cpp`` beside this
    file (a verbatim copy of the JAX package's, so both packages build the
    same trees while the port depends on no file of that package),
    compiled with g++.  Hosts without g++ keep the numpy builder
    (accel/bvh.py) — host build code, not a device path;
  * the CUDA kernels under ``kernels/csrc/``, compiled with nvcc for
    ``sm_90a`` into a library with a plain C interface, one a kernel,
    each built at first use and bound by a ``CudaLibrary``, whose
    ``launch`` is the one launch seam of the port's kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np
import torch

from ..utils.trace import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
SAH_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "sah_builder.cpp")
KERNEL_SRC = os.path.join(_PKG, "kernels", "csrc")

# g++ flags of the SAH builder library (the JAX package builds its copy of
# the source with the same flags)
SAH_CFLAGS = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]

# nvcc flags of the CUDA kernel libraries: Hopper only, and no fused
# multiply-add, so each kernel's float32 steps round as its plain version's
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _read(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def _write_atomic(path: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def build_shared_library(cmd: list[str], sources: list[str],
                         name: str) -> str:
    """Compile ``sources`` with ``cmd + [-o out] + sources`` into
    ``BUILD_DIR/name`` unless an up-to-date build is there: one newer than
    every source and built by the same command, which ``name + ".cmd"``
    beside it records (a change of flags rebuilds).

    The output is written under a temporary name and renamed into place,
    so concurrent builders (test workers) never load a half-written file.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    stamp = out + ".cmd"
    key = "\n".join(cmd + ["-o", "<out>"] + sources) + "\n"
    newest = max(os.path.getmtime(s) for s in sources)
    if (os.path.exists(out) and os.path.getmtime(out) >= newest
            and _read(stamp) == key):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(cmd + ["-o", tmp] + sources,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({' '.join(cmd)}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        _write_atomic(stamp, key)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin`` (default /usr/local/cuda), else
    PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaLibrary:
    """The library of one CUDA kernel, ``kernels/csrc/<source>``: built
    with ``nvcc() + NVCC_FLAGS`` into ``BUILD_DIR/<name>`` at first use,
    loaded through ctypes once, its C ``entries`` ({function: argtypes})
    declared to return an int, the launch's CUDA error code.  Calling it
    returns the loaded library; ``lib`` is None until then.  ``launches``
    counts the launches ``launch`` made."""

    def __init__(self, source: str, name: str, entries: dict):
        self.source = os.path.join(KERNEL_SRC, source)
        self.name, self.entries = name, entries
        self.lib = None
        self.launches = 0
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            if self.lib is None:
                self.lib = self.load(build_shared_library(
                    [nvcc()] + NVCC_FLAGS, [self.source], self.name))
            return self.lib

    def load(self, path: str):
        """Load a library built at ``path`` (this one, or a patched copy
        of its source) and declare its entries."""
        lib = ctypes.CDLL(path)
        for fn, argtypes in self.entries.items():
            f = getattr(lib, fn)
            f.restype = ctypes.c_int
            f.argtypes = argtypes
        return lib

    def launch(self, entry: str, args: list, device, span_name: str):
        """Call the C entry ``entry`` on ``args`` and the current stream of
        the CUDA ``device``, made the current device, directly inside the
        profiler span ``span_name`` (which a trace links the kernel to);
        count the launch, or raise ``RuntimeError`` if it is refused."""
        fn = getattr(self(), entry)
        with torch.cuda.device(device), span(span_name):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
        with self._lock:
            self.launches += 1


def cuda_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; raises ``ValueError`` unless it
    is a CUDA one (a kernel's launcher has no fallback)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{who} needs CUDA tensors, got {dev}")
    return dev


def check(t, name: str, dtype, shape, device=None,
          aligned: bool = False) -> None:
    """Raise ``ValueError`` naming ``name`` unless ``t`` is a contiguous
    tensor of ``dtype`` and ``shape``, on ``device`` if given, and, if
    ``aligned`` and on a card, 16-byte aligned (for 16-byte loads)."""
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if aligned and t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def check_tables(owner: str, tables, aligned=()) -> None:
    """``check`` each (name, tensor, dtype, shape) of ``tables``, those
    named in ``aligned`` for 16-byte alignment, and that all share one
    device; errors name the table ``owner.name``."""
    first, dev = tables[0][0], tables[0][1].device
    for name, t, dtype, shape in tables:
        check(t, f"{owner}.{name}", dtype, shape, aligned=name in aligned)
        if t.device != dev:
            raise ValueError(f"{owner}.{name} is on {t.device}, "
                             f"{owner}.{first} on {dev}")


def check_rays(origin, direction, t_min, t_max, device) -> int:
    """``check`` a cast's rays, (N, 3) origins and directions and (N,)
    t ranges in float32, on ``device`` (the tables'); returns N."""
    n = origin.shape[0]
    for name, t, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("t_min", t_min, (n,)), ("t_max", t_max, (n,))):
        check(t, name, torch.float32, shape, device)
    return n


_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_INT = ctypes.c_int32

# argtypes as in the JAX package's native/__init__.py
_SIGNATURES = {
    "mrt_build_bvh": [_INT, _F32, _F32, _F32, _F32, _F32,
                      _I32, _I32, _I32, _I32, _I32],
    "mrt_build_bvh_aabbs": [_INT, _INT, _F32, _F32, _F32, _F32, _F32,
                            _I32, _I32, _I32, _I32, _I32],
    "mrt_build_wide8_tables": [_INT, _F32, _F32, _I32, _I32, _INT,
                               _I32, _F32, _I32, _F32, _I32, _I32],
}


def get_native_lib():
    """Load (compiling if needed) the SAH builder library, or None when
    this host cannot compile it (no g++, or the source is absent)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            path = build_shared_library(SAH_CFLAGS, [SAH_SRC],
                                        "libmrt_native.so")
        except (OSError, RuntimeError):
            return None      # no compiler here: numpy builder fallback
        lib = ctypes.CDLL(path)
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.restype = ctypes.c_int32
            f.argtypes = argtypes
        _LIB = lib
        return _LIB


def _bvh_outputs(n: int):
    m = max(2 * n - 1, 1)
    return (np.empty((m, 3), np.float32), np.empty((m, 3), np.float32),
            np.zeros(m, np.int32), np.zeros(m, np.int32),
            np.zeros(m, np.int32), np.zeros(m, np.int32),
            np.zeros(n, np.int32))


def native_build_bvh_aabbs(tri_min, tri_max, centroid, max_leaf: int):
    """C++ binned-SAH build over primitive AABBs/centroids with a chosen
    leaf threshold.  Returns (node_min, node_max, left_first, count,
    depth, axis, order, num_nodes) or None if native is unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None
    n = int(tri_min.shape[0])
    outs = _bvh_outputs(n)
    num = lib.mrt_build_bvh_aabbs(
        n, int(max_leaf), np.ascontiguousarray(tri_min, np.float32),
        np.ascontiguousarray(tri_max, np.float32),
        np.ascontiguousarray(centroid, np.float32), *outs)
    if num <= 0:
        return None
    return tuple(a[:num] for a in outs[:6]) + (outs[6], int(num))


def native_build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """C++ binned-SAH build over triangles.  Returns (node_min, node_max,
    left_first, count, depth, axis, tri_order, num_nodes) or None if the
    native library is unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None
    n = int(v0.shape[0])
    outs = _bvh_outputs(n)
    num = lib.mrt_build_bvh(
        n, *(np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2)),
        *outs)
    if num <= 0:
        return None
    return tuple(a[:num] for a in outs[:6]) + (outs[6], int(num))


def _pad8_rows(entries: int) -> int:
    rows = -(-entries // 2)               # 2 entries per 128-lane row
    return max(-(-rows // 8) * 8, 8)      # a multiple of 8 rows


def native_build_wide8_tables(amin, amax, lf, cnt, t: int):
    """C++ 8-wide collapse of a binary BVH's host arrays into the JAX
    package's lane-packed gather tables (its kernels/wide.py layout: the
    same FIFO order, tie-breaks and packing).  The port's own wide tables
    (kernels/wide.py) do not read this layout.  Returns (node_idx,
    node_const, leaf_idx, leaf_const, leaf_first, leaf_count, nw,
    num_leaf) or None if the native library is unavailable."""
    lib = get_native_lib()
    if lib is None:
        return None
    m = int(amin.shape[0])
    cnt = np.ascontiguousarray(cnt, np.int32)
    num_internal = int((cnt == 0).sum())
    num_leaf = int((cnt > 0).sum())
    nw_cap = max(num_internal, 1) + 1      # bound on the wide node count
    node_idx = np.empty((_pad8_rows(nw_cap + 1), 128), np.int32)
    node_const = np.empty(9 * nw_cap + 16, np.float32)
    leaf_idx = np.empty((_pad8_rows(num_leaf + 1), 128), np.int32)
    leaf_const = np.empty(num_leaf + 1, np.float32)
    leaf_first = np.empty(num_leaf, np.int32)
    leaf_count = np.empty(num_leaf, np.int32)
    nw = lib.mrt_build_wide8_tables(
        m, np.ascontiguousarray(amin, np.float32),
        np.ascontiguousarray(amax, np.float32),
        np.ascontiguousarray(lf, np.int32), cnt, int(t),
        node_idx, node_const, leaf_idx, leaf_const, leaf_first, leaf_count)
    if nw <= 0:
        return None
    num_wide = nw + 1
    return (node_idx[:_pad8_rows(num_wide)], node_const[:9 * num_wide + 2],
            leaf_idx, leaf_const, leaf_first, leaf_count, int(nw), num_leaf)
