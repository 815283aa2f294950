"""messyerraytracer_tpu_torch — the ray tracer on PyTorch and CUDA.

The PyTorch counterpart of ``messyerraytracer_tpu``: same module paths,
same public names and the same hit semantics (t, position, normal, u/v,
prim_id, layer masks), with the traversal kernels written by hand in
CUDA for Hopper (``kernels/csrc/cluster_cast.cu`` for the cluster tables,
``kernels/csrc/wide_cast.cu`` for the wide-node tables) and a plain
PyTorch version of every kernel beside it for CPU tensors.  Builders and
ray generators put their tensors on the card unless given ``device=``.

This package imports torch and numpy only; it never imports jax or the
JAX package.
"""

__version__ = "0.1.0"


_malloc_tuned = False


def _tune_malloc():
    """Keep 100MB-class build buffers on the heap instead of mmap.

    glibc mmap()s allocations above ~32MB and returns them to the OS on
    free, so every scene (re)build pays first-touch page faults on its
    large numpy staging buffers.  Raising M_MMAP_THRESHOLD (mallopt param
    -3) makes the heap reuse those pages.

    Called lazily from the scene-build entry points (NOT at import): it
    mutates the process-global allocator, which only pays off for
    builds, and applications that merely import the package should not
    inherit a higher steady-state RSS.
    """
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD = 1 GB
    except (OSError, AttributeError):
        pass  # non-glibc platforms: harmless to skip


from .core.types import (  # noqa: E402,F401
    ALL_LAYERS,
    NO_HIT,
    Hits,
    Rays,
    RayStats,
    Triangles,
    make_rays,
    make_triangles,
)
from .render.camera import (  # noqa: E402,F401
    CameraParams,
    debug_grid_rays,
    generate_rays,
)
