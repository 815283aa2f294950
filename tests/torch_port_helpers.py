"""Shared inputs and checks for the tests of the PyTorch port
(tests/test_torch_*.py).  Inputs are made with numpy from a seed and handed
to both packages as numpy arrays."""

import numpy as np
import torch

# The suite runs in several worker processes on shared cores: one torch
# thread per worker keeps them from oversubscribing the CPU (measured on
# 8 cores, 6 workers: the port's files took 75 s at torch's default
# thread count).
torch.set_num_threads(1)

TIE_RTOL = 4e-6   # bench.py::parity: shared-edge ties agree to ~8 ulps

JAX_NATIVE_SO = "libmrt_native_jax.so"   # in the port's build directory


def load_native_libraries():
    """Load both packages' native SAH builders, or raise.

    The JAX package compiles its library straight into its final path and
    trusts any file there, and its tests load it while test workers are
    collected (tests/test_native_tables.py, in a ``skipif``), so workers
    that build at once can load a half-written file; such a worker keeps
    the numpy builder, whose trees differ, for the rest of its run.  So
    before any port test runs, a worker whose JAX library is not loaded
    compiles the JAX package's source atomically (a temporary file, then a
    rename) into the port's build directory under its own name, points the
    JAX package at that file and lets it load again.  This sets module
    attributes and edits no file.  A test never compares against a tree
    built by the numpy fallback: if either library does not load, this
    raises."""
    from messyerraytracer_tpu import native as jnative
    from messyerraytracer_tpu_torch import native as pnative

    with jnative._LOCK:
        if jnative._LIB is None:
            jnative._SO = pnative.build_shared_library(
                pnative.SAH_CFLAGS, [jnative._SRC], JAX_NATIVE_SO)
            jnative._TRIED = False
    for name, mod in (("JAX package's", jnative), ("port's", pnative)):
        if mod.get_native_lib() is None:
            raise RuntimeError(
                f"the {name} native SAH builder did not load: the port's "
                f"tests compare trees only with both native builders")
    return jnative.get_native_lib(), pnative.get_native_lib()


load_native_libraries()


def small_tris():
    """The JAX suite's interpret-mode scene (test_cluster_v2.py:25-35):
    a multi-cluster, multi-level BVH that interpret mode casts quickly."""
    from messyerraytracer_tpu_torch.utils import meshes

    g = meshes.plane(8.0, y=0.0, subdiv=9)
    g[:, :, 1] = np.sin(g[:, :, 0]) * 0.6
    sph = meshes.uv_sphere(1.2, 6, 12, center=(0, 1.5, 0))
    return np.concatenate([g, sph])


def terrain_tris(subdiv=100, extent=20.0):
    """A displaced terrain grid (2 * subdiv^2 triangles)."""
    from messyerraytracer_tpu_torch.utils import meshes

    g = meshes.plane(extent, y=0.0, subdiv=subdiv)
    g[:, :, 1] = np.sin(g[:, :, 0] * 0.9) * np.cos(g[:, :, 2] * 0.8)
    return g


def rand_rays_np(n, seed=0, extent=5.0):
    """(origin, direction) float32 numpy: the JAX suite's rand_rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 4.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def jax_rays(o, d, t_min=None, t_max=None):
    from messyerraytracer_tpu.core.types import make_rays

    return make_rays(o, d, t_min, t_max)


def port_rays(o, d, t_min=None, t_max=None):
    from messyerraytracer_tpu_torch.core.types import make_rays

    return make_rays(o, d, t_min, t_max, device="cpu")


def jax_cluster_scene(tris, tcap, layers=None):
    """JAX base scene + its numpy-arranged ClusterScene."""
    from messyerraytracer_tpu.kernels.cluster import build_cluster_scene
    from messyerraytracer_tpu.scene.scene import build_scene_from_tri_array

    base = build_scene_from_tri_array(tris, layers=layers, backend="brute")
    host = tuple(np.asarray(a) for a in (
        base.tris.v0, base.tris.edge1, base.tris.edge2, base.tris.normal,
        base.tris.prim_id, base.tris.layers))
    return base, build_cluster_scene(base.bvh, base.tris, _np=host,
                                     tcap=tcap, host_arrange=True)


def jax_fields(struct) -> dict:
    """A JAX struct's fields, arrays as numpy: the keyword arguments of the
    port's ``*_from_jax`` converters."""
    import dataclasses

    return {f.name: (np_of(getattr(struct, f.name))
                     if hasattr(getattr(struct, f.name), "shape")
                     else getattr(struct, f.name))
            for f in dataclasses.fields(struct)}


def np_of(x):
    """A tensor or a JAX array as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# The anchored Plucker t is tau + t_local, tau being the ray's distance to
# the cluster anchor: its ABSOLUTE error is a few ulps of tau, so a hit at
# t << tau (a ray starting next to a surface) can miss rtol 1e-5 against
# the classic Moller-Trumbore of the brute oracle.  The JAX kernel shares
# this (ROADMAP queue C); tests against brute over rays that start inside
# the scene add this absolute allowance (~16 ulps at a distance of 1).
ANCHOR_ATOL = 2e-6


def assert_parity(h_port, h_ref, rtol=1e-5, atol=0.0):
    """The bench.py::parity rule: t within rtol on every ray; prim equal,
    except on ties where t agrees within TIE_RTOL."""
    pp, pr = np_of(h_port.prim_id), np_of(h_ref.prim_id)
    tp, tr = np_of(h_port.t), np_of(h_ref.t)
    np.testing.assert_allclose(tp, tr, rtol=rtol, atol=atol)
    tie = np.abs(tp - tr) <= TIE_RTOL * np.maximum(np.abs(tr), 1.0)
    bad = (pp != pr) & ~tie
    assert not bad.any(), f"prim mismatch off ties at {np.nonzero(bad)[0]}"
    return pp == pr


def assert_same_hits(h_port, h_ref, rtol=1e-5, atol=1e-5, t_atol=0.0):
    """Parity plus, where the prims agree, u/v/normal/layers."""
    same = assert_parity(h_port, h_ref, rtol, t_atol)
    np.testing.assert_array_equal(np_of(h_port.hit), np_of(h_ref.hit))
    for f in ("u", "v", "normal"):
        np.testing.assert_allclose(np_of(getattr(h_port, f))[same],
                                   np_of(getattr(h_ref, f))[same], atol=atol)
    np.testing.assert_array_equal(np_of(h_port.hit_layers)[same],
                                  np_of(h_ref.hit_layers)[same])
