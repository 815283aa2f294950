"""PyTorch port: scene checkpoints (scene/serialize.py) against the JAX
package's .npz format v2.

A file the JAX package saved loads in the port with its triangles, BVH and
levels as saved and the cast tables rebuilt by the port's builders (equal
to the port's own build of the same triangles), and casts like the JAX
scene by the bench.py parity rule (B1 with ``ANCHOR_ATOL``).  The port's
own round trip is bit-equal, refit scenes included.  A file the port saved
loads in the JAX package with the same arrays."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu.scene import serialize as jser  # noqa: E402
from messyerraytracer_tpu.scene.scene import (  # noqa: E402
    build_scene_from_tri_array as jax_build,
)

from messyerraytracer_tpu_torch.core.brute import cast_rays_brute  # noqa
from messyerraytracer_tpu_torch.scene import serialize as pser  # noqa: E402
from messyerraytracer_tpu_torch.scene.scene import (  # noqa: E402
    build_scene_from_tri_array,
)
from torch_port_helpers import (  # noqa: E402
    ANCHOR_ATOL,
    assert_parity,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
    small_tris,
)

TRI = ("v0", "edge1", "edge2", "normal", "prim_id", "layers")
BVH = ("aabb_min", "aabb_max", "left_first", "count", "tri_order",
       "split_axis")
CLUSTER = ("node_box", "node_child", "node_axis", "tri", "tri_prim",
           "tri_layers", "cl_anchor", "cl_count", "cl_aabb", "child_node",
           "croots", "slot_map", "cvalid")
WIDE = ("node_box", "node_child", "node_axis", "leaf_tri", "leaf_count",
        "slot_prim_id", "slot_layers", "slot_normal", "slot_tri",
        "child_node")
LAYOUTS = {"cluster": ("cluster", 8), "pallas8": ("pallas", 8),
           "pallas2": ("pallas", 2)}


def bits(x):
    a = np.ascontiguousarray(np_of(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_scene(a, b):
    """Every array of two port scenes equal bit for bit: the triangles,
    the BVH with its levels, and the cluster and wide tables."""
    for obj, names in ((lambda s: s.tris, TRI), (lambda s: s.bvh, BVH)):
        for f in names:
            np.testing.assert_array_equal(bits(getattr(obj(a), f)),
                                          bits(getattr(obj(b), f)), f)
    assert len(a.bvh.levels) == len(b.bvh.levels)
    for x, y in zip(a.bvh.levels, b.bvh.levels):
        np.testing.assert_array_equal(np_of(x), np_of(y))
    assert a.backend == b.backend and a.use_bvh == b.use_bvh
    for part, names in (("cluster", CLUSTER), ("wide", WIDE)):
        pa, pb = getattr(a, part), getattr(b, part)
        assert (pa is None) == (pb is None), part
        if pa is None:
            continue
        for f in names:
            np.testing.assert_array_equal(bits(getattr(pa, f)),
                                          bits(getattr(pb, f)), f)


def moved(tris):
    m = tris.copy()
    m[:, :, 1] += 0.25 * np.sin(2.0 * m[:, :, 0])
    return m


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_jax_file_loads_and_casts_like_jax(tmp_path, layout):
    backend, branching = LAYOUTS[layout]
    tris = small_tris()
    js = jax_build(tris, backend=backend, branching=branching)
    path = tmp_path / "jax_scene.npz"
    jser.save_scene(str(path), js)
    ps = pser.load_scene(str(path), device="cpu")
    own = build_scene_from_tri_array(tris, backend=backend,
                                     branching=branching, device="cpu")
    assert_same_scene(ps, own)
    for f in TRI[:3] + TRI[4:]:
        np.testing.assert_array_equal(bits(getattr(ps.tris, f)),
                                      bits(getattr(js.tris, f)), f)
    for f in BVH:
        np.testing.assert_array_equal(bits(getattr(ps.bvh, f)),
                                      bits(getattr(js.bvh, f)), f)
    if backend == "pallas":
        assert ps.wide.branching == branching
        assert (ps.wide.stream_leaves, ps.wide.stream_nodes) == (
            js.wide.stream_leaves, js.wide.stream_nodes)
    o, d = rand_rays_np(768, seed=11)
    rays = port_rays(o, d)
    atol = ANCHOR_ATOL if backend == "cluster" else 0.0
    hp, sp = ps.cast_rays(rays)
    assert int(sp.stack_drops) == 0
    hj, _ = dataclasses.replace(js, backend="jnp").cast_rays(jax_rays(o, d))
    assert_parity(hp, hj, atol=atol)
    assert_parity(hp, cast_rays_brute(rays, ps.tris)[0], atol=atol)


@pytest.mark.parametrize("layout", sorted(LAYOUTS) + ["brute"])
def test_round_trip_bit_equal(tmp_path, layout):
    """save_scene then load_scene: every array (the tables rebuilt with the
    stored 8-wide grouping) and the frame equal bit for bit, for a scene
    fresh from its build and after a refit (no host copy), whose refit
    boxes a new collapse would group differently here."""
    backend, branching = LAYOUTS.get(layout, ("brute", 8))
    tris = small_tris()
    built = build_scene_from_tri_array(tris, backend=backend,
                                       branching=branching, device="cpu")
    m = moved(tris)
    o, d = rand_rays_np(512, seed=12)
    rays = port_rays(o, d)
    for k, scene in enumerate((built, built.refit(m[:, 0], m[:, 1],
                                                  m[:, 2]))):
        path = tmp_path / f"scene{k}.npz"
        pser.save_scene(path, scene)
        back = pser.load_scene(path, device="cpu")
        assert_same_scene(back, scene)
        assert back.bvh.host is not None
        ha, _ = scene.cast_rays(rays)
        hb, _ = back.cast_rays(rays)
        for f in ("t", "prim_id", "u", "v", "normal", "hit_layers"):
            assert torch.equal(getattr(ha, f), getattr(hb, f)), f
        if backend == "pallas":
            assert back.wide.branching == branching


@pytest.mark.parametrize("backend", ["cluster", "pallas"])
def test_port_file_loads_in_jax(tmp_path, backend):
    """What the JAX package makes of a file the port saved (after a refit):
    the same triangles, BVH, levels and backend; its cluster tables
    rebuilt, no wide tables (the port writes none), so a ``pallas`` scene
    casts on JAX's ``jnp`` traversal; casts agree with the port's by
    parity."""
    tris = small_tris()
    m = moved(tris)
    scene = build_scene_from_tri_array(tris, backend=backend,
                                       device="cpu").refit(
        m[:, 0], m[:, 1], m[:, 2])
    path = tmp_path / "port_scene.npz"
    pser.save_scene(path, scene)
    js = jser.load_scene(str(path))
    assert js.backend == backend and js.wide is None
    assert (js.cluster is not None) == (backend == "cluster")
    for f in TRI:
        np.testing.assert_array_equal(bits(getattr(js.tris, f)),
                                      bits(getattr(scene.tris, f)), f)
    for f in BVH:
        np.testing.assert_array_equal(bits(getattr(js.bvh, f)),
                                      bits(getattr(scene.bvh, f)), f)
    for x, y in zip(js.bvh.levels, scene.bvh.levels, strict=True):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    o, d = rand_rays_np(512, seed=13)
    hp, _ = scene.cast_rays(port_rays(o, d))
    jscene = js if backend == "pallas" else dataclasses.replace(
        js, backend="jnp")
    hj, _ = jscene.cast_rays(jax_rays(o, d))
    assert_parity(hp, hj,
                  atol=ANCHOR_ATOL if backend == "cluster" else 0.0)


def test_load_rejects_unknown_format(tmp_path):
    scene = build_scene_from_tri_array(small_tris(), backend="brute",
                                       device="cpu")
    path = tmp_path / "s.npz"
    pser.save_scene(path, scene)
    with np.load(path) as z:
        arrs = dict(z)
    arrs["format_version"] = np.int32(3)
    np.savez(tmp_path / "v3.npz", **arrs)
    with pytest.raises(ValueError, match="format 3"):
        pser.load_scene(tmp_path / "v3.npz", device="cpu")
