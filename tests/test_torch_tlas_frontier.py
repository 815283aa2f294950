"""PyTorch port: the two-level casts — the frontier TLAS and BLAS forest
(accel/tlas_frontier.py, ``SceneTLAS.cast_rays_two_level_fast``) and the
instance loop (``SceneTLAS.cast_rays_two_level``) — against the JAX
package's, on rotated, scaled and layer-masked instances.

The tables are held equal array for array, the fast cast runs on
identical tables (``frontier_tlas_from_jax``) and is held by the bench.py
parity rule with instance ids, occluded flags, layers and summed counters
exact; both casts are also held against the port's brute oracle over the
flattened world triangles.  Both packages' meshes use the ``jnp`` backend
(its traversal under jit is quick on the CPU) where the JAX loop runs;
the port's loop also runs on B1's plain version (``cluster``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu.accel import tlas_frontier as jtf  # noqa: E402
from messyerraytracer_tpu.accel.tlas import (  # noqa: E402
    SceneTLAS as JaxSceneTLAS,
)

from messyerraytracer_tpu_torch.accel import tlas_frontier as ptf  # noqa
from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS  # noqa: E402
from messyerraytracer_tpu_torch.core.brute import (  # noqa: E402
    any_hit_brute,
    cast_rays_brute,
)
from messyerraytracer_tpu_torch.core.types import (  # noqa: E402
    make_triangles,
)
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    ANCHOR_ATOL,
    assert_parity,
    jax_fields,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
)

N_RAYS = 1024
TABLES = ("tlas_box", "tlas_enc", "tlas_leaf_inst", "inst_box", "inst_inv",
          "inst_root", "inst_layers", "inst_prim_base", "forest_box",
          "forest_enc", "leaf_first", "leaf_count", "tri", "tri_prim",
          "tri_layers", "tri_normal", "tlas_depth", "blas_depth")


def rot_y(theta, t=(0, 0, 0), s=1.0):
    c, n = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.float32([[c, 0, n], [0, 1, 0], [-n, 0, c]]) * s
    m[:3, 3] = t
    return m


def fill(tlas):
    """3 meshes (one with per-triangle layers), 36 instances (a TLAS of
    2 levels): rotated, scaled, some with instance layer masks."""
    rng = np.random.default_rng(3)
    plane = meshes.plane(12.0, subdiv=8)
    ids = [tlas.add_mesh(meshes.uv_sphere(1.0, 8, 16)),
           tlas.add_mesh(meshes.box((1.4, 1.0, 1.2))),
           tlas.add_mesh(plane, layers=(np.arange(len(plane)) % 2 + 1)
                         .astype(np.int32))]
    tlas.add_instance(ids[2], rot_y(0.0, (0, -1.5, 0)))
    for i in range(35):
        tlas.add_instance(ids[i % 2],
                          rot_y(rng.uniform(0, 6.3), rng.uniform(-6, 6, 3),
                                rng.uniform(0.4, 1.2)),
                          layers=-1 if i % 3 else 0b01)
    tlas.build_tlas()
    return tlas


@pytest.fixture(scope="module")
def tlases():
    return fill(JaxSceneTLAS(backend="jnp")), fill(SceneTLAS(
        backend="jnp", device="cpu"))


def rays_np(seed=4, n=N_RAYS):
    o, d = rand_rays_np(n, seed=seed, extent=6.0)
    t_max = np.full(n, 3.402823466e38, np.float32)
    t_max[::61] = -1.0
    return o, d, np.full(n, 1e-3, np.float32), t_max


def world_tris(tlas):
    w = tlas._world_tris_np()
    return make_triangles(w[:, 0], w[:, 1], w[:, 2],
                          layers=tlas._flat_layers, device="cpu")


def assert_same(h, hj, ij, inst):
    """Parity, then on equal prims: instance ids and layers exact, u, v
    and position within the parity rtol times max(|t|, 1), normals to
    1e-5.  XLA fuses the world -> object transform into FMAs where the
    port rounds each product (ROADMAP queue C): the object-space origin
    moves by an ulp of the world coordinates, an ABSOLUTE t error that
    can pass rtol 1e-5 on a hit close to the origin, so t carries the
    anchored cast's absolute allowance ``ANCHOR_ATOL``."""
    same = assert_parity(h, hj, atol=ANCHOR_ATOL)
    np.testing.assert_array_equal(np_of(inst)[same], np_of(ij)[same])
    np.testing.assert_array_equal(np_of(h.hit), np_of(hj.hit))
    np.testing.assert_array_equal(np_of(h.hit_layers)[same],
                                  np_of(hj.hit_layers)[same])
    scale = 1e-5 * np.maximum(np.abs(np_of(hj.t)), 1.0)[same]
    for f in ("u", "v", "position"):
        diff = np.abs(np_of(getattr(h, f)) - np_of(getattr(hj, f)))[same]
        assert (diff.reshape(len(scale), -1).max(1) <= scale).all(), f
    np.testing.assert_allclose(np_of(h.normal)[same], np_of(hj.normal)[same],
                               atol=1e-5)
    return same


def test_tables_equal_jax(tlases):
    """build_frontier_tlas: the BLAS forest, the TLAS over instance
    AABBs and the leaf -> instance slots equal the JAX package's."""
    jt, pt = tlases
    ft, fj = pt.build_two_level(), jt.build_two_level()
    assert isinstance(ft, ptf.FrontierTLAS) and ft.tlas_depth >= 2
    for f in TABLES:
        a, b = getattr(ft, f), getattr(fj, f)
        if isinstance(a, tuple):
            for x, y in zip(a, b, strict=True):
                np.testing.assert_array_equal(np_of(x), np_of(y), f)
        elif isinstance(a, int):
            assert a == b, f
        else:
            np.testing.assert_array_equal(np_of(a), np_of(b), f)


@pytest.mark.parametrize("any_hit,mask", [(False, -1), (True, -1),
                                          (False, 0b01)])
def test_fast_cast_equals_jax(tlases, any_hit, mask):
    """cast_rays_tlas on identical tables: parity with the JAX cast,
    instance ids and occluded exact, counters summed equal; and the
    port's own tables through ``cast_rays_two_level_fast`` give the same
    answer bit for bit."""
    jt, pt = tlases
    fj = jt.build_two_level()
    ft = ptf.frontier_tlas_from_jax(device="cpu", **jax_fields(fj))
    o, d, tmn, tmx = rays_np()
    hj, sj, oj, ij = jtf.cast_rays_tlas(jax_rays(o, d, tmn, tmx), fj, mask,
                                        any_hit)
    h, s, occ, inst = ptf.cast_rays_tlas(port_rays(o, d, tmn, tmx), ft,
                                         mask, any_hit)
    np.testing.assert_array_equal(np_of(occ), np_of(oj))
    for f in ("tri_tests", "bvh_nodes_visited", "hits"):
        assert int(getattr(s, f)) == int(getattr(sj, f)), f
    h2, _, occ2, inst2 = pt.cast_rays_two_level_fast(
        port_rays(o, d, tmn, tmx), mask, any_hit)
    assert torch.equal(occ2, occ) and torch.equal(inst2, inst)
    assert torch.equal(h2.t, h.t) and torch.equal(h2.prim_id, h.prim_id)
    if not any_hit:
        assert_same(h, hj, ij, inst)


def test_fast_cast_against_brute_and_flat(tlases):
    """The fast cast against the brute oracle over the world triangles
    (object-space against world-space Moller-Trumbore: parity with the
    absolute allowance of ``assert_same``), instance ids against the flat
    twin's on equal prims, any hit exact."""
    _, pt = tlases
    o, d, tmn, tmx = rays_np(seed=5)
    rays = port_rays(o, d, tmn, tmx)
    h, _, _, inst = pt.cast_rays_two_level_fast(rays)
    wt = world_tris(pt)
    hb, _ = cast_rays_brute(rays, wt)
    same = assert_parity(h, hb, atol=ANCHOR_ATOL)
    np.testing.assert_array_equal(np_of(inst)[same],
                                  np_of(pt._instance_of_hits(hb))[same])
    _, _, occ, _ = pt.cast_rays_two_level_fast(rays, any_hit=True)
    assert torch.equal(occ, any_hit_brute(rays, wt))


def test_instance_loop_equals_jax(tlases):
    """cast_rays_two_level on both packages' jnp meshes: parity, instance
    ids exact on equal prims; the port's loop over B1's plain version
    (cluster meshes) by the parity rule with the anchored allowance."""
    jt, pt = tlases
    o, d, tmn, tmx = rays_np(seed=6, n=512)
    hj, ij = jt.cast_rays_two_level(jax_rays(o, d, tmn, tmx))
    h, inst = pt.cast_rays_two_level(port_rays(o, d, tmn, tmx))
    assert inst.dtype == torch.int32
    assert_same(h, hj, ij, inst)
    pc = fill(SceneTLAS(device="cpu"))
    hc, ic = pc.cast_rays_two_level(port_rays(o, d, tmn, tmx))
    same = assert_parity(hc, hj, atol=ANCHOR_ATOL)
    np.testing.assert_array_equal(np_of(ic)[same], np_of(ij)[same])


def test_cache_invalidation_follows_jax():
    """set_transform and add_instance + build_tlas drop the two-level
    tables in both packages; the next fast cast sees the change."""
    jt, pt = (fill(JaxSceneTLAS(backend="jnp")),
              fill(SceneTLAS(backend="jnp", device="cpu")))
    o = np.float32([[0.3, 0.2, 9.0], [0.3, 12.0, 0.2]])
    d = np.float32([[0, 0, -1], [0, -1, 0]])

    def both():
        hj, _, _, ij = jt.cast_rays_two_level_fast(jax_rays(o, d))
        h, _, _, i = pt.cast_rays_two_level_fast(port_rays(o, d))
        assert_parity(h, hj)
        np.testing.assert_array_equal(np_of(i), np_of(ij))
        return h, i

    both()
    assert pt._two_level is not None
    for t in (pt, jt):
        t.set_transform(3, rot_y(0.4, (0.3, 6.0, 0.2), 1.3))
    assert pt._two_level is None
    h, i = both()
    assert int(i[1]) == 3
    for t in (pt, jt):
        t.add_instance(0, rot_y(0.0, (0.1, 0.05, 7.0)))
    assert pt._two_level is None
    for t in (pt, jt):
        t.build_tlas()
    h, i = both()
    assert int(i[0]) == 36 and float(h.t[0]) == pytest.approx(1.0, abs=0.1)
