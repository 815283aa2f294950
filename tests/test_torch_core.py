"""PyTorch port: core types, geometry and the brute-force oracle against the
JAX package on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import messyerraytracer_tpu.core.types as jtypes  # noqa: E402
from messyerraytracer_tpu.core import brute as jbrute  # noqa: E402
from messyerraytracer_tpu.core import geometry as jgeom  # noqa: E402

import messyerraytracer_tpu_torch.core.types as ptypes  # noqa: E402
from messyerraytracer_tpu_torch.core import brute as pbrute  # noqa: E402
from messyerraytracer_tpu_torch.core import geometry as pgeom  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_same_hits,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
)


def soup(n, seed=0):
    """Random triangle soup (n, 3, 3) around the origin."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5.0, 5.0, (n, 1, 3)).astype(np.float32)
    return c + rng.uniform(-0.6, 0.6, (n, 3, 3)).astype(np.float32)


def tri_pair(tris, layers=None):
    t = (tris[:, 0], tris[:, 1], tris[:, 2])
    return (jtypes.make_triangles(*t, layers=layers),
            ptypes.make_triangles(*t, layers=layers, device="cpu"))


@pytest.mark.parametrize("name", [
    "T_MIN_DEFAULT", "T_MAX_DEFAULT", "INV_DIR_EPS", "MT_DET_EPS",
    "MT_BARY_EPS", "NO_HIT", "ALL_LAYERS"])
def test_constants_equal(name):
    a, b = getattr(jtypes, name), getattr(ptypes, name)
    assert type(a) is type(b) and a == b
    assert np.float32(a).tobytes() == np.float32(b).tobytes()


def test_make_rays_and_triangles_match():
    o, d = rand_rays_np(64, seed=3)
    rj, rp = jax_rays(o, d), port_rays(o, d)
    for f in ("origin", "direction", "t_min", "t_max"):
        np.testing.assert_array_equal(np_of(getattr(rp, f)),
                                      np_of(getattr(rj, f)))
    tj, tp = tri_pair(soup(50))
    for f in ("v0", "edge1", "edge2", "normal", "prim_id", "layers"):
        np.testing.assert_array_equal(np_of(getattr(tp, f)),
                                      np_of(getattr(tj, f)))
    np.testing.assert_array_equal(np_of(tp.v1), np_of(tj.v1))


def test_safe_inverse_matches():
    d = np.array([[0.0, -0.0, 1e-10], [-1e-10, 2.0, -0.5],
                  [1e-9, -1e-9, 3.0]], np.float32)
    np.testing.assert_array_equal(
        np_of(ptypes.safe_inv_direction(torch.from_numpy(d))),
        np_of(jtypes.safe_inv_direction(d)))


def test_geometry_matches_jax():
    rng = np.random.default_rng(5)
    o, d = rand_rays_np(128, seed=5)
    tris = soup(128, seed=6)
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    tmin = np.full(128, 1e-3, np.float32)
    tmax = np.full(128, 1e30, np.float32)
    args = (o[:, None], d[:, None], tmin[:, None], tmax[:, None],
            v0[None], e1[None], e2[None])
    vj, tj, uj, wj = jgeom.moller_trumbore(*args)
    vp, tp, up, wp = pgeom.moller_trumbore(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    np.testing.assert_array_equal(np_of(vp), np_of(vj))
    for a, b in ((tp, tj), (up, uj), (wp, wj)):
        np.testing.assert_allclose(np_of(a)[np_of(vj)], np_of(b)[np_of(vj)],
                                   rtol=1e-5, atol=1e-6)

    bmin = rng.uniform(-5, 0, (128, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0.1, 5, (128, 3)).astype(np.float32)
    inv = np.array(jtypes.safe_inv_direction(d))
    hj, ej = jgeom.slab_test(o, inv, tmax, bmin, bmax)
    hp, ep = pgeom.slab_test(*(torch.from_numpy(a)
                               for a in (o, inv, tmax, bmin, bmax)))
    np.testing.assert_array_equal(np_of(hp), np_of(hj))
    np.testing.assert_array_equal(np_of(ep), np_of(ej))

    valid = rng.random((16, 9)) < 0.5
    t = rng.integers(0, 4, (16, 9)).astype(np.float32)   # forced ties
    idx = np.arange(9)[None, :]
    aj, gj = jgeom.closest_select(valid, t, idx)
    ap, gp = pgeom.closest_select(torch.from_numpy(valid),
                                  torch.from_numpy(t), torch.from_numpy(idx))
    np.testing.assert_array_equal(np_of(ap), np_of(aj))
    np.testing.assert_array_equal(np_of(gp)[np_of(aj)], np_of(gj)[np_of(aj)])

    mj = jgeom.aabb_of_triangles(tris[:, 0], tris[:, 1], tris[:, 2])
    mp = pgeom.aabb_of_triangles(*(torch.from_numpy(tris[:, k].copy())
                                   for k in range(3)))
    for a, b in zip(mp, mj):
        np.testing.assert_array_equal(np_of(a), np_of(b))


@pytest.mark.parametrize("query_mask", [-1, 0b01, 0b10])
def test_brute_closest_matches_jax(query_mask):
    # t within rtol 1e-6: the same f32 formula under a different op order
    tris = soup(2048, seed=1)
    layers = np.where(np.arange(2048) % 3 == 0, 0b10, 0b01).astype(np.int32)
    tj, tp = tri_pair(tris, layers)
    o, d = rand_rays_np(512, seed=2)
    hj, sj = jbrute.cast_rays_brute(jax_rays(o, d), tj, query_mask)
    hp, sp = pbrute.cast_rays_brute(port_rays(o, d), tp, query_mask,
                                    chunk=700, ray_chunk=200)
    np.testing.assert_array_equal(np_of(hp.prim_id), np_of(hj.prim_id))
    np.testing.assert_allclose(np_of(hp.t), np_of(hj.t), rtol=1e-6)
    for f in ("u", "v", "normal", "position"):
        np.testing.assert_allclose(np_of(getattr(hp, f)),
                                   np_of(getattr(hj, f)), atol=1e-5)
    np.testing.assert_array_equal(np_of(hp.hit_layers), np_of(hj.hit_layers))
    assert int(sp.hits) == int(sj.hits) > 0
    assert int(sp.tri_tests) == int(sj.tri_tests)


@pytest.mark.parametrize("query_mask", [-1, 0b10])
def test_any_hit_brute_matches_jax(query_mask):
    tris = soup(2048, seed=7)
    layers = np.where(np.arange(2048) % 2 == 0, 0b10, 0b01).astype(np.int32)
    tj, tp = tri_pair(tris, layers)
    o, d = rand_rays_np(512, seed=8)
    oj = jbrute.any_hit_brute(jax_rays(o, d), tj, query_mask)
    op = pbrute.any_hit_brute(port_rays(o, d), tp, query_mask, chunk=1000)
    np.testing.assert_array_equal(np_of(op), np_of(oj))
    assert 0 < int(op.sum()) < 512


def test_zero_direction_and_empty_scene_miss():
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    tris = soup(300, seed=9)
    o = np.zeros((4, 3), np.float32)
    d = np.array([[0, 0, 0], [0, 0, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    rays = port_rays(o, d)
    for h, _ in (pbrute.cast_rays_brute(rays, tri_pair(tris)[1]),
                 build_scene_from_tri_array(tris, device="cpu").cast_rays(
                     rays)):
        assert not bool(h.hit[:2].any())
        for f in ("t", "u", "v", "normal", "position"):
            assert bool(torch.isfinite(getattr(h, f)).all())
    empty = ptypes.make_triangles(*(np.zeros((0, 3), np.float32),) * 3,
                                  device="cpu")
    h, s = pbrute.cast_rays_brute(rays, empty)
    assert not bool(h.hit.any()) and int(s.hits) == 0
    assert not bool(pbrute.any_hit_brute(rays, empty).any())


def test_brute_chunking_is_invisible():
    tris = soup(1500, seed=11)
    tp = tri_pair(tris)[1]
    rays = port_rays(*rand_rays_np(300, seed=12))
    ref, _ = pbrute.cast_rays_brute(rays, tp)
    for chunk, ray_chunk in ((1, 300), (97, 7), (5000, 1)):
        h, _ = pbrute.cast_rays_brute(rays, tp, chunk=chunk,
                                      ray_chunk=ray_chunk)
        assert_same_hits(h, ref, rtol=0.0, atol=0.0)


def test_parity_rule():
    def hits(t, prim):
        h = ptypes.make_miss(len(t), device="cpu")
        h.t = torch.tensor(t, dtype=torch.float32)
        h.prim_id = torch.tensor(prim, dtype=torch.int32)
        return h

    ref = hits([1.0, 2.0, 10.0], [3, 4, 5])
    assert pbrute.parity(hits([1.0, 2.0, 10.0], [3, 4, 5]), ref)
    # a prim swap on a tie (t within 4e-6 relative) passes
    assert pbrute.parity(hits([1.0, 2.0 * (1 + 3e-6), 10.0], [3, 9, 5]), ref)
    # a prim swap off a tie fails, and so does t beyond rtol
    assert not pbrute.parity(hits([1.0, 2.0 * (1 + 8e-6), 10.0],
                                  [3, 9, 5]), ref)
    assert not pbrute.parity(hits([1.0, 2.0, 10.001], [3, 4, 5]), ref)


def test_ray_stats_rates():
    i = lambda x: torch.tensor(x)  # noqa: E731
    s = ptypes.RayStats(rays_cast=i(4), tri_tests=i(10),
                        bvh_nodes_visited=i(6), hits=i(1))
    s2 = s + s
    assert int(s2.rays_cast) == 8 and int(s2.stack_drops) == 0
    assert s2.avg_tri_tests_per_ray() == 2.5
    assert s2.avg_nodes_per_ray() == 1.5 and s2.hit_rate() == 0.25
