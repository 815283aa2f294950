"""PyTorch port: the wide cast's plain version (kernel B4's) against the
brute oracle on a ~5K-triangle scene, the ``jnp`` backend's per-ray
traversal against the JAX one with exact per-ray stats, the ``pallas`` /
``jnp`` backends end to end through RayScene and SceneTLAS against the JAX
package, the v1 cluster entry points (B3) on kernel B1 against JAX v1, and
the CUDA kernel against its plain version where a card is present."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu.accel import traverse as jtraverse  # noqa: E402
from messyerraytracer_tpu.accel.tlas import (  # noqa: E402
    SceneTLAS as JaxSceneTLAS,
)
from messyerraytracer_tpu.kernels.cluster import (  # noqa: E402
    cast_rays_cluster as jax_cast_v1,
)
from messyerraytracer_tpu.kernels.cluster_tlas import (  # noqa: E402
    build_cluster_tlas as jax_build_tlas,
    cast_rays_cluster_tlas as jax_cast_tlas_v1,
)
from messyerraytracer_tpu.scene import scene as jscene  # noqa: E402

import messyerraytracer_tpu_torch as pmrt  # noqa: E402
from messyerraytracer_tpu_torch.accel import traverse as ptraverse  # noqa
from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS  # noqa: E402
from messyerraytracer_tpu_torch.core.brute import cast_rays_brute  # noqa
from messyerraytracer_tpu_torch.kernels import cluster_v2  # noqa: E402
from messyerraytracer_tpu_torch.kernels.cluster import (  # noqa: E402
    build_cluster_scene,
    cast_rays_cluster,
)
from messyerraytracer_tpu_torch.kernels.cluster_tlas import (  # noqa: E402
    build_cluster_tlas,
    cast_rays_cluster_tlas,
)
from messyerraytracer_tpu_torch.kernels.traverse_pallas import (  # noqa
    cast_rays_wide,
    cuda_library,
    wide_cast,
    wide_cast_cuda,
    wide_cast_plain,
)
from messyerraytracer_tpu_torch.scene import scene as pscene  # noqa: E402
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_parity,
    assert_same_hits,
    jax_cluster_scene,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
    small_tris,
    terrain_tris,
)


def mixed_rays(n, seed, extent=5.0):
    """(origin, direction, t_max) from a seed, with zero-direction and
    dead (t_max < t_min) rays mixed in."""
    o, d = rand_rays_np(n, seed=seed, extent=extent)
    d[::67] = 0.0
    t_max = np.full(n, 3.402823466e38, np.float32)
    t_max[::59] = -1.0
    return o, d, t_max


# ---------------------------------------------------------------------------
# the plain version of B4 against the brute oracle (no JAX)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mid_tris():
    """~4.2K triangles: displaced terrain + a sphere, two layers."""
    tris = np.concatenate([terrain_tris(40, extent=16.0),
                           meshes.uv_sphere(2.0, 16, 32, center=(0, 2, 0))])
    lay = np.where(np.arange(len(tris)) < 3200, 0b01, 0b10).astype(np.int32)
    return tris, lay


@pytest.mark.parametrize("branching,columnar", [(8, None), (8, "q"),
                                                (2, None)])
def test_plain_wide_cast_matches_brute(mid_tris, branching, columnar):
    tris, lay = mid_tris
    ps = pscene.build_scene_from_tri_array(tris, layers=lay,
                                           backend="pallas",
                                           branching=branching, device="cpu")
    o, d, t_max = mixed_rays(2048, seed=41, extent=8.0)
    rays = port_rays(o, d, t_max=t_max)
    for qm in (-1, 0b10):
        h, s, found = cast_rays_wide(rays, ps.wide, qm, columnar=columnar)
        hb, _ = cast_rays_brute(rays, ps.tris, qm, chunk=4096)
        assert_same_hits(h, hb)
        assert int(s.stack_drops) == 0 and int(s.hits) > 100
        assert not h.hit.numpy()[t_max < 0].any()
        _, _, occ = cast_rays_wide(rays, ps.wide, qm, any_hit=True,
                                   columnar=columnar)
        np.testing.assert_array_equal(occ.numpy(), hb.hit.numpy())
        for f in ("t", "u", "v", "normal", "position"):
            assert bool(torch.isfinite(getattr(h, f)).all())


def test_quantized_visits_a_superset(mid_tris):
    tris, _ = mid_tris
    ws = pscene.build_scene_from_tri_array(tris, backend="pallas",
                                           device="cpu").wide
    rays = port_rays(*rand_rays_np(512, seed=42, extent=8.0))
    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, ws)
    fe, ie, ce = wide_cast_plain(*args)
    fq, iq, cq = wide_cast_plain(*args, quantized=True)
    assert torch.equal(fe[0], fq[0])               # the same closest t
    assert bool((iq[1] >= ie[1]).all()) and int(cq[0]) >= int(ce[0])


def test_stack_bound_forced_drops_and_chunking(mid_tris):
    tris, _ = mid_tris
    ws = pscene.build_scene_from_tri_array(tris, backend="pallas",
                                           branching=2, device="cpu").wide
    rays = port_rays(*rand_rays_np(700, seed=43, extent=8.0))
    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, ws)
    whole = wide_cast_plain(*args, kstack=ws.stack_need)
    assert int(whole[2][1]) == 0                 # the build-time bound holds
    _, i1, c1 = wide_cast_plain(*args, kstack=1)
    assert int(c1[1]) > 0                         # a small stack reports
    assert not torch.equal(i1[1], whole[1][1])
    parts = wide_cast_plain(*args, kstack=ws.stack_need, chunk=97)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_routing_never_falls_back(mid_tris):
    tris, _ = mid_tris
    ws = pscene.build_scene_from_tri_array(tris[:300], backend="pallas",
                                           device="cpu").wide
    rays = port_rays(*rand_rays_np(64, seed=44))
    before = cuda_library.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        wide_cast_cuda(rays.origin, rays.direction, rays.t_min, rays.t_max,
                       ws)                          # CPU tensors: no fallback
    assert cuda_library.launches == before
    for a, b in zip(wide_cast(rays, ws),
                    wide_cast_plain(rays.origin, rays.direction, rays.t_min,
                                    rays.t_max, ws)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="8-wide"):
        b2 = pscene.build_scene_from_tri_array(tris[:300], backend="pallas",
                                               branching=2, device="cpu")
        cast_rays_wide(rays, b2.wide, columnar="q")
    with pytest.raises(ValueError, match="columnar"):
        cast_rays_wide(rays, ws, columnar="rows")
    with pytest.raises(ValueError, match="branching"):
        pscene.build_scene_from_tri_array(tris[:300], backend="pallas",
                                          branching=4, device="cpu")


# ---------------------------------------------------------------------------
# the jnp backend against the JAX per-ray traversal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("query_mask,any_hit", [(-1, False), (0b10, False),
                                                (-1, True)])
def test_jnp_backend_matches_jax_per_ray(query_mask, any_hit):
    tris = small_tris()
    lay = np.where(np.arange(len(tris)) % 3 == 0, 0b01, 0b10).astype(
        np.int32)
    js = jscene.build_scene_from_tri_array(tris, layers=lay, backend="jnp")
    ps = pscene.build_scene_from_tri_array(tris, layers=lay, backend="jnp",
                                           device="cpu")
    o, d, t_max = mixed_rays(1024, seed=45)
    rj, rp = jax_rays(o, d, t_max=t_max), port_rays(o, d, t_max=t_max)
    qm = jax.numpy.int32(query_mask)
    ref = jax.vmap(lambda a, b, c, e: jtraverse._traverse_one(
        a, b, c, e, js.bvh, js.tris, qm, any_hit))(
            rj.origin, rj.direction, rj.t_min, rj.t_max)
    (best, slot, _, _, nv, tt, occ), drops = ptraverse._traverse(
        rp.origin, rp.direction, rp.t_min, rp.t_max, ps.bvh, ps.tris,
        query_mask, any_hit)
    # per-ray stats exactly: the same algorithm
    np.testing.assert_array_equal(nv.numpy(), np_of(ref[4]))
    np.testing.assert_array_equal(tt.numpy(), np_of(ref[5]))
    np.testing.assert_array_equal(occ.numpy(), np_of(ref[6]))
    assert int(drops) == 0
    hj, sj, occ_j = jtraverse.cast_rays_bvh(rj, js.tris, js.bvh, query_mask,
                                            any_hit=any_hit)
    hp, sp, occ_p = ptraverse.cast_rays_bvh(rp, ps.tris, ps.bvh, query_mask,
                                            any_hit=any_hit)
    np.testing.assert_array_equal(occ_p.numpy(), np_of(occ_j))
    assert int(sp.tri_tests) == int(sj.tri_tests)
    assert int(sp.bvh_nodes_visited) == int(sj.bvh_nodes_visited)
    if not any_hit:
        assert_same_hits(hp, hj)
        np.testing.assert_array_equal(slot.numpy(), np_of(ref[1]))


# ---------------------------------------------------------------------------
# RayScene / SceneTLAS end to end against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_ray_scene_backends_match_jax(backend):
    tris = small_tris()
    lay = np.where(np.arange(len(tris)) % 4 == 0, 0b01, 0b10).astype(
        np.int32)
    js = jscene.build_scene_from_tri_array(tris, layers=lay, backend=backend)
    ps = pscene.build_scene_from_tri_array(tris, layers=lay, backend=backend,
                                           device="cpu")
    assert (ps.wide is None) == (backend == "jnp") and ps.cluster is None
    o, d, t_max = mixed_rays(1024, seed=46)
    rj, rp = jax_rays(o, d, t_max=t_max), port_rays(o, d, t_max=t_max)
    hj, sj = js.cast_rays(rj)
    hp, sp = ps.cast_rays(rp)
    assert_same_hits(hp, hj)
    assert int(sp.hits) == int(sj.hits) > 100
    np.testing.assert_array_equal(ps.any_hit_rays(rp).numpy(),
                                  np_of(js.any_hit_rays(rj)))


def xform(tx, ty, tz, s=1.0):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    m[:3, 3] = (tx, ty, tz)
    return m


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_scene_tlas_backends_match_jax(backend):
    jt, pt = JaxSceneTLAS(backend=backend), SceneTLAS(backend=backend,
                                                      device="cpu")
    for t in (jt, pt):
        t.add_mesh(terrain_tris(6, extent=8.0))
        t.add_mesh(meshes.uv_sphere(1.0, 6, 8))
        t.add_instance(0, xform(0.0, 0.0, 0.0))
        for k in range(3):
            t.add_instance(1, xform(2.5 * k - 2.5, 1.2, 0.5 * k, 0.8))
        t.build_tlas()
    assert all((m.scene.wide is not None) == (backend == "pallas")
               for m in pt.meshes)
    o, d = rand_rays_np(512, seed=47, extent=4.0)
    hj, _, ij = jt.cast_rays(jax_rays(o, d))
    hp, sp, ip = pt.cast_rays(port_rays(o, d))
    assert_same_hits(hp, hj)
    same = hp.prim_id.numpy() == np_of(hj.prim_id)
    np.testing.assert_array_equal(ip.numpy()[same], np_of(ij)[same])
    assert pt.flat.backend == backend and int(sp.hits) > 50


# ---------------------------------------------------------------------------
# B3: the v1 cluster entry points on kernel B1, against JAX v1
# ---------------------------------------------------------------------------

def test_v1_cluster_cast_matches_jax_v1():
    tris = small_tris()
    _, jcs = jax_cluster_scene(tris, 32)
    ps = pscene.build_scene_from_tri_array(tris, device="cpu")
    pcs = build_cluster_scene(ps.bvh, ps.tris, tcap=32)
    o, d = rand_rays_np(256, seed=48)
    hj, sj, occ_j, prj = jax_cast_v1(jax_rays(o, d), jcs,
                                     return_per_ray=True)
    hp, sp, occ_p, prp = cast_rays_cluster(port_rays(o, d), pcs,
                                           srows=8, qd=2, inner=4, gr=2,
                                           return_per_ray=True)
    assert_same_hits(hp, hj)
    np.testing.assert_array_equal(occ_p.numpy(), np_of(occ_j))
    assert set(prp) == {"tri_tests"} == set(prj)
    # v1 is v2 on B1: the same outputs
    h2, s2, _ = cluster_v2.cast_rays_cluster_v2(port_rays(o, d), pcs)
    assert_same_hits(hp, h2, rtol=0.0, atol=0.0)
    assert int(sp.tri_tests) == int(s2.tri_tests)
    with pytest.raises(ValueError, match="TPU-only"):
        cast_rays_cluster(port_rays(o, d), pcs, probe="pop")


def test_v1_cluster_tlas_matches_jax_v1():
    ms = [meshes.uv_sphere(1.0, 6, 12), meshes.box((1.0, 2.0, 1.0))]
    inst = [(0, xform(0, 0, 0)[:3]), (1, xform(-3, 0, 0, 1.2)[:3]),
            (0, xform(3, 0.5, -1, 0.5)[:3])]
    jct = jax_build_tlas(ms, inst, tcap=32)
    pct = build_cluster_tlas(ms, inst, tcap=32, device="cpu")
    cam = pmrt.CameraParams.look_at((0, 2, 8), (0, 0, 0), fov_degrees=60.0)
    r = pmrt.generate_rays(cam, 16, 16, device="cpu")
    o, d = np_of(r.origin), np_of(r.direction)
    hj, _, occ_j, ij = jax_cast_tlas_v1(jax_rays(o, d), jct)
    hp, sp, occ_p, ip = cast_rays_cluster_tlas(port_rays(o, d), pct,
                                               srows=8, qd=2)
    assert_parity(hp, hj)
    np.testing.assert_array_equal(ip.numpy(), np_of(ij))   # instance ids
    np.testing.assert_array_equal(occ_p.numpy(), np_of(occ_j))
    assert int(sp.hits) > 20 and set(ip.numpy().tolist()) == {-1, 0, 1, 2}


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a card)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_kernel_matches_plain(mid_tris):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tris, lay = mid_tris
    o, d, t_max = mixed_rays(8192, seed=50, extent=8.0)
    rays = port_rays(o, d, t_max=t_max).to(dev)
    # sparse warps: 28 of every 32 rays dead
    sparse_t = t_max.copy()
    sparse_t[np.arange(len(sparse_t)) % 32 >= 4] = -1.0
    sparse = port_rays(o, d, t_max=sparse_t).to(dev)
    cam = pmrt.CameraParams.look_at((1, 3, 6), (3, 0, 3), fov_degrees=30.0)
    grid = pmrt.generate_rays(cam, 128, 64, device=dev)     # coherent
    for branching in (8, 2):
        def wide(copies):
            return pscene.build_scene_from_tri_array(
                np.concatenate([tris] * copies),
                layers=np.concatenate([lay] * copies), backend="pallas",
                branching=branching, device=dev).wide

        ws = wide(1)
        cases = [(rays, ws, kw) for kw in (
            {}, {"any_hit": True}, {"query_mask": 0b10}, {"kstack": 1},
            {"quantized": branching == 8})]
        cases += [(grid, ws, {}), (sparse, ws, {}),
                  (rays, wide(2), {})]             # ties: every tri twice
        for r, w, kw in cases:
            args = (r.origin, r.direction, r.t_min, r.t_max, w)
            before = cuda_library.launches
            k = wide_cast_cuda(*args, **kw)
            p = wide_cast_plain(*args, **kw)
            torch.cuda.synchronize()
            assert cuda_library.launches == before + 1
            for a, b in zip(k, p):
                assert torch.equal(a, b), kw
        # the warp-counting build: the same outputs, and lane counts that
        # fit in 32 lanes per pass
        stats = torch.zeros(5, dtype=torch.int64, device=dev)
        args = (grid.origin, grid.direction, grid.t_min, grid.t_max, ws)
        counted = wide_cast_cuda(*args, warp_stats=stats)
        for a, b in zip(counted, wide_cast_cuda(*args)):
            assert torch.equal(a, b)
        passes, popping, leaf_passes, wanting, coop = stats.tolist()
        assert 0 < popping <= 32 * passes and 0 < wanting <= 32 * leaf_passes
        assert 0 <= coop <= wanting
