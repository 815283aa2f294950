"""PyTorch port: the flat cluster cast (plain version of kernel B1) against
the JAX cluster kernel in interpret mode (small scenes only); the larger
scene against the brute oracle is in test_torch_cluster_brute.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu.kernels.cluster_v2 import (  # noqa: E402
    cast_rays_cluster_v2 as jax_cast,
)

from messyerraytracer_tpu_torch.core.brute import cast_rays_brute  # noqa
from messyerraytracer_tpu_torch.kernels import cluster_v2  # noqa: E402
from messyerraytracer_tpu_torch.kernels.cluster import (  # noqa: E402
    build_cluster_scene,
    cluster_scene_from_jax,
)
from messyerraytracer_tpu_torch.kernels.cluster_v2 import (  # noqa: E402
    cast_rays_cluster_v2,
    cluster_cast,
    cluster_cast_cuda,
    cluster_cast_plain,
)
from messyerraytracer_tpu_torch.scene.scene import (  # noqa: E402
    build_scene_from_tri_array,
)
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    ANCHOR_ATOL,
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

TABLES = ("node_box", "node_child", "node_axis", "tri", "tri_prim",
          "tri_layers", "cl_anchor", "cl_count", "cl_aabb")


def converted(jcs):
    return cluster_scene_from_jax(
        np.asarray(jcs.nodes), np.asarray(jcs.ablocks), tcap=jcs.tcap,
        dummy_enc=jcs.dummy_enc, num_clusters=jcs.num_clusters,
        stack_need=jcs.stack_need, device="cpu")


def port_cluster(tris, tcap, layers=None):
    ps = build_scene_from_tri_array(tris, layers=layers, device="cpu")
    return ps, build_cluster_scene(ps.bvh, ps.tris, tcap=tcap)


@pytest.fixture(scope="module")
def small():
    """(JAX ClusterScene, port ClusterScene) of the small scene, T=32."""
    tris = small_tris()
    _, jcs = jax_cluster_scene(tris, 32)
    return jcs, port_cluster(tris, 32)[1]


@pytest.fixture(scope="module")
def small_cast(small):
    """One interpret-mode JAX closest-hit cast of 256 rays, reused."""
    jcs, _ = small
    o, d = rand_rays_np(256, seed=1)
    hj, sj, _, pr = jax_cast(jax_rays(o, d), jcs, return_per_ray=True)
    return (o, d), hj, sj, pr


@pytest.mark.parametrize("tcap", [32, 64])
def test_tables_equal_converted_jax_tables(tcap):
    tris = np.concatenate([small_tris(), terrain_tris(12)])
    layers = (np.arange(len(tris)) * 2654435761 % (1 << 32)).astype(
        np.uint32).view(np.int32)        # all 32 bits, both halves
    _, jcs = jax_cluster_scene(tris, tcap, layers=layers)
    conv = converted(jcs)
    pcs = port_cluster(tris, tcap, layers=layers)[1]
    for f in TABLES:
        a, b = getattr(pcs, f).numpy(), getattr(conv, f).numpy()
        assert a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f     # bit for bit, NaNs too
    for f in ("tcap", "dummy_enc", "num_clusters", "stack_need"):
        assert getattr(pcs, f) == getattr(conv, f) == getattr(jcs, f)


def test_plain_cast_matches_jax_interpret(small, small_cast):
    jcs, pcs = small
    (o, d), hj, sj, _ = small_cast
    for cs in (pcs, converted(jcs)):     # own build and the JAX state
        hp, sp, found = cast_rays_cluster_v2(port_rays(o, d), cs)
        assert_same_hits(hp, hj)
        np.testing.assert_array_equal(np_of(hp.hit_layers),
                                      np_of(hj.hit_layers))
        np.testing.assert_array_equal(np_of(found), np_of(hj.hit))
        assert int(sp.hits) == int(sj.hits) > 0
        assert int(sp.stack_drops) == 0


def test_per_ray_counters(small):
    # counters are per ray (the JAX kernel counts a tile's footprint)
    _, pcs = small
    o, d = rand_rays_np(256, seed=2)
    h, s, _, pr = cast_rays_cluster_v2(port_rays(o, d), pcs,
                                       return_per_ray=True)
    tt, nv = pr["tri_tests"].numpy(), pr["node_visits"].numpy()
    assert tt.shape == (256,) and nv.shape == (256,)
    assert int(tt.sum()) == int(s.tri_tests)
    hit = h.hit.numpy()
    assert (tt[hit] > 0).all() and (nv[hit] > 0).all()
    assert int(s.bvh_nodes_visited) >= 256          # every live ray pops
    assert nv.max() <= 8 * int(s.bvh_nodes_visited)


def test_any_hit_matches_jax_interpret(small):
    jcs, pcs = small
    o, d = rand_rays_np(256, seed=3)
    _, _, occ_j = jax_cast(jax_rays(o, d), jcs, any_hit=True)
    _, sa, occ_p = cast_rays_cluster_v2(port_rays(o, d), pcs, any_hit=True)
    np.testing.assert_array_equal(occ_p.numpy(), np_of(occ_j))
    _, sc, occ_c = cast_rays_cluster_v2(port_rays(o, d), pcs)
    np.testing.assert_array_equal(occ_p.numpy(), occ_c.numpy())
    # retiring at the first hit never costs more work
    assert int(sa.bvh_nodes_visited) <= int(sc.bvh_nodes_visited)


def test_query_mask_hides_near_triangle():
    near = meshes.plane(4.0, y=1.0, subdiv=3)
    far = meshes.plane(4.0, y=0.0, subdiv=3)
    tris = np.concatenate([near, far])
    layers = np.concatenate([np.full(len(near), 0b01, np.int32),
                             np.full(len(far), 0b10, np.int32)])
    _, jcs = jax_cluster_scene(tris, 32, layers=layers)
    pcs = port_cluster(tris, 32, layers=layers)[1]
    rng = np.random.default_rng(4)
    o = np.stack([rng.uniform(-1.5, 1.5, 64), np.full(64, 3.0),
                  rng.uniform(-1.5, 1.5, 64)], axis=1).astype(np.float32)
    d = np.tile(np.float32([[0.0, -1.0, 0.0]]), (64, 1))
    hj, _, _ = jax_cast(jax_rays(o, d), jcs, query_mask=0b10)
    for qm, t_expect, lay in ((-1, 2.0, 0b01), (0b01, 2.0, 0b01),
                              (0b10, 3.0, 0b10)):
        hp, _, _ = cast_rays_cluster_v2(port_rays(o, d), pcs, query_mask=qm)
        np.testing.assert_allclose(hp.t.numpy(), t_expect, rtol=1e-6)
        assert (hp.hit_layers.numpy() == lay).all()
        assert (hp.prim_id.numpy() >= len(near)).all() == (qm == 0b10)
        if qm == 0b10:
            assert_same_hits(hp, hj)
    hp, _, _ = cast_rays_cluster_v2(port_rays(o, d), pcs, query_mask=0b100)
    assert not bool(hp.hit.any())


def test_dead_rays_miss_and_cost_nothing(small):
    _, pcs = small
    o, d = rand_rays_np(300, seed=6)
    tmax = np.where(np.arange(300) < 200, 3.4e38, -1.0).astype(np.float32)
    h, s, _, pr = cast_rays_cluster_v2(port_rays(o, d, t_max=tmax), pcs,
                                       return_per_ray=True)
    hl, _, _ = cast_rays_cluster_v2(port_rays(o[:200], d[:200]), pcs)
    np.testing.assert_array_equal(h.prim_id[:200].numpy(),
                                  hl.prim_id.numpy())
    np.testing.assert_array_equal(h.t[:200].numpy(), hl.t.numpy())
    assert (h.prim_id[200:].numpy() == -1).all()
    assert (pr["tri_tests"][200:].numpy() == 0).all()
    assert (pr["node_visits"][200:].numpy() == 0).all()
    _, sd, _ = cast_rays_cluster_v2(
        port_rays(o, d, t_max=np.full(300, -1.0, np.float32)), pcs)
    assert int(sd.bvh_nodes_visited) == 0 and int(sd.hits) == 0


def test_wrapper_routes_by_device(small):
    _, pcs = small
    rays = port_rays(*rand_rays_np(64, seed=8))
    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, pcs)
    for a, b in zip(cluster_cast(rays, pcs), cluster_cast_plain(*args)):
        assert torch.equal(a, b)
    before = cluster_v2.cuda_library.launches
    with pytest.raises(ValueError, match="CUDA"):
        cluster_cast_cuda(*args)             # CPU tensors: no fallback
    assert cluster_v2.cuda_library.launches == before
    assert cluster_v2.cuda_library.lib is None   # nvcc was never needed


def test_tpu_knobs_accepted_and_ignored(small):
    _, pcs = small
    rays = port_rays(*rand_rays_np(128, seed=9))
    ref, _, _ = cast_rays_cluster_v2(rays, pcs)
    h, _, _ = cast_rays_cluster_v2(rays, pcs, interpret=True, srows=32,
                                   qd=4, popn=2, qroom=8, dmode="all",
                                   nway=2)
    assert_same_hits(h, ref, rtol=0.0, atol=0.0)
    with pytest.raises(ValueError, match="probe"):
        cast_rays_cluster_v2(rays, pcs, probe="nodma")


def test_tie_goes_to_the_lowest_duplicate():
    # every triangle duplicated at a higher index: the builder puts both
    # copies in one cluster, lower index first, so every hit is an exact
    # tie inside a cluster, which the lowest index must win (the rule the
    # kernel's warp-cooperative reduction keeps)
    base = small_tris()
    tris = np.concatenate([base, base])
    _, jcs = jax_cluster_scene(tris, 32)
    ps, pcs = port_cluster(tris, 32)
    o, d = rand_rays_np(128, seed=12)
    rays = port_rays(o, d)
    fout, iout, counters = cluster_cast_plain(
        rays.origin, rays.direction, rays.t_min, rays.t_max, pcs)
    hp = cluster_v2._hits_from_buffers_v2(fout, iout, rays)[0]
    hj, _, _ = jax_cast(jax_rays(o, d), jcs)
    hb, _ = cast_rays_brute(rays, ps.tris)
    assert_same_hits(hp, hj)
    assert_parity(hp, hb, atol=ANCHOR_ATOL)
    hit = np_of(hp.hit)
    assert hit.sum() >= 20 and int(counters[1]) == 0
    assert (np_of(hp.prim_id)[hit] < len(base)).all()
    assert (np_of(hb.prim_id)[hit] < len(base)).all()
