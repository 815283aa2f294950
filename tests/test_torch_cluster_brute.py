"""PyTorch port: the flat cluster cast (plain version of kernel B1) on a
~20K-triangle scene against the port's brute oracle — more rays than one
JAX 2048-ray tile, where brute is the referee — plus the stack bound, and
the CUDA kernel against the plain version where a card is present."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu_torch.core.brute import cast_rays_brute  # noqa
from messyerraytracer_tpu_torch.kernels.cluster_v2 import (  # noqa: E402
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
    port_rays,
    rand_rays_np,
    terrain_tris,
)


@pytest.fixture(scope="module")
def terrain_scene():
    """~20K triangles: the displaced terrain plus a sphere."""
    tris = np.concatenate([terrain_tris(96, extent=16.0),
                           meshes.uv_sphere(2.0, 24, 48, center=(0, 2, 0))])
    return build_scene_from_tri_array(tris, device="cpu")


def test_plain_cast_matches_brute_multi_tile(terrain_scene):
    # 4096 rays: more than one 2048-ray JAX tile; brute is the referee
    o, d = rand_rays_np(4096, seed=5, extent=8.0)
    rays = port_rays(o, d)
    h, s = terrain_scene.cast_rays(rays)
    hb, _ = cast_rays_brute(rays, terrain_scene.tris, chunk=4096)
    # u, v to 1e-4: the anchored form's barycentric numerators carry the
    # same distance-to-anchor error as its t (see ANCHOR_ATOL)
    assert_same_hits(h, hb, atol=1e-4, t_atol=ANCHOR_ATOL)
    assert int(s.stack_drops) == 0 and int(h.hit.sum()) > 1000
    # occlusion: any valid hit exists exactly where the closest one does
    # (any_hit_brute itself is held against JAX in test_torch_core.py)
    occ = terrain_scene.any_hit_rays(rays)
    np.testing.assert_array_equal(occ.numpy(), hb.hit.numpy())


def shared_edge_points(tris, per_edge=4, max_edges=160):
    """Points ON interior (shared) triangle edges, in f64: in exact
    arithmetic the hit lies in both neighbours, and a cast that is not
    watertight can round it into neither (the JAX suite's
    test_watertight.py population)."""
    owners = {}
    for t in tris:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(np.round(t[a], 5)),
                                tuple(np.round(t[b], 5)))))
            owners.setdefault(key, []).append((t[a], t[b]))
    pts = []
    for edge in owners.values():
        if len(edge) < 2:
            continue                      # boundary edge: silhouette
        va, vb = edge[0]
        for s in np.linspace(0.15, 0.85, per_edge):
            pts.append(va.astype(np.float64) * (1 - s)
                       + vb.astype(np.float64) * s)
        if len(pts) >= max_edges * per_edge:
            break
    return np.asarray(pts, np.float64)


@pytest.mark.parametrize("tcap", [8, 32])
def test_edge_on_rays_no_cracks(tcap):
    from messyerraytracer_tpu_torch.kernels.cluster import (
        build_cluster_scene)
    from messyerraytracer_tpu_torch.kernels.cluster_v2 import (
        cast_rays_cluster_v2)

    g = meshes.plane(10.0, y=0.0, subdiv=16)
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.7) * np.cos(g[:, :, 2] * 0.6)) * 1.5
    scene = build_scene_from_tri_array(g, device="cpu")
    cs = build_cluster_scene(scene.bvh, scene.tris, tcap=tcap)
    pts = shared_edge_points(np.asarray(g, np.float64))
    origin = np.float64([0.3, 9.0, 11.0])
    d = pts - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = port_rays(np.tile(origin.astype(np.float32), (len(pts), 1)),
                     d.astype(np.float32))
    hb, _ = cast_rays_brute(rays, scene.tris)
    h, s, _ = cast_rays_cluster_v2(rays, cs)
    hit = hb.hit.numpy()
    assert hit.sum() >= 100
    cracks = hit & ~h.hit.numpy()
    assert cracks.sum() == 0, f"crack rays: {np.nonzero(cracks)[0]}"
    # where the oracle hits, the cast may resolve an edge tie to the other
    # neighbour: the parity rule's tie clause covers it.  The reverse is
    # allowed: the classic MT of the oracle has no MT_BARY_EPS band and
    # can itself fall through an edge the anchored cast closes.
    tp, tb = h.t.numpy()[hit], hb.t.numpy()[hit]
    np.testing.assert_allclose(tp, tb, rtol=1e-5)
    swapped = h.prim_id.numpy()[hit] != hb.prim_id.numpy()[hit]
    assert np.all(np.abs(tp - tb)[swapped]
                  <= 4e-6 * np.maximum(np.abs(tb[swapped]), 1.0))
    assert int(s.stack_drops) == 0


def test_stack_bound_and_forced_drops(terrain_scene):
    cs = terrain_scene.cluster
    rays = port_rays(*rand_rays_np(1024, seed=7, extent=8.0))
    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, cs)
    _, _, c_need = cluster_cast_plain(*args, kstack=cs.stack_need)
    assert int(c_need[1]) == 0         # the build-time bound is enough
    f_ref, i_ref, _ = cluster_cast_plain(*args)
    f1, i1, c1 = cluster_cast_plain(*args, kstack=1)
    assert int(c1[1]) > 0              # a forced small stack is reported
    assert not torch.equal(i1[2], i_ref[2])


def test_plain_chunking_is_invisible(terrain_scene):
    cs = terrain_scene.cluster
    rays = port_rays(*rand_rays_np(700, seed=10, extent=8.0))
    args = (rays.origin, rays.direction, rays.t_min, rays.t_max, cs)
    whole = cluster_cast_plain(*args)
    parts = cluster_cast_plain(*args, chunk=123)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain(terrain_scene):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    ps = build_scene_from_tri_array(
        np.concatenate([terrain_tris(96, extent=16.0)]), device=dev)
    rays = port_rays(*rand_rays_np(8192, seed=11, extent=8.0)).to(dev)
    for kw in ({}, {"any_hit": True}, {"kstack": 1}):
        args = (rays.origin, rays.direction, rays.t_min, rays.t_max,
                ps.cluster)
        k = cluster_cast_cuda(*args, **kw)
        p = cluster_cast_plain(*args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            assert torch.equal(a, b)
    h, _ = ps.cast_rays(rays)
    hb, _ = cast_rays_brute(rays, ps.tris)
    assert_parity(h, hb, atol=ANCHOR_ATOL)
