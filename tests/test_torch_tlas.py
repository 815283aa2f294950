"""PyTorch port: the instanced cluster TLAS — tables against the JAX build,
the plain cast against the JAX kernel in interpret mode (small scene) and
against the port's brute oracle over the flattened world triangles."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu.kernels.cluster_tlas import (  # noqa: E402
    build_cluster_tlas as jax_build_tlas,
)
from messyerraytracer_tpu.kernels.cluster_v2 import (  # noqa: E402
    cast_rays_cluster_tlas_v2 as jax_cast_tlas,
)

from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS  # noqa: E402
from messyerraytracer_tpu_torch.core.brute import (  # noqa: E402
    any_hit_brute,
    cast_rays_brute,
)
from messyerraytracer_tpu_torch.kernels.cluster_tlas import (  # noqa: E402
    ClusterTLAS,
    build_cluster_tlas,
    cluster_tlas_from_jax,
)
from messyerraytracer_tpu_torch.kernels.cluster_v2 import (  # noqa: E402
    cast_rays_cluster_tlas_v2,
)
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    ANCHOR_ATOL,
    assert_parity,
    assert_same_hits,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
)

TABLES = ("node_box", "node_child", "node_axis", "tri", "tri_prim",
          "tri_layers", "cl_anchor", "cl_count", "cl_aabb", "inst_cbase",
          "iprim", "iinv", "ifwd")


def xform(t, s=1.0):
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = np.eye(3) * s
    m[:, 3] = t
    return m


def small_instanced():
    """The JAX suite's instanced scene (test_cluster_v2.py:123-139)."""
    ms = [meshes.uv_sphere(1.0, 6, 12), meshes.box((1.0, 2.0, 1.0))]
    inst = [(0, xform((0, 0, 0))), (1, xform((-3, 0, 0), 1.2)),
            (0, xform((3, 0.5, -1), 0.5))]
    return ms, inst


def converted(jct):
    return cluster_tlas_from_jax(
        np.asarray(jct.nodes), np.asarray(jct.ablocks),
        np.asarray(jct.islab), np.asarray(jct.iprim), np.asarray(jct.iinv),
        np.asarray(jct.ifwd), tcap=jct.tcap, dummy_enc=jct.dummy_enc,
        stack_need=jct.stack_need, num_pairs=jct.num_pairs, device="cpu")


def test_tables_equal_converted_jax_tables():
    rng = np.random.default_rng(0)
    ms = [meshes.uv_sphere(1.0, 12, 24), meshes.box((1.0, 2.0, 1.0)),
          meshes.plane(6.0, subdiv=8)]
    inst = [(int(rng.integers(0, 3)),
             xform(rng.uniform(-6, 6, 3), rng.uniform(0.5, 1.5)))
            for _ in range(12)]
    mesh_layers = [None, np.full(12, 0b110, np.int32),
                   (np.arange(128) % 4).astype(np.int32)]
    inst_layers = [-1, 0b10, -1, 0b100] * 3      # several groups per mesh
    kw = dict(tcap=32, mesh_layers=mesh_layers, inst_layers=inst_layers)
    conv = converted(jax_build_tlas(ms, inst, **kw))
    pct = build_cluster_tlas(ms, inst, **kw, device="cpu")
    for f in TABLES:
        a, b = getattr(pct, f).numpy(), getattr(conv, f).numpy()
        assert a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for f in ("tcap", "dummy_enc", "num_clusters", "stack_need", "n_inst",
              "num_pairs"):
        assert getattr(pct, f) == getattr(conv, f), f


@pytest.fixture(scope="module")
def small():
    ms, inst = small_instanced()
    jct = jax_build_tlas(ms, inst, tcap=32)
    return jct, build_cluster_tlas(ms, inst, tcap=32, device="cpu")


def test_instanced_plain_matches_jax_interpret(small):
    jct, pct = small
    o, d = rand_rays_np(256, seed=6)
    hj, sj, occ_j, ij = jax_cast_tlas(jax_rays(o, d), jct)
    for ct in (pct, converted(jct)):
        hp, sp, occ_p, ip = cast_rays_cluster_tlas_v2(port_rays(o, d), ct)
        assert_same_hits(hp, hj)      # prims in the flattened numbering
        np.testing.assert_array_equal(ip.numpy(), np_of(ij))
        np.testing.assert_array_equal(occ_p.numpy(), np_of(occ_j))
        assert int(sp.hits) == int(sj.hits) > 0
        assert int(sp.stack_drops) == 0


def test_instanced_any_hit_matches_jax_interpret(small):
    jct, pct = small
    o, d = rand_rays_np(256, seed=7)
    _, _, occ_j, _ = jax_cast_tlas(jax_rays(o, d), jct, any_hit=True)
    _, _, occ_p, ip = cast_rays_cluster_tlas_v2(port_rays(o, d), pct,
                                                any_hit=True)
    np.testing.assert_array_equal(occ_p.numpy(), np_of(occ_j))
    assert ((ip.numpy() >= 0) == occ_p.numpy()).all()


@pytest.fixture(scope="module")
def tlas():
    """A port SceneTLAS: 3 meshes, 30 instances, some with layer masks."""
    rng = np.random.default_rng(1)
    t = SceneTLAS(device="cpu")
    ids = [t.add_mesh(meshes.uv_sphere(1.0, 16, 32)),
           t.add_mesh(meshes.box((1.4, 1.0, 1.2))),
           t.add_mesh(meshes.plane(16.0, subdiv=24),
                      layers=np.full(2 * 24 * 24, 0b11, np.int32))]
    t.add_instance(ids[2], xform((0, -1.0, 0)))
    for i in range(29):
        t.add_instance(ids[i % 2],
                       xform(rng.uniform(-6, 6, 3), rng.uniform(0.4, 1.3)),
                       layers=-1 if i % 3 else 0b01)
    t.build_tlas()
    t.build_instanced()
    return t


@pytest.mark.parametrize("query_mask", [-1, 0b10])
def test_instanced_matches_brute_over_world_tris(tlas, query_mask):
    o, d = rand_rays_np(2048, seed=8, extent=7.0)
    rays = port_rays(o, d)
    h, s, occ, inst = tlas.cast_rays_instanced(rays, query_mask)
    hb, _ = cast_rays_brute(rays, tlas.flat.tris, query_mask)
    # u, v to 1e-4 and t with ANCHOR_ATOL: rays start inside the scene
    assert_same_hits(h, hb, atol=1e-4, t_atol=ANCHOR_ATOL)
    assert int(s.stack_drops) == 0 and int(h.hit.sum()) > 200
    # instance ids agree with the flattened twin's numbering
    hf, _, inst_f = tlas.cast_rays(rays, query_mask)
    same = (h.prim_id == hf.prim_id).numpy()
    np.testing.assert_array_equal(inst.numpy()[same], inst_f.numpy()[same])
    np.testing.assert_array_equal(
        occ.numpy(), any_hit_brute(rays, tlas.flat.tris, query_mask).numpy())
    _, _, occ_a, _ = tlas.cast_rays_instanced(rays, query_mask, any_hit=True)
    np.testing.assert_array_equal(occ_a.numpy(), occ.numpy())


def test_world_tris_and_flat_twin_match_jax(tlas):
    from messyerraytracer_tpu.accel.tlas import SceneTLAS as JaxSceneTLAS

    jt = JaxSceneTLAS(backend="brute")
    for m in tlas.meshes:
        jt.add_mesh(m.tri_array, layers=m.layers_orig)
    for i in tlas.instances:
        jt.add_instance(i.blas_id, i.transform, i.layers)
    jt.build_tlas()
    np.testing.assert_array_equal(tlas._world_tris_np(), jt._world_tris_np())
    o, d = rand_rays_np(512, seed=9, extent=7.0)
    hj, _, ij = jt.cast_rays(jax_rays(o, d))
    hp, _, ip = tlas.cast_rays(port_rays(o, d))
    assert_parity(hp, hj, atol=ANCHOR_ATOL)
    same = np_of(hp.prim_id) == np_of(hj.prim_id)
    np.testing.assert_array_equal(np_of(ip)[same], np_of(ij)[same])


def test_unported_tlas_methods_raise(tlas):
    """Every SceneTLAS method is ported (the two-level casts since A.10,
    held against JAX in test_torch_tlas_frontier.py): each casts here and
    agrees with the instanced cast on the hit set."""
    o, d = rand_rays_np(256, seed=21, extent=7.0)
    r = port_rays(o, d)
    hi, _, _, ii = tlas.cast_rays_instanced(r)
    h2, i2 = tlas.cast_rays_two_level(r)
    hf, _, _, iff = tlas.cast_rays_two_level_fast(r)
    for h, i in ((h2, i2), (hf, iff)):
        assert_parity(h, hi, atol=ANCHOR_ATOL)
        same = np_of(h.prim_id) == np_of(hi.prim_id)
        np.testing.assert_array_equal(np_of(i)[same], np_of(ii)[same])
    # the renderer's view is ported (A.8): it casts the instanced tables
    view = tlas.instanced_scene()
    assert isinstance(tlas._ctlas, ClusterTLAS)
    assert view.cluster_tlas is tlas._ctlas
