"""PyTorch port: refits — BVH levels and ``refit_bvh``, the refresh of the
wide and cluster tables, ``RayScene.refit``, ``set_transforms`` and
``SceneTLAS.set_transform`` / ``refit_tlas``, and the service's refit.

Tolerances.  BVH boxes, levels, gathers, anchors and cluster boxes are exact
(min, max, gathers and a multiply by 0.5), so they are held bit for bit
against the JAX package.  The port re-derives triangle normals, the cluster
tables' anchored fields and the instanced pair boxes in unfused float32, one
operation at a time: each is held bit for bit against the port's own numpy
build math applied to the refit boxes and moved triangles.  XLA on the CPU
fuses some ``a*b - c*d`` and ``a*b + c`` into FMAs inside the JAX package's
jitted refits, so against JAX those values agree within ``FMA_ULPS`` ulps of
the largest magnitude in their column (a fused and an unfused product differ
by at most an ulp of each product; on values that cancel to near zero that
is many ulps of the result).  Casts compare by the bench.py parity rule, B1
(the cluster backend) with ``ANCHOR_ATOL``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from messyerraytracer_tpu.accel import bvh as jbvh  # noqa: E402
from messyerraytracer_tpu.accel.tlas import SceneTLAS as JaxTLAS  # noqa
from messyerraytracer_tpu.api import service as jsvc  # noqa: E402
from messyerraytracer_tpu.core.brute import (  # noqa: E402
    cast_rays_brute as jax_brute,
)
from messyerraytracer_tpu.core.types import (  # noqa: E402
    make_triangles as jax_triangles,
)
from messyerraytracer_tpu.dispatch.dispatcher import (  # noqa: E402
    RayDispatcher as JaxDispatcher,
)
from messyerraytracer_tpu.scene.scene import (  # noqa: E402
    build_scene_from_tri_array as jax_build,
)

from messyerraytracer_tpu_torch.accel import bvh as pbvh  # noqa: E402
from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS  # noqa: E402
from messyerraytracer_tpu_torch.api import service as psvc  # noqa: E402
from messyerraytracer_tpu_torch.core.brute import (  # noqa: E402
    any_hit_brute,
    cast_rays_brute,
)
from messyerraytracer_tpu_torch.core.geometry import (  # noqa: E402
    triangle_fields,
)
from messyerraytracer_tpu_torch.core.types import (  # noqa: E402
    make_triangles,
    triangle_fields_np,
)
from messyerraytracer_tpu_torch.dispatch.dispatcher import (  # noqa: E402
    RayDispatcher,
)
from messyerraytracer_tpu_torch.kernels import cluster as pcluster  # noqa
from messyerraytracer_tpu_torch.kernels import cluster_tlas as pctlas  # noqa
from messyerraytracer_tpu_torch.kernels import wide as pwide  # noqa: E402
from messyerraytracer_tpu_torch.scene.scene import (  # noqa: E402
    build_scene_from_tri_array,
)
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from messyerraytracer_tpu_torch.utils import trace  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    ANCHOR_ATOL,
    assert_parity,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
    small_tris,
)

FMA_ULPS = 4
CLUSTER_TABLES = ("node_box", "node_child", "node_axis", "tri", "tri_prim",
                  "tri_layers", "cl_anchor", "cl_count", "cl_aabb")
WIDE_TABLES = ("node_box", "node_child", "node_axis", "leaf_tri",
               "leaf_count", "slot_prim_id", "slot_layers", "slot_normal",
               "slot_tri")


def bits(x):
    """A float or int array (tensor, JAX or numpy) as its 32-bit pattern:
    equal bits, not equal values (NaN == NaN, -0 != +0)."""
    a = np.ascontiguousarray(np_of(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits(a, b, what=""):
    np.testing.assert_array_equal(bits(a), bits(b), err_msg=what)


def assert_near_fma(port, ref, what=""):
    """Within FMA_ULPS ulps of each last-axis column's largest magnitude."""
    p, r = np_of(port).astype(np.float64), np_of(ref).astype(np.float64)
    cols = p.reshape(-1, p.shape[-1])
    scale = np.abs(cols).max(axis=0)
    tol = FMA_ULPS * np.finfo(np.float32).eps * np.maximum(scale, 1e-30)
    bad = np.abs(p - r) > tol
    assert not bad.any(), (what, np.abs(p - r).max(), tol)


def moved(tris, seed):
    """``tris`` displaced smoothly (a sine in y) plus seeded noise."""
    rng = np.random.default_rng(seed)
    m = tris.copy()
    m[:, :, 1] += 0.3 * np.sin(1.7 * m[:, :, 0]) * np.cos(m[:, :, 2])
    m += rng.uniform(-0.05, 0.05, m.shape).astype(np.float32)
    return m.astype(np.float32)


def xform(t, s=1.0, yaw=0.0):
    """A (3, 4) float32 [R | t]: a scale, then a rotation about y."""
    c, n = np.cos(yaw), np.sin(yaw)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = np.array([[c, 0, n], [0, 1, 0], [-n, 0, c]]) * s
    m[:, 3] = t
    return m


# ---------------------------------------------------------------------------
# the flat scene: one JAX refit (backend cluster) shared by the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flat():
    tris = small_tris()
    mv = moved(tris, 1)
    js = jax_build(tris, backend="cluster")
    jr = js.refit(mv[:, 0], mv[:, 1], mv[:, 2])
    ps = build_scene_from_tri_array(tris, device="cpu")
    pr = ps.refit(mv[:, 0], mv[:, 1], mv[:, 2])
    return {"tris": tris, "moved": mv, "js": js, "jr": jr, "ps": ps,
            "pr": pr}


def test_levels_equal_jax(flat):
    """Per-depth node lists: bit-equal to JAX's for the triangle BVH and a
    singleton-leaf tree over boxes; every node in exactly one level, and
    each internal node's children one level deeper."""
    rng = np.random.default_rng(2)
    lo = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (300, 3)).astype(np.float32)
    pairs = [(flat["ps"].bvh, flat["js"].bvh),
             (pbvh.build_bvh_over_aabbs(lo, hi, (lo + hi) * 0.5, 1,
                                        device="cpu"),
              jbvh.build_bvh_over_aabbs(lo, hi, (lo + hi) * 0.5, 1))]
    for pb, jb in pairs:
        assert len(pb.levels) == len(jb.levels) > 3
        depth = np.full(pb.num_nodes, -1)
        for d, (lp, lj) in enumerate(zip(pb.levels, jb.levels)):
            assert lp.dtype == torch.int32
            assert_bits(lp, lj)
            assert (depth[lp.numpy()] == -1).all()
            depth[lp.numpy()] = d
        assert (depth >= 0).all()
        lf, cnt = pb.host["left_first"], pb.host["count"]
        inner = np.nonzero(cnt == 0)[0]
        assert (depth[inner + 1] == depth[inner] + 1).all()
        assert (depth[lf[inner]] == depth[inner] + 1).all()


@pytest.mark.parametrize("leaf", [4, 1])
def test_refit_bvh_equal_jax(leaf):
    """``refit_bvh`` on the same per-slot boxes: every node box bit-equal
    to the JAX package's refit (4-triangle leaves, and the pair tree's
    singleton leaves); a new BVH without a host copy, the old one kept."""
    rng = np.random.default_rng(3 + leaf)
    lo = rng.uniform(-5, 5, (257, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (257, 3)).astype(np.float32)
    pb = pbvh.build_bvh_over_aabbs(lo, hi, (lo + hi) * 0.5, leaf,
                                   device="cpu")
    jb = jbvh.build_bvh_over_aabbs(lo, hi, (lo + hi) * 0.5, leaf)
    before = pb.aabb_min.clone()
    nlo = (lo + rng.normal(0, 0.3, lo.shape)).astype(np.float32)
    nhi = (nlo + rng.uniform(0, 2, lo.shape)).astype(np.float32)
    perm = pb.host["tri_order"]
    pr = pbvh.refit_bvh(pb, torch.from_numpy(nlo[perm]),
                        torch.from_numpy(nhi[perm]))
    jr = jax.jit(jbvh.refit_bvh)(jb, nlo[perm], nhi[perm])
    assert_bits(pr.aabb_min, jr.aabb_min)
    assert_bits(pr.aabb_max, jr.aabb_max)
    assert pr.host is None and pb.host is not None
    assert torch.equal(pb.aabb_min, before)
    assert pr.levels is pb.levels and pr.tri_order is pb.tri_order
    # the root holds every moved box
    np.testing.assert_array_equal(pr.aabb_min[0].numpy(), nlo.min(axis=0))
    np.testing.assert_array_equal(pr.aabb_max[0].numpy(), nhi.max(axis=0))


def test_sah_cost_matches_jax(flat):
    for pb, jb in ((flat["ps"].bvh, flat["js"].bvh),
                   (flat["pr"].bvh, flat["jr"].bvh)):
        assert pbvh.sah_cost(pb) == pytest.approx(jbvh.sah_cost(jb),
                                                  rel=1e-6)


def test_triangle_fields_bit_equal_numpy_build():
    """The device re-derivation equals the numpy build's fields bit for
    bit, degenerate triangles (zero normal) and a wide range of scales
    included."""
    rng = np.random.default_rng(4)
    v = (rng.standard_normal((20000, 3, 3))
         * 10.0 ** rng.uniform(-3, 3, (20000, 1, 1))).astype(np.float32)
    v[:7, 1] = v[:7, 0]
    v[7:9, 2] = v[7:9, 1]
    ref = triangle_fields_np(v[:, 0], v[:, 1], v[:, 2])
    got = triangle_fields(*(torch.from_numpy(v[:, k].copy())
                            for k in range(3)))
    for name, a, b in zip(("v0", "e1", "e2", "normal"), got, ref):
        assert_bits(a, b, name)


def child_boxes_np(child, amin, amax):
    """The build's node boxes in numpy: each child slot's binary node box,
    NaN where absent, through the build's child -> node table (the
    topology a refit keeps; a new collapse over moved boxes could pick
    other children)."""
    ck = np.maximum(child, 0)
    box = np.concatenate([amin[ck], amax[ck]], axis=-1).astype(np.float32)
    box[child < 0] = np.nan
    return box


def slot_fields_np(mv, perm):
    """The numpy build's slot-ordered triangle fields of vertices ``mv``."""
    return triangle_fields_np(mv[perm, 0], mv[perm, 1], mv[perm, 2])


@pytest.mark.parametrize("layout", ["cluster", "pallas8", "pallas2"])
def test_refit_tables_equal_build_math(flat, layout):
    """After ``RayScene.refit`` every table equals the port's numpy build
    math applied to the refit BVH and the moved triangles, bit for bit,
    with the build's upper-tree topology (node boxes gathered through its
    child -> node table); the wide scene's cached quantized boxes are
    dropped and recomputed."""
    tris, mv = flat["tris"], flat["moved"]
    if layout == "cluster":
        ps, pr = flat["ps"], flat["pr"]
    else:
        branching = int(layout[-1])
        ps = build_scene_from_tri_array(tris, backend="pallas",
                                        branching=branching, device="cpu")
        if branching == 8:
            q_old = ps.wide.quantized()
        pr = ps.refit(mv[:, 0], mv[:, 1], mv[:, 2])
    perm = ps.bvh.host["tri_order"]
    v0, e1, e2, nrm = slot_fields_np(mv, perm)
    for name, ref in (("v0", v0), ("edge1", e1), ("edge2", e2),
                      ("normal", nrm)):
        assert_bits(getattr(pr.tris, name), ref, name)
    assert pr.bvh.host is None
    amin, amax = pr.bvh.aabb_min.numpy(), pr.bvh.aabb_max.numpy()
    lf, cnt = ps.bvh.host["left_first"], ps.bvh.host["count"]
    host = (v0, e1, e2, nrm, np_of(ps.tris.prim_id), np_of(ps.tris.layers))
    if layout == "cluster":
        ref, _ = pcluster._cluster_tables_np(amin, amax, lf, cnt, host,
                                             pr.cluster.tcap)
        for k in ("tri", "tri_prim", "tri_layers", "cl_anchor", "cl_count",
                  "cl_aabb", "croots", "slot_map", "cvalid"):
            assert_bits(getattr(pr.cluster, k), ref[k], k)
        for k in ("node_child", "node_axis", "child_node"):
            assert_bits(getattr(pr.cluster, k), getattr(ps.cluster, k), k)
        assert_bits(pr.cluster.node_box, child_boxes_np(
            ps.cluster.child_node.numpy(), amin, amax))
        assert pr.cluster.stack_need == ps.cluster.stack_need
    else:
        builder = (pwide.build_wide8_scene if branching == 8
                   else pwide.build_wide_scene)
        ref = builder(pr.bvh, None, _np=host, device="cpu")
        for k in ("leaf_tri", "leaf_count", "slot_prim_id", "slot_layers",
                  "slot_normal", "slot_tri"):
            assert_bits(getattr(pr.wide, k), getattr(ref, k), k)
        for k in ("node_child", "node_axis", "child_node"):
            assert_bits(getattr(pr.wide, k), getattr(ps.wide, k), k)
        assert_bits(pr.wide.node_box, child_boxes_np(
            ps.wide.child_node.numpy(), amin, amax))
        if branching == 8:
            assert pr.wide._q is None
            fresh = dataclasses.replace(ps.wide,
                                        node_box=pr.wide.node_box.clone(),
                                        _q=None)
            for a, b in zip(pr.wide.quantized(), fresh.quantized()):
                assert_bits(a, b)
            assert not torch.equal(pr.wide.quantized()[0], q_old[0])


def converted_cluster(jcs):
    return pcluster.cluster_scene_from_jax(
        np.asarray(jcs.nodes), np.asarray(jcs.ablocks), tcap=jcs.tcap,
        dummy_enc=jcs.dummy_enc, num_clusters=jcs.num_clusters,
        stack_need=jcs.stack_need, device="cpu")


def test_refit_tables_near_jax(flat):
    """Against the JAX package's refit: BVH boxes, edges, node boxes,
    anchors and cluster boxes bit for bit; normals and the anchored
    fields within FMA_ULPS (module docstring)."""
    pr, jr = flat["pr"], flat["jr"]
    for f in ("aabb_min", "aabb_max"):
        assert_bits(getattr(pr.bvh, f), getattr(jr.bvh, f), f)
    for f in ("v0", "edge1", "edge2", "prim_id", "layers"):
        assert_bits(getattr(pr.tris, f), getattr(jr.tris, f), f)
    assert_near_fma(pr.tris.normal, jr.tris.normal, "normal")
    jc = converted_cluster(jr.cluster)
    for k in ("node_box", "node_child", "node_axis", "tri_prim",
              "tri_layers", "cl_anchor", "cl_count", "cl_aabb"):
        assert_bits(getattr(pr.cluster, k), getattr(jc, k), k)
    assert_near_fma(pr.cluster.tri, jc.tri, "tri")


@pytest.mark.parametrize("layout", ["cluster", "pallas8", "pallas2", "jnp"])
def test_casts_after_refit(flat, layout):
    """Casts through the refit scene against the brute oracle over the
    moved triangles and against the JAX package's cast over its own refit
    scene (its per-ray BVH traversal), closest and any hit."""
    tris, mv = flat["tris"], flat["moved"]
    if layout == "cluster":
        pr = flat["pr"]
    else:
        backend = "jnp" if layout == "jnp" else "pallas"
        pr = build_scene_from_tri_array(
            tris, backend=backend, branching=8 if layout != "pallas2" else 2,
            device="cpu").refit(mv[:, 0], mv[:, 1], mv[:, 2])
    o, d = rand_rays_np(1024, seed=5)
    rays = port_rays(o, d)
    atol = ANCHOR_ATOL if layout == "cluster" else 0.0
    hp, sp = pr.cast_rays(rays)
    assert int(sp.stack_drops) == 0
    ref = make_triangles(mv[:, 0], mv[:, 1], mv[:, 2], device="cpu")
    hb, _ = cast_rays_brute(rays, ref)
    assert_parity(hp, hb, atol=atol)
    assert torch.equal(pr.any_hit_rays(rays), any_hit_brute(rays, ref))
    hj, _ = dataclasses.replace(flat["jr"], backend="jnp").cast_rays(
        jax_rays(o, d))
    assert_parity(hp, hj, atol=atol)
    assert int(hp.hit.sum()) > 100


def test_refit_is_functional(flat):
    """A refit writes no tensor of the old scene, keeps its host copy and
    gives the same scene from tensors as from numpy; the dispatcher's
    per-BVH caches keep the old scene's bounds for the old scene."""
    tris, mv = flat["tris"], flat["moved"]
    ps = build_scene_from_tri_array(tris, device="cpu")
    snap = {f: getattr(ps.cluster, f).clone() for f in CLUSTER_TABLES}
    snap.update(v0=ps.tris.v0.clone(), amin=ps.bvh.aabb_min.clone())
    old_disp = RayDispatcher(ps)
    old_bounds = old_disp._scene_bounds(ps)
    pr = ps.refit(*(torch.from_numpy(mv[:, k].copy()) for k in range(3)))
    for f in CLUSTER_TABLES:
        assert_bits(getattr(ps.cluster, f), snap[f], f)
        assert_bits(getattr(pr.cluster, f), getattr(flat["pr"].cluster, f))
    assert torch.equal(ps.tris.v0, snap["v0"])
    assert torch.equal(ps.bvh.aabb_min, snap["amin"])
    assert ps.bvh.host is not None and pr.bvh.host is None
    assert pr.bvh is not ps.bvh and pr.cluster is not ps.cluster
    assert old_disp._scene_bounds(ps) is old_bounds
    lo, hi = RayDispatcher(pr)._scene_bounds(pr)
    assert not torch.equal(lo, old_bounds[0])
    # a refit of a refit reads no host copy; back at the build's vertices
    # its boxes are those of v0, v0 + e1, v0 + e2 (the build boxed v1, v2)
    back = pr.refit(tris[:, 0], tris[:, 1], tris[:, 2])
    assert_bits(back.tris.v0, snap["v0"])
    np.testing.assert_allclose(back.bvh.aabb_min.numpy(),
                               snap["amin"].numpy(), atol=1e-6)


def test_dispatcher_bounds_after_refit_equal_jax(flat):
    """The Morton sort of a refit scene reads the refit root box, as the
    JAX dispatcher does; sorted and unsorted casts agree bit for bit."""
    pr, jr = flat["pr"], flat["jr"]
    pd, jd = RayDispatcher(pr), JaxDispatcher(jr)
    for a, b in zip(pd._scene_bounds(pr), jd._scene_bounds(jr)):
        assert_bits(a, b)
    assert pd._scene_diag(pr) == pytest.approx(jd._scene_diag(jr), rel=1e-6)
    o, d = rand_rays_np(600, seed=6)
    rays = port_rays(o, d)
    hs, _ = pd.cast_rays(rays)
    hu, _ = pd.cast_rays(rays, coherent=True)
    for f in ("t", "prim_id", "u", "v", "normal", "hit_layers"):
        assert torch.equal(getattr(hs, f), getattr(hu, f)), f


def test_converted_tables_refuse_refresh(flat, instanced):
    """Tables converted from the JAX package have no refresh tables: the
    refits say so instead of casting stale boxes."""
    pr = flat["pr"]
    jc = converted_cluster(flat["js"].cluster)
    with pytest.raises(ValueError, match="converted"):
        pcluster.refresh_cluster_scene(jc, pr.bvh, pr.tris)
    nodes = np.zeros((1, 128), np.float32)
    nodes[0, :48] = np.nan                    # one node, every child absent
    w = pwide.wide_scene_from_jax(
        nodes, np.zeros((1, 128), np.float32),
        np.zeros(4, np.int32), np.zeros(4, np.int32),
        np.zeros((4, 3), np.float32), np.zeros(4, np.int32), branching=8,
        dummy_enc=2, dummy_leaf=1, device="cpu")
    with pytest.raises(ValueError, match="converted"):
        pwide.refresh_wide_scene(w, pr.bvh, pr.tris)
    ct = dataclasses.replace(instanced[0]._ctlas, pair_bvh=None)
    with pytest.raises(ValueError, match="converted"):
        pctlas.set_transforms(ct, [np.eye(4)] * ct.n_inst)


# ---------------------------------------------------------------------------
# instanced: one JAX set_transforms and one JAX refit_tlas, shared
# ---------------------------------------------------------------------------

def inst_spec():
    ms = [meshes.uv_sphere(1.0, 6, 12), meshes.box((1.0, 2.0, 1.0)),
          meshes.plane(14.0, y=-1.5, subdiv=6)]
    inst = [(2, xform((0, 0, 0)))]
    inst += [(i % 2, xform((2.5 * (i % 4) - 4.0, 0.3 * i, -2.0 * (i // 4)),
                           0.6 + 0.1 * i, 0.4 * i)) for i in range(8)]
    return ms, inst


# instance -> new transform: a lift, a spin and a move with a new scale
MOVES = {1: xform((-1.5, 1.3, 0.0), 0.7, 0.4),
         4: xform((0.5, 1.2, -2.0), 1.0, 2.1),
         8: xform((3.0, 0.5, 1.0), 0.5, -0.9)}


def fill(t, ms, inst):
    ids = [t.add_mesh(m) for m in ms]
    for mesh, tf in inst:
        t.add_instance(ids[mesh], tf)
    t.build_tlas()
    return t


@pytest.fixture(scope="module")
def instanced():
    """Port and JAX SceneTLAS over the same meshes and instances, both with
    their instanced tables and flat twins built, then MOVES applied; plus
    the port's tables from before the moves."""
    ms, inst = inst_spec()
    p = fill(SceneTLAS(device="cpu"), ms, inst)
    j = fill(JaxTLAS(backend="cluster"), ms, inst)
    for t in (p, j):
        t.build_instanced()
        t.flat                                    # noqa: B018 (builds it)
    before = p._ctlas
    for k, tf in MOVES.items():
        p.set_transform(k, tf)
        j.set_transform(k, tf)
    return p, j, before


def world_triangles(t, device=None):
    w = t._world_tris_np()
    if device is None:
        return jax_triangles(w[:, 0], w[:, 1], w[:, 2])
    return make_triangles(w[:, 0], w[:, 1], w[:, 2], device=device)


def test_set_transforms_tables(instanced):
    """``set_transforms``: iinv / ifwd bit-equal to JAX's; the pair boxes
    bit-equal to the numpy build twin on the new rows; the pair tree's
    boxes bit-equal to JAX's ``refit_bvh`` on them; node boxes the build's
    gather of those; JAX's nodes within FMA_ULPS (its jitted corner
    transform); the object-space tables and the old tables unchanged."""
    p, j, before = instanced
    ct, jct = p._ctlas, j._ctlas
    assert ct is not before
    jc = pctlas.cluster_tlas_from_jax(
        np.asarray(jct.nodes), np.asarray(jct.ablocks),
        np.asarray(jct.islab), np.asarray(jct.iprim), np.asarray(jct.iinv),
        np.asarray(jct.ifwd), tcap=jct.tcap, dummy_enc=jct.dummy_enc,
        stack_need=jct.stack_need, num_pairs=jct.num_pairs, device="cpu")
    for k in ("iinv", "ifwd", "node_child", "node_axis", "tri", "cl_anchor",
              "cl_aabb", "inst_cbase", "iprim"):
        assert_bits(getattr(ct, k), getattr(jc, k), k)
    assert_near_fma(ct.node_box.reshape(-1, 6)[ct.node_child.reshape(-1)
                                               >= 0],
                    jc.node_box.reshape(-1, 6)[jc.node_child.reshape(-1)
                                               >= 0], "node_box")
    fwd = pctlas._fwd_rows([i.transform for i in p.instances])
    pinst = ct.pair_inst.numpy()
    wmin, wmax = pctlas._pair_world_aabbs_np(ct.pair_obj_min.numpy(),
                                             ct.pair_obj_max.numpy(),
                                             fwd[pinst])
    perm = ct.pair_bvh.tri_order.numpy()
    jref = jax.jit(jbvh.refit_bvh)(jct.pair_bvh, wmin[perm], wmax[perm])
    assert_bits(ct.pair_bvh.aabb_min, jref.aabb_min)
    assert_bits(ct.pair_bvh.aabb_max, jref.aabb_max)
    assert_bits(ct.node_box, child_boxes_np(
        before.child_node.numpy(), np_of(jref.aabb_min),
        np_of(jref.aabb_max)))
    lo, hi = ct.pair_bounds
    assert_bits(lo, wmin.min(axis=0))
    assert_bits(hi, wmax.max(axis=0))
    assert not torch.equal(ct.node_box, before.node_box)
    assert before.pair_bvh.host is not None and ct.pair_bvh.host is None
    view = p.instanced_scene()
    assert torch.equal(view.bounds[0], lo) and view.cluster_tlas is ct


# instance -> pose steps, and how many rows each step's inverse redoes
ROW_STEPS = {
    "same_instance_twice": [({1: MOVES[1]}, 1), ({1: MOVES[4]}, 1)],
    "back_to_an_earlier_pose": [({4: MOVES[4]}, 1), ({4: "rest"}, 1)],
    "no_op": [({2: "rest"}, 0)],
    "three_at_once": [(MOVES, 3), ({8: MOVES[8]}, 0)],
}


@pytest.mark.parametrize("case", sorted(ROW_STEPS))
def test_incremental_rows_equal_full_recompute(instanced, case):
    """``set_transforms`` redoes the float64 inverse only for the rows
    whose transform changed (``refit.inverse_rows`` counts them), and after
    each step its row table, its inverse tables and the transforms it
    keeps equal a full ``_inst_tables`` / ``_fwd_rows`` recompute bit for
    bit; a step that changes no transform leaves the node boxes as they
    were."""
    _, _, before = instanced
    _, inst = inst_spec()
    rest = [tf for _, tf in inst]
    ts, ct = list(rest), before
    for poses, redone in ROW_STEPS[case]:
        for k, tf in poses.items():
            ts[k] = rest[k] if isinstance(tf, str) else tf
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            new = pctlas.set_transforms(ct, list(ts))
        assert trace.counters()["refit.inverse_rows"] == redone
        iinv, ifwd = pctlas._inst_tables(ts)
        assert_bits(new.inst_rows, np.concatenate(
            [pctlas._fwd_rows(ts), iinv[:, :12], ifwd], axis=1))
        assert_bits(new.inst_mat.view(np.int64),
                    np.stack([pctlas._to_mat34(t).reshape(-1)
                              for t in ts]).view(np.int64))
        assert_bits(new.iinv, iinv[:, :12])
        assert_bits(new.ifwd, ifwd)
        if redone == 0:
            assert_bits(new.node_box, ct.node_box)
        ct = new
    trace.reset()


def _root_parent(ct):
    parent = ct.pair_parent.numpy()
    assert parent[0] == -1
    assert (parent[1:] >= 0).all()


def _children_point_back(ct):
    parent = ct.pair_parent.numpy()
    lf, cnt = ct.pair_bvh.left_first.numpy(), ct.pair_bvh.count.numpy()
    inner = np.flatnonzero(cnt == 0)
    assert inner.size > 0
    np.testing.assert_array_equal(parent[inner + 1], inner)
    np.testing.assert_array_equal(parent[lf[inner]], inner)
    assert np.bincount(parent[1:], minlength=len(cnt))[inner].tolist() \
        == [2] * inner.size


def _slots_once(ct):
    kids, slot = ct.child_node.numpy().reshape(-1), ct.pair_slot.numpy()
    present = np.flatnonzero(kids >= 0)
    np.testing.assert_array_equal(slot[kids[present]], present)
    assert (slot >= 0).sum() == present.size
    held = np.flatnonzero(slot >= 0)
    np.testing.assert_array_equal(kids[slot[held]], held)
    assert slot[0] == -1


REFIT_TABLES = {"root_parent": _root_parent,
                "children_point_back": _children_point_back,
                "slots_once": _slots_once}


@pytest.mark.parametrize("case", sorted(REFIT_TABLES))
def test_pair_refit_tables(instanced, case):
    """The build's tables of the refit kernel: the root's parent is -1 and
    every other node has one; each internal node's two children point
    back to it; each present ``child_node`` slot maps to its node and back
    exactly once, absent slots and the root to none; the arrival counters
    start at 0."""
    _, _, before = instanced
    REFIT_TABLES[case](before)
    assert not before.pair_arrivals.any()


def test_refit_kernel_wrapper_refuses_cpu(instanced):
    """CPU tables take the plain version (no launch is counted); the
    kernel's wrapper refuses CPU tensors, and ``set_transforms`` refuses a
    transform list of the wrong length."""
    p, _, before = instanced
    launches = pctlas.cuda_library.launches
    pctlas.set_transforms(before, [i.transform for i in p.instances])
    assert pctlas.cuda_library.launches == launches
    rows = torch.as_tensor(before.inst_rows)
    with pytest.raises(ValueError, match="CUDA"):
        pctlas.refit_pairs_cuda(before, rows)
    with pytest.raises(ValueError, match="instances"):
        pctlas.set_transforms(before, [np.eye(4)])


@pytest.mark.parametrize("query_mask", [-1, 0b10])
def test_set_transform_casts(instanced, query_mask):
    """After ``set_transform`` the instanced cast (B1's plain version)
    agrees with the brute oracle over the moved world triangles and with
    the JAX package's brute over its own moved world triangles; instance
    ids follow the flattened numbering."""
    p, j, _ = instanced
    o, d = rand_rays_np(1024, seed=7, extent=6.0)
    rays = port_rays(o, d)
    hi, si, occ, ii = p.cast_rays_instanced(rays, query_mask=query_mask)
    assert int(si.stack_drops) == 0
    hb, _ = cast_rays_brute(rays, world_triangles(p, "cpu"), query_mask)
    hj, _ = jax_brute(jax_rays(o, d), world_triangles(j), query_mask)
    same = assert_parity(hi, hb, atol=ANCHOR_ATOL)
    assert_parity(hi, hj, atol=ANCHOR_ATOL)
    pid = np_of(hi.prim_id)
    want = np.where(pid >= 0, p._tri_inst[np.maximum(pid, 0)], -1)
    np.testing.assert_array_equal(np_of(ii)[same], want[same])
    assert torch.equal(occ, hb.hit)
    assert bool(torch.isin(torch.tensor(list(MOVES)), ii).all())


def test_flat_twin_staleness_matches_jax(instanced):
    """The two-step contract of both packages, step by step: after
    ``set_transform`` a twin built before it still casts the old
    transforms; ``refit_tlas`` moves it; a twin first built after the
    update reads the new transforms.  Each step's twin triangles cast
    like JAX's (brute over each package's twin), and the refit twin's
    cluster tables cast by parity with brute."""
    p, j, _ = instanced
    ms, inst = inst_spec()
    o, d = rand_rays_np(800, seed=8, extent=6.0)
    rays, jr = port_rays(o, d), jax_rays(o, d)
    old = world_triangles(fill(SceneTLAS(device="cpu"), ms, inst), "cpu")

    def brute(scene_tris, jax_side=False):
        if jax_side:
            return jax_brute(jr, scene_tris)[0]
        return cast_rays_brute(rays, scene_tris)[0]

    # stale: both twins were built before the moves
    hp, hj = brute(p.flat.tris), brute(j.flat.tris, True)
    assert_parity(hp, hj)
    assert_parity(hp, brute(old))
    # a twin first built after the moves reads them
    late = fill(SceneTLAS(device="cpu"), ms, inst)
    for k, tf in MOVES.items():
        late.set_transform(k, tf)
    hn = brute(world_triangles(p, "cpu"))
    assert_parity(brute(late.flat.tris), hn)
    assert not torch.equal(hn.prim_id, hp.prim_id)
    # refit: both twins move
    p.refit_tlas()
    j.refit_tlas()
    hp2, hj2 = brute(p.flat.tris), brute(j.flat.tris, True)
    assert_parity(hp2, hj2)
    assert_parity(hp2, hn)
    hc, sc = p.flat.cast_rays(rays)
    assert int(sc.stack_drops) == 0
    assert_parity(hc, hn, atol=ANCHOR_ATOL)
    assert p.flat.bvh.host is None and p.flat.cluster.croots is not None


def test_service_set_transform_and_refit_equal_jax():
    """The service: ``set_transform`` then ``refit`` — single rays equal to
    the JAX service's (its brute backend) by the parity rule, a batch
    sorted == unsorted bit for bit and by parity with brute over the
    moved world; a cleared service raises until built."""
    ms, inst = inst_spec()
    port = psvc.RayTracerService(device="cpu")
    jax_svc = jsvc.RayTracerService(backend="brute")
    for svc in (port, jax_svc):
        first = {}
        for mesh, tf in inst:
            if mesh in first:
                svc.add_instance(first[mesh], tf)
            else:
                svc.register_mesh(ms[mesh], tf)
                first[mesh] = len(svc.tlas.meshes) - 1
        svc.build()
        for k, tf in MOVES.items():
            svc.set_transform(k, tf)
        svc.refit()
    # probes away from the plane's grid lines (no shared-edge ties)
    for o, d in (((0.3, 6.0, 0.7), (0, -1, 0)), ((3.1, 5.0, 1.3), (0, -1, 0)),
                 ((0.45, 1.2, 6.0), (0, 0, -1)),
                 ((-6.0, 1.1, -2.2), (1, 0, 0))):
        a, b = port.cast_ray(o, d), jax_svc.cast_ray(o, d)
        assert a["hit"] == b["hit"]
        assert (a["prim_id"], a["instance_id"]) == (b["prim_id"],
                                                    b["instance_id"])
        if a["hit"]:
            assert a["distance"] == pytest.approx(b["distance"], rel=1e-5)
    o, d = rand_rays_np(700, seed=9, extent=6.0)
    rays = port_rays(o, d)
    hs, ss = port.cast_rays_batch(rays)
    hu, _ = port.cast_rays_batch(rays, coherent=True)
    for f in ("t", "prim_id", "u", "v", "normal", "hit_layers"):
        assert torch.equal(getattr(hs, f), getattr(hu, f)), f
    assert int(ss.stack_drops) == 0
    hb, _ = cast_rays_brute(rays, world_triangles(port.tlas, "cpu"))
    assert_parity(hs, hb, atol=ANCHOR_ATOL)
    port.clear_scene()
    with pytest.raises(RuntimeError, match="build"):
        port.cast_ray((0, 0, 4), (0, 0, -1))


# three consecutive moves for the refit kernel: a lift, a half-box turned
# about y with a -0.0 translation, so that its world box's max x is a tie of
# -0.0 and +0.0 corners (the min / max semantics), and the lift undone
HALF_BOX = meshes.box((1.0, 2.0, 1.0), center=(0.5, 0.0, 0.0))   # x in [0, 1]
TURN = np.array([[-1, 0, 0, -0.0], [0, 1, 0, 2.0], [0, 0, -1, 0.0]],
                np.float32)
KERNEL_STEPS = ({2: xform((-4.0, 1.0, 0.0), 1.0, 0.3)}, {9: TURN},
                {2: "rest"})


def _tables(ct):
    return {"aabb_min": ct.pair_bvh.aabb_min, "aabb_max": ct.pair_bvh.aabb_max,
            "node_box": ct.node_box, "iinv": ct.iinv, "ifwd": ct.ifwd}


@pytest.mark.gpu
def test_refits_on_card_equal_cpu():
    """The refits on the card give the CPU's tables bit for bit: flat
    (cluster and 8-wide), instanced and the flat twin.  Then three
    consecutive ``set_transforms`` on the card, one with a signed-zero
    tie: each launches the refit kernel once and opens no level sweep, its
    tables equal the plain version's on the card bit for bit (NaN slots
    included; the arrival counters came back to 0), and the tables it
    started from are unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tris, mv = small_tris(), moved(small_tris(), 1)
    for backend in ("cluster", "pallas"):
        out = [build_scene_from_tri_array(tris, backend=backend, device=dev)
               .refit(mv[:, 0], mv[:, 1], mv[:, 2])
               for dev in ("cpu", "cuda")]
        tabs = out[0].cluster if backend == "cluster" else out[0].wide
        names = CLUSTER_TABLES if backend == "cluster" else WIDE_TABLES
        for k in names:
            assert_bits(getattr(
                out[1].cluster if backend == "cluster" else out[1].wide, k),
                getattr(tabs, k), k)
        for f in ("aabb_min", "aabb_max"):
            assert_bits(getattr(out[1].bvh, f), getattr(out[0].bvh, f))
    ms, inst = inst_spec()
    ts = []
    for dev in ("cpu", "cuda"):
        t = fill(SceneTLAS(device=dev), ms, inst)
        t.build_instanced()
        t.flat                                    # noqa: B018 (builds it)
        for k, tf in MOVES.items():
            t.set_transform(k, tf)
        t.refit_tlas()
        ts.append(t)
    for k in ("node_box", "iinv", "ifwd"):
        assert_bits(getattr(ts[1]._ctlas, k), getattr(ts[0]._ctlas, k), k)
    for k in CLUSTER_TABLES:
        assert_bits(getattr(ts[1].flat.cluster, k),
                    getattr(ts[0].flat.cluster, k), k)

    ms, inst = inst_spec()
    ms, inst = ms + [HALF_BOX], inst + [(3, xform((5.0, 0.0, 3.0)))]
    rest = [tf for _, tf in inst]
    ct = pctlas.build_cluster_tlas(ms, inst, device="cuda")
    tfs = list(rest)
    for step in KERNEL_STEPS:
        for k, tf in step.items():
            tfs[k] = rest[k] if isinstance(tf, str) else tf
        old = {k: v.clone() for k, v in _tables(ct).items()}
        launches = pctlas.cuda_library.launches
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            new = pctlas.set_transforms(ct, list(tfs))
        names = [e.name for e in prof.events()]
        assert names.count("refit.kernel") == 1
        assert not {"bvh.level", "refit.corner"} & set(names)
        assert pctlas.cuda_library.launches == launches + 1
        bvh, node_box, iinv, ifwd = pctlas._refit_pairs_plain(
            ct, torch.as_tensor(new.inst_rows, device="cuda"))
        plain = {"aabb_min": bvh.aabb_min, "aabb_max": bvh.aabb_max,
                 "node_box": node_box, "iinv": iinv, "ifwd": ifwd}
        for k, v in _tables(new).items():
            assert_bits(v, plain[k], k)
        for k, v in _tables(ct).items():
            assert_bits(v, old[k], k)
        assert not new.pair_arrivals.any()
        if step is KERNEL_STEPS[1]:
            assert bool((plain["aabb_max"][:, 0] == 0).any())
        ct = new
