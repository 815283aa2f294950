"""PyTorch port: the frontier backends (accel/frontier.py) against the JAX
package's.

The tables are held equal array for array; the casts run on identical
tables (the JAX tables converted by ``frontier_scene_from_jax``) and are
held by the bench.py parity rule, with ``occluded``, the per-ray
counters, normals and layers exact.  Against the port's own brute oracle,
which does the same float32 Moller-Trumbore one operation at a time, the
cast is bit-equal wherever both pick the same triangle.  Then what reaches the frontier
backend: RayScene's lazy tables, the debug heatmaps, a service submit and
a checkpoint."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu.accel import frontier as jfr  # noqa: E402
from messyerraytracer_tpu.api import service as jsvc  # noqa: E402
from messyerraytracer_tpu.debug import debug as jdebug  # noqa: E402
from messyerraytracer_tpu.scene import serialize as jser  # noqa: E402
from messyerraytracer_tpu.scene.scene import (  # noqa: E402
    build_scene_from_tri_array as jax_build,
)

from messyerraytracer_tpu_torch.accel import frontier as pfr  # noqa: E402
from messyerraytracer_tpu_torch.accel.bvh import _bvh_host  # noqa: E402
from messyerraytracer_tpu_torch.api import service as psvc  # noqa: E402
from messyerraytracer_tpu_torch.core.brute import (  # noqa: E402
    any_hit_brute,
    cast_rays_brute,
)
from messyerraytracer_tpu_torch.debug import debug as pdebug  # noqa: E402
from messyerraytracer_tpu_torch.render.camera import (  # noqa: E402
    debug_grid_rays,
)
from messyerraytracer_tpu_torch.scene import serialize as pser  # noqa: E402
from messyerraytracer_tpu_torch.scene.scene import (  # noqa: E402
    build_scene_from_tri_array,
)
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    TIE_RTOL,
    assert_parity,
    jax_fields,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
    terrain_tris,
)

N_RAYS = 2048
HIT_FIELDS = ("t", "position", "normal", "u", "v", "prim_id", "hit_layers")
TABLES = ("child_min_x", "child_min_y", "child_min_z", "child_max_x",
          "child_max_y", "child_max_z", "child_enc", "leaf_first",
          "leaf_count", "tri", "node_pmin", "node_psc", "child_qlo",
          "child_qhi", "depth", "quantized")


def frontier_tris():
    """Terrain under a sphere and a box: 1,644 triangles, 4 levels of the
    8-wide tree."""
    return np.concatenate([terrain_tris(subdiv=24, extent=10.0),
                           meshes.uv_sphere(1.2, 8, 16, center=(0, 1.5, 0)),
                           meshes.box((1.0, 2.0, 1.0), (3.0, 1.0, -2.0))])


def frontier_rays(n=N_RAYS, seed=5):
    """Random rays with dead (t_max < t_min) and zero-direction rays."""
    o, d = rand_rays_np(n, seed=seed, extent=6.0)
    d[::97] = 0.0
    t_max = np.full(n, 3.402823466e38, np.float32)
    t_max[::89] = -1.0
    t_min = np.full(n, 1e-3, np.float32)
    return o, d, t_min, t_max


@pytest.fixture(scope="module")
def scenes():
    tris = frontier_tris()
    lay = (np.arange(len(tris)) % 3 + 1).astype(np.int32)
    js = jax_build(tris, layers=lay, backend="frontier")
    ps = build_scene_from_tri_array(tris, layers=lay, backend="frontier",
                                    device="cpu")
    return js, ps


def assert_tables_equal(p, j):
    for f in TABLES:
        a, b = getattr(p, f), getattr(j, f)
        if isinstance(a, tuple):
            assert len(a) == len(b), f
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np_of(x), np_of(y), f)
        elif a is None or isinstance(a, (bool, int)):
            assert a == b, f
        else:
            np.testing.assert_array_equal(np_of(a), np_of(b), f)


@pytest.mark.parametrize("quantize", [False, True])
def test_tables_equal_jax(scenes, quantize):
    """collapse_tables, _quantize_wide_boxes and build_frontier_scene give
    the JAX package's arrays, on the same binary BVH."""
    js, ps = scenes
    np.testing.assert_array_equal(_bvh_host(ps.bvh, "left_first"),
                                  np.asarray(js.bvh.left_first))
    host = [_bvh_host(ps.bvh, k) for k in ("aabb_min", "aabb_max",
                                           "left_first", "count")]
    pt, jt = pfr.collapse_tables(*host), jfr.collapse_tables(*host)
    for a, b in zip(pt, jt):
        np.testing.assert_array_equal(a, b)
    if quantize:
        present = ~np.isnan(pt[0][..., 0])
        for a, b in zip(pfr._quantize_wide_boxes(pt[0], pt[1], present),
                        jfr._quantize_wide_boxes(pt[0], pt[1], present)):
            np.testing.assert_array_equal(a, b)
    fs = ps.frontier_q if quantize else ps.frontier
    assert fs.depth == 4 and fs.quantized == quantize
    assert_tables_equal(fs, js.frontier_q if quantize else js.frontier)


CASTS = [("frontier", False, -1), ("frontier", True, -1),
         ("frontier_q", False, -1), ("frontier_q", True, -1),
         ("frontier", False, 0b10)]


@pytest.mark.parametrize("backend,any_hit,mask", CASTS)
def test_cast_equals_jax(scenes, backend, any_hit, mask):
    """The cast on identical tables: parity with JAX's on t and prim,
    occluded exact, and the per-ray tri_tests / nodes_visited exact (the
    stats sum them).  Dead and zero-direction rays are in the batch."""
    js, ps = scenes
    jf = js.frontier_q if backend == "frontier_q" else js.frontier
    pf = pfr.frontier_scene_from_jax(device="cpu", **jax_fields(jf))
    o, d, tmn, tmx = frontier_rays()
    hj, sj, oj, rj = jfr.cast_rays_frontier(
        jax_rays(o, d, tmn, tmx), jf, js.tris, mask, any_hit,
        return_per_ray_stats=True)
    hp, sp, op, rp = pfr.cast_rays_frontier(
        port_rays(o, d, tmn, tmx), pf, ps.tris, mask, any_hit,
        return_per_ray_stats=True)
    np.testing.assert_array_equal(np_of(op), np_of(oj))
    for k in ("tri_tests", "nodes_visited"):
        np.testing.assert_array_equal(np_of(rp[k]), np_of(rj[k]), k)
        assert rp[k].dtype == torch.int32
    assert int(sp.tri_tests) == int(sj.tri_tests)
    assert int(sp.bvh_nodes_visited) == int(sj.bvh_nodes_visited)
    assert int(sp.hits) == int(sj.hits) and int(sp.rays_cast) == N_RAYS
    dead = (tmx < tmn)
    assert not np_of(op)[dead].any() and (np_of(rp["nodes_visited"])[dead]
                                          == 0).all()
    if any_hit:
        return
    # XLA's CPU build fuses a*b + c into FMAs, the port does not (ROADMAP
    # queue C): t moves by an ulp or two on part of the rays, and u, v and
    # position by the same relative error scaled by t, so they are held
    # to the parity rule's rtol times max(|t|, 1); normals are gathered
    same = assert_parity(hp, hj)
    scale = 1e-5 * np.maximum(np.abs(np_of(hj.t)), 1.0)[same]
    for f in ("u", "v", "position"):
        diff = np.abs(np_of(getattr(hp, f)) - np_of(getattr(hj, f)))[same]
        assert (diff.reshape(len(scale), -1).max(1) <= scale).all(), f
    np.testing.assert_array_equal(np_of(hp.normal), np_of(hj.normal))
    np.testing.assert_array_equal(np_of(hp.hit_layers), np_of(hj.hit_layers))
    if mask != -1:
        assert (np_of(hp.hit_layers)[np_of(hp.hit)] & mask).all()


@pytest.mark.parametrize("backend", ["frontier", "frontier_q"])
def test_cast_bit_equal_to_brute(scenes, backend):
    """Against the port's brute oracle: every field bit for bit where both
    pick the same triangle; elsewhere an exact-t tie the two break
    differently (lowest slot against lowest index).  any-hit flags
    equal."""
    _, ps = scenes
    scene = dataclasses.replace(ps, backend=backend)
    o, d, tmn, tmx = frontier_rays(seed=6)
    rays = port_rays(o, d, tmn, tmx)
    hf, _ = scene.cast_rays(rays)
    hb, _ = cast_rays_brute(rays, ps.tris)
    same = hf.prim_id == hb.prim_id
    for f in HIT_FIELDS:
        a, b = getattr(hf, f)[same], getattr(hb, f)[same]
        assert torch.equal(a, b), f
    ties = ~same
    assert bool((hf.t[ties] == hb.t[ties]).all()), "off-tie prim mismatch"
    assert torch.equal(scene.any_hit_rays(rays), any_hit_brute(rays,
                                                               ps.tris))


def test_single_triangle_and_degenerate_rays():
    """One triangle (the root is a leaf: one wide node, depth 1), hit,
    missed, behind the origin, and from a dead ray."""
    tri = np.float32([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]])
    js = jax_build(tri, backend="frontier")
    ps = build_scene_from_tri_array(tri, backend="frontier", device="cpu")
    assert ps.frontier.depth == js.frontier.depth == 1
    assert_tables_equal(ps.frontier, js.frontier)
    o = np.float32([[0, 0, 2], [3, 3, 2], [0, 0, -2], [0.1, 0.1, 2]])
    d = np.float32([[0, 0, -1], [0, 0, -1], [0, 0, -1], [0, 0, -1]])
    tmn = np.float32([1e-3, 1e-3, 1e-3, 1.0])
    tmx = np.float32([1e30, 1e30, 1e30, 0.5])
    hj, _, oj = jfr.cast_rays_frontier(jax_rays(o, d, tmn, tmx),
                                       js.frontier, js.tris)
    hp, _ = ps.cast_rays(port_rays(o, d, tmn, tmx))
    assert_parity(hp, hj)
    np.testing.assert_array_equal(np_of(hp.hit), [True, False, False, False])
    np.testing.assert_array_equal(np_of(hp.hit), np_of(oj))
    assert float(hp.t[0]) == pytest.approx(2.0)


def test_lazy_tables_shared_by_replace_dropped_by_refit(scenes):
    """A backend switch through ``dataclasses.replace`` (the dispatcher's
    way) reuses the tables the first cast built; a refit builds new ones
    from the moved triangles."""
    _, ps = scenes
    scene = build_scene_from_tri_array(frontier_tris(), backend="pallas",
                                       device="cpu")
    copy = dataclasses.replace(scene, backend="frontier_q")
    fq = copy._frontier_for_backend()
    assert scene.frontier_q is fq and dataclasses.replace(
        scene, backend="frontier").frontier is scene.frontier
    tris = frontier_tris() + np.float32([0.0, 0.25, 0.0])
    moved = copy.refit(tris[:, 0], tris[:, 1], tris[:, 2])
    assert moved.frontier_q is not fq and scene.frontier_q is fq
    o, d, tmn, tmx = frontier_rays(512, seed=7)
    rays = port_rays(o, d, tmn, tmx)
    hm, _ = moved.cast_rays(rays)
    hb, _ = cast_rays_brute(rays, moved.tris)
    assert_parity(hm, hb)


def test_debug_heatmaps_on_frontier_counts(scenes):
    """DRAW_HEATMAP / DRAW_OVERHEAT on a pallas scene, and
    per_ray_cost_heatmap(backend="frontier"), read the frontier counters:
    the JAX package's colors and counts on the same rays, bit for bit."""
    js, _ = scenes
    tris = frontier_tris()
    lay = (np.arange(len(tris)) % 3 + 1).astype(np.int32)
    pallas = build_scene_from_tri_array(tris, layers=lay, backend="pallas",
                                        device="cpu")
    eye, fwd, grid = (1.0, 6.0, 9.0), (-0.1, -0.6, -1.0), (48, 32)
    rays = debug_grid_rays(eye, fwd, *grid, device="cpu")
    jr = jax_rays(*(np_of(x) for x in (rays.origin, rays.direction,
                                       rays.t_min, rays.t_max)))
    jt = jdebug._per_ray_tri_tests(js, jr)
    tt = pdebug._per_ray_tri_tests(pallas, rays)
    np.testing.assert_array_equal(np_of(tt), jt)
    assert float(tt.max()) > 0
    jc, jtt, jn = jdebug.per_ray_cost_heatmap(js, jr, 40.0,
                                              backend="frontier")
    pc, ptt, pn = pdebug.per_ray_cost_heatmap(pallas, rays, 40.0,
                                              backend="frontier")
    for a, b in ((pc, jc), (ptt, jtt), (pn, jn)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(np_of(a), np.asarray(b, np.float32))
    # the draw modes cast their own grid of the same rays
    heat = pdebug.cast_debug_rays(pallas, eye, fwd, *grid, heatmap_max=40.0,
                                  draw_mode=pdebug.DRAW_HEATMAP,
                                  device="cpu")
    np.testing.assert_array_equal(np_of(heat.colors), np_of(pc))
    over = pdebug.cast_debug_rays(pallas, eye, fwd, *grid,
                                  overheat_threshold=8.0,
                                  draw_mode=pdebug.DRAW_OVERHEAT,
                                  device="cpu")
    red = np_of(over.colors)[:, 0] == np.float32(1.0)
    np.testing.assert_array_equal(red, jt > 8.0)


def test_service_submit_on_frontier_backends():
    """The service switched to frontier / frontier_q submits through the
    dispatcher's backend copy, builds the tables once and answers as
    JAX's frontier service does; sorted == unsorted bit for bit."""
    def fill(svc):
        svc.register_mesh(meshes.uv_sphere(1.0, 8, 16))
        svc.register_mesh(meshes.plane(12.0, y=-1.5, subdiv=6), None,
                          layers=0b10)
        svc.build()
        return svc

    port = fill(psvc.RayTracerService(device="cpu"))
    jax = fill(jsvc.RayTracerService(backend="frontier"))
    o, d = rand_rays_np(512, seed=8, extent=4.0)
    jres = jax.submit(jsvc.RayQuery(rays=jax_rays(o, d), coherent=True))
    for b in ("frontier", "frontier_q"):
        port.set_backend(b)
        assert port.get_backend() == b
        rs = port.submit(psvc.RayQuery(rays=port_rays(o, d)))
        ru = port.submit(psvc.RayQuery(rays=port_rays(o, d), coherent=True))
        for f in HIT_FIELDS:
            assert torch.equal(getattr(rs.hits, f), getattr(ru.hits, f)), f
        assert_parity(ru.hits, jres.hits)
        assert int(ru.stats.tri_tests) == int(jres.stats.tri_tests) or (
            b == "frontier_q")
    cache = port.scene._frontier_cache
    assert set(cache) == {False, True} and cache[False][0] is port.scene.bvh


def test_checkpoint_round_trip(tmp_path, scenes):
    """A frontier scene saved by the port loads with no cluster or wide
    tables and the same frontier tables and frame; a JAX file of a
    frontier scene loads in the port, and the port's file in JAX."""
    js, ps = scenes
    path = tmp_path / "port.npz"
    pser.save_scene(path, ps)
    loaded = pser.load_scene(path, device="cpu")
    assert loaded.backend == "frontier" and loaded.cluster is None
    assert loaded.wide is None
    assert_tables_equal(loaded.frontier, ps.frontier)
    o, d, tmn, tmx = frontier_rays(512, seed=9)
    rays = port_rays(o, d, tmn, tmx)
    want, _ = ps.cast_rays(rays)
    got, _ = loaded.cast_rays(rays)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    jl = jser.load_scene(str(path))
    assert jl.backend == "frontier"
    assert_tables_equal(ps.frontier, jl.frontier)
    jpath = tmp_path / "jax.npz"
    jser.save_scene(str(jpath), js)
    from_jax = pser.load_scene(jpath, device="cpu")
    assert from_jax.backend == "frontier"
    assert_tables_equal(from_jax.frontier, js.frontier)
    h, _ = from_jax.cast_rays(rays)
    tie = np.abs(np_of(h.t) - np_of(want.t)) <= TIE_RTOL * np.maximum(
        np.abs(np_of(want.t)), 1.0)
    assert ((np_of(h.prim_id) == np_of(want.prim_id)) | tie).all()
