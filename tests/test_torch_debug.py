"""PyTorch port: debug draw modes, per-ray cost heatmaps and BVH wireframes
against the JAX package's debug/debug.py.

Every draw mode is fed the same hits in both packages (a stand-in scene
returns one cast's hits and stats), and its colors must agree bit for bit
in float32: the port computes each in the JAX package's dtype.  The
heatmaps' counts are B1's per ray in the port and a row footprint in the
JAX cluster kernel (ROADMAP queue C), so the counts are held against the
port's plain version of B1 and the colors against JAX's ``_heat_color``
fed those counts."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from messyerraytracer_tpu.core import types as jtypes  # noqa: E402
from messyerraytracer_tpu.debug import debug as jdebug  # noqa: E402

from messyerraytracer_tpu_torch.debug import debug as pdebug  # noqa: E402
from messyerraytracer_tpu_torch.kernels.cluster_v2 import (  # noqa: E402
    cluster_cast_plain,
)
from messyerraytracer_tpu_torch.render.camera import (  # noqa: E402
    debug_grid_rays,
)
from messyerraytracer_tpu_torch.scene.scene import (  # noqa: E402
    build_scene_from_tri_array,
)
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from torch_port_helpers import np_of, small_tris  # noqa: E402

EYE, FWD, GRID = (1.0, 4.0, 7.0), (-0.1, -0.5, -1.0), (40, 30)
HIT_FIELDS = ("t", "position", "normal", "u", "v", "prim_id", "hit_layers")


class Stand:
    """A scene stand-in: its cast returns fixed hits and stats."""

    def __init__(self, hits, stats):
        self.hits, self.stats = hits, stats

    def cast_rays(self, rays):
        return self.hits, self.stats


@pytest.fixture(scope="module")
def scene():
    """The small layered scene (plane layer 0b01, sphere 0b110) on the
    cluster backend, on the CPU."""
    tris = small_tris()
    lay = np.where(np.arange(len(tris)) < 162, 0b01, 0b110).astype(np.int32)
    return build_scene_from_tri_array(tris, layers=lay, device="cpu")


@pytest.fixture(scope="module")
def stands(scene):
    rays = debug_grid_rays(EYE, FWD, *GRID, device="cpu")
    hits, stats = scene.cast_rays(rays)
    jhits = jtypes.Hits(**{f: jnp.asarray(np_of(getattr(hits, f)))
                           for f in HIT_FIELDS})
    jstats = jtypes.RayStats(*(jnp.asarray(int(getattr(stats, f)),
                                           jnp.int32)
                               for f in ("rays_cast", "tri_tests",
                                         "bvh_nodes_visited", "hits")))
    return Stand(hits, stats), Stand(jhits, jstats)


def test_heat_color_equals_jax():
    rng = np.random.default_rng(0)
    t = np.concatenate([rng.uniform(-0.5, 1.5, 5000),
                        [0.0, 0.25, 0.5, 0.75, 1.0]]).astype(np.float32)
    got = pdebug._heat_color(torch.from_numpy(t))
    ref = jdebug._heat_color(t)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", range(7))
def test_draw_modes_equal_jax(stands, mode):
    """Each of the 7 modes, fed the same hits: colors bit-equal to JAX's
    (the heatmaps of a scene without per-ray counters use the mean, as in
    JAX), the summary numbers equal."""
    pst, jst = stands
    kw = dict(grid_w=GRID[0], grid_h=GRID[1], draw_mode=mode,
              heatmap_max=50.0, overheat_threshold=20.0)
    pr = pdebug.cast_debug_rays(pst, EYE, FWD, device="cpu", **kw)
    jr = jdebug.cast_debug_rays(jst, EYE, FWD, **kw)
    assert pr.colors.dtype == torch.float32
    assert pr.colors.shape == (GRID[0] * GRID[1], 3)
    np.testing.assert_array_equal(pr.colors.numpy(), jr.colors)
    for f in ("tri_tests_per_ray", "nodes_per_ray", "hit_rate"):
        assert getattr(pr, f) == pytest.approx(getattr(jr, f), rel=1e-6)
    assert pr.grid == jr.grid and pr.elapsed_ms >= 0.0
    # the port rounds each camera step from float64 (render/camera.py)
    np.testing.assert_allclose(pr.rays.direction.numpy(),
                               np.asarray(jr.rays.direction), atol=2e-7)
    assert bool((pr.colors >= 0).all() and (pr.colors <= 1).all())


def test_heatmaps_read_b1_counts(scene):
    """On a cluster scene the heatmaps read B1's per-ray counters: equal to
    the plain version's, colored as JAX's ramp colors them; DRAW_HEATMAP
    and DRAW_OVERHEAT follow the same counts.  A scene without cluster
    tables, or the frontier backend forced, reads the frontier cast's
    per-ray counters (held against JAX's in test_torch_frontier.py)."""
    rays = debug_grid_rays(EYE, FWD, *GRID, device="cpu")
    colors, tt, nodes = pdebug.per_ray_cost_heatmap(scene, rays, 40.0)
    _, iout, _ = cluster_cast_plain(rays.origin, rays.direction, rays.t_min,
                                    rays.t_max, scene.cluster)
    np.testing.assert_array_equal(tt.numpy(), iout[2].numpy())
    np.testing.assert_array_equal(nodes.numpy(), iout[4].numpy())
    assert tt.dtype == nodes.dtype == torch.float32 and float(tt.max()) > 0
    np.testing.assert_array_equal(colors.numpy(),
                                  jdebug._heat_color(tt.numpy() / 40.0))
    heat = pdebug.cast_debug_rays(scene, EYE, FWD, *GRID, heatmap_max=40.0,
                                  draw_mode=pdebug.DRAW_HEATMAP,
                                  device="cpu")
    np.testing.assert_array_equal(heat.colors.numpy(), colors.numpy())
    over = pdebug.cast_debug_rays(scene, EYE, FWD, *GRID,
                                  overheat_threshold=float(tt.mean()),
                                  draw_mode=pdebug.DRAW_OVERHEAT,
                                  device="cpu")
    red = (over.colors[:, 0] == np.float32(1.0)).numpy()
    np.testing.assert_array_equal(red, (tt > float(tt.mean())).numpy())
    pallas = build_scene_from_tri_array(small_tris(), backend="pallas",
                                        device="cpu")
    from messyerraytracer_tpu_torch.accel.frontier import (
        cast_rays_frontier)

    _, _, _, fr = cast_rays_frontier(rays, scene.frontier, scene.tris,
                                     return_per_ray_stats=True)
    for s in (pallas, scene):
        colors, tt, nodes = pdebug.per_ray_cost_heatmap(
            s, rays, 40.0, backend=None if s is pallas else "frontier")
        np.testing.assert_array_equal(tt.numpy(), fr["tri_tests"].numpy())
        np.testing.assert_array_equal(nodes.numpy(),
                                      fr["nodes_visited"].numpy())
    np.testing.assert_array_equal(
        pdebug._per_ray_tri_tests(pallas, rays).numpy(),
        fr["tri_tests"].numpy())


def test_canonical_debug_drive():
    """The verify skill's canonical drive through cast_debug_rays: the
    unit sphere's silhouette, 44 of 192 rays hit, the center ray at
    t ~ 3.03 with a normal facing the camera."""
    s = build_scene_from_tri_array(meshes.uv_sphere(1.0, 16, 32),
                                   device="cpu")
    r = pdebug.cast_debug_rays(s, (0, 0, 4), (0, 0, -1), 16, 12,
                               draw_mode=pdebug.DRAW_NORMALS, device="cpu")
    hit = r.hits.hit.numpy().reshape(12, 16)
    assert int(hit.sum()) == 44 and r.hit_rate == pytest.approx(44 / 192)
    c = 6 * 16 + 8
    assert float(r.hits.t[c]) == pytest.approx(3.03, abs=0.02)
    assert float(r.hits.normal[c, 2]) > 0.9
    assert float(r.colors[c, 2]) > 0.95      # normal z mapped to blue


@pytest.mark.parametrize("kw", [{}, {"max_depth": 2}, {"leaves_only": True}])
def test_bvh_wireframe_equals_jax(scene, kw):
    """Segments and depths bit-equal to JAX's ``bvh_wireframe`` reading the
    same BVH arrays, on the build's BVH and on a refit one (whose depths
    come from the kept levels)."""
    tris = small_tris()
    refit = scene.refit(tris[:, 0] * 1.5, tris[:, 1], tris[:, 2] + 0.25)
    for bvh in (scene.bvh, refit.bvh):
        segs, depth = pdebug.bvh_wireframe(bvh, **kw)
        rs, rd = jdebug.bvh_wireframe(bvh, **kw)   # reads them as numpy
        assert segs.dtype == torch.float32 and depth.dtype == torch.int32
        np.testing.assert_array_equal(segs.numpy(), rs)
        np.testing.assert_array_equal(depth.numpy(), rd)
        assert segs.shape[0] % 12 == 0 and segs.shape[0] > 0
