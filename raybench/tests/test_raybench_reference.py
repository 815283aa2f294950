"""The plain reference agrees with the port's plain path at a tiny size:
the same camera rays bit for bit, the same world triangles, the same hits
(judged as the benchmark judges them), the same path-traced frame."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import COMP, HEAD

from raybench.reference import camera as rcam
from raybench.reference import cast as rcast
from raybench.reference import judge as rjudge
from raybench.reference import pathtrace as rpt
from raybench.reference import scene as rscene
from raybench.scenes import composite, headline

CPU = torch.device("cpu")


def _inputs(recipe, cut):
    from raybench import harness

    name = "instanced_1m" if recipe is headline else "composite_99k"
    cfg = harness.merged(harness.load_json(harness.HERE, "configs",
                                           name + ".json"), cut["config"])
    return cfg, recipe.make(cfg["scene"])


@pytest.mark.parametrize("yaw", [0.0, 37.5, 211.0])
def test_camera_rays_bit_equal(yaw):
    from messyerraytracer_tpu_torch.dispatch.morton import (
        raster_block_permutation)
    from messyerraytracer_tpu_torch.render.camera import (CameraParams,
                                                          generate_rays)

    from raybench.kinds.primary_frames import orbit

    w, h = 96, 54
    eye = orbit((0.0, 26.0, 55.0), yaw)
    perm = raster_block_permutation(w, h, 32)
    assert np.array_equal(perm, rcam.block_permutation(w, h, 32))
    rays = generate_rays(CameraParams.look_at(eye, (0, 1, 0),
                                              fov_degrees=60.0), w, h,
                         device=CPU).take(torch.as_tensor(perm).long())
    o, d = rcam.frame_rays(eye, (0, 1, 0), 60.0, w, h, perm)
    assert np.array_equal(rays.origin.numpy(), o)
    assert np.array_equal(rays.direction.numpy(), d)


def test_world_triangles_match_the_tlas():
    from raybench.kinds import build_tlas

    cfg, inputs = _inputs(headline, HEAD)
    ctx = type("C", (), {"inputs": inputs, "device": CPU})
    tlas = build_tlas(ctx)
    tlas.build_tlas()
    ref = rscene.world_triangles(inputs["meshes"], inputs["instances"])
    assert np.allclose(tlas._world_tris_np(), ref.numpy(), atol=1e-5)


def test_reference_cast_against_a_plain_moller_trumbore():
    g = torch.Generator().manual_seed(5)
    tris = torch.rand((300, 3, 3), generator=g, dtype=torch.float64) * 4 - 2
    o = torch.rand((500, 3), generator=g) * 6 - 3
    d = torch.nn.functional.normalize(torch.randn((500, 3), generator=g),
                                      dim=1)
    tmin, tmax = torch.full((500,), 1e-3), torch.full((500,), 3e38)
    t, p = rcast.cast(o, d, tmin, tmax, tris)
    oo, dd = o.double()[:, None].expand(-1, 300, -1), d.double()[:, None]
    tt, u, v, ok = rcast.moller_trumbore(
        oo.reshape(-1, 3), dd.expand(-1, 300, -1).reshape(-1, 3),
        tris[None].expand(500, -1, -1, -1).reshape(-1, 3, 3))
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (tt >= 1e-3)
    best = torch.where(hit, tt, float("inf")).reshape(500, 300).amin(1)
    assert torch.allclose(t, best, rtol=1e-9)
    assert torch.equal(p >= 0, torch.isfinite(best))
    occ = rcast.cast(o, d, tmin, tmax, tris, any_hit=True)
    assert torch.equal(occ, p >= 0)


@pytest.mark.parametrize("recipe,cut", [(headline, HEAD),
                                        (composite, COMP)])
def test_program_hits_judged_sound(recipe, cut):
    from messyerraytracer_tpu_torch.core.types import make_rays
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    _, inputs = _inputs(recipe, cut)
    tris = rscene.world_triangles(inputs["meshes"], inputs["instances"])
    scene = build_scene_from_tri_array(tris.float().numpy(), device=CPU)
    g = torch.Generator().manual_seed(11)
    o = (torch.rand((2048, 3), generator=g) * 2 - 1) * 20
    o[:, 1] = o[:, 1].abs() + 0.5
    d = torch.nn.functional.normalize(torch.randn((2048, 3), generator=g),
                                      dim=1)
    rays = make_rays(o, d, device=CPU)
    hits, _ = scene.cast_rays(rays)
    got = rjudge.bad_rays({f: getattr(hits, f) for f in rjudge.HIT_FIELDS},
                          rays.origin, rays.direction, rays.t_min,
                          rays.t_max, tris)
    assert got["bad"] == 0 and got["hits"] > 100, got


def test_path_traced_frame_matches_the_port():
    from messyerraytracer_tpu_torch.render.wavefront import (
        WavefrontPathTracer)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    from raybench import harness
    from raybench.kinds import block_perm, frame_rays
    from raybench.kinds.pathtraced_frames import shading

    cfg, inputs = _inputs(composite, COMP)
    tr = harness.load_json(harness.HERE, "traffic",
                           "pathtrace_640x480_3b.json")
    tris = rscene.world_triangles(inputs["meshes"], inputs["instances"])
    scene = build_scene_from_tri_array(tris.float().numpy(), device=CPU)
    pt = WavefrontPathTracer(scene, *shading(tr, CPU))
    w, h, cam = 40, 30, cfg["camera"]
    rays = frame_rays(cam, cam["eye"], w, h, block_perm(w, h, 32, CPU), CPU)
    img, wave = pt.trace_frame(rays, max_bounces=3, sample_index=12345,
                               with_counts=True)
    ref, ref_wave = rpt.trace_frame(
        rays.origin, rays.direction, tris,
        rpt.shading_inputs(tr["light"], tr["sky"], tr["material"], CPU,
                           torch.float64), 12345, 3)
    assert int(wave) == ref_wave
    assert int((rpt.pixel_gaps(img, ref) > 0).sum()) == 0
