"""The port's PCG32, bounce sampling, PathTracer and WavefrontPathTracer
against the JAX package's.

PCG32 streams must be bit-exact.  Radiance is compared per pixel: the two
packages round transcendentals (sin, cos, sqrt chains, pow) differently at
the last ulp, so a sampled direction can differ by an ulp and a path that
grazes a silhouette can take another branch.  Each frame test therefore
states a per-pixel tolerance and a cap on the share of pixels that may
exceed it.  Scenes cast on the brute oracle on both sides unless a test
says otherwise."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_fields, np_of

from messyerraytracer_tpu.render import pathtrace as jpt
from messyerraytracer_tpu.render import shade as jsh
from messyerraytracer_tpu.render import wavefront as jwf
from messyerraytracer_tpu.render.camera import CameraParams as JCam
from messyerraytracer_tpu.render.camera import generate_rays as jgen
from messyerraytracer_tpu.scene.scene import (
    build_scene_from_tri_array as jax_build)
from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS
from messyerraytracer_tpu_torch.render import pathtrace as ppt
from messyerraytracer_tpu_torch.render import shade as psh
from messyerraytracer_tpu_torch.render import wavefront as pwf
from messyerraytracer_tpu_torch.render.camera import CameraParams
from messyerraytracer_tpu_torch.render.camera import generate_rays
from messyerraytracer_tpu_torch.scene.scene import build_scene_from_tri_array
from messyerraytracer_tpu_torch.utils import meshes

PIX_TOL = 1e-4     # per-pixel |diff| / max(1, |ref|) of a converged path
DIVERGED_CAP = 0.02  # share of pixels whose path may take another branch


def scene_tris():
    """An open scene (a floor, two spheres and a box): bounce rays escape
    to the sky, so live counts fall bounce by bounce."""
    return np.concatenate([
        meshes.plane(8.0, y=0.0, subdiv=4),
        meshes.uv_sphere(1.0, 8, 14, center=(0, 1.1, 0)),
        meshes.uv_sphere(0.6, 6, 10, center=(-1.8, 0.7, 0.9)),
        meshes.box((0.8, 1.2, 0.8), center=(1.8, 0.6, -0.5))])


def jax_shading():
    mats = jsh.make_materials(
        albedo=[[0.8, 0.7, 0.6], [0.3, 0.5, 0.9], [0.9, 0.9, 0.2]],
        metallic=[0.0, 0.8, 0.2], roughness=[0.7, 0.25, 0.4],
        emission=[[0, 0, 0], [0, 0, 0], [0.5, 0.2, 0.1]])
    lights = jsh.make_lights([
        {"type": jsh.LIGHT_DIRECTIONAL, "direction": (0.3, 1.0, 0.5),
         "energy": 1.3},
        {"type": jsh.LIGHT_POINT, "position": (1.0, 3.2, 1.0),
         "energy": 6.0, "range": 9.0}])
    return mats, lights, jsh.make_environment(tonemap_mode=1)


@pytest.fixture(scope="module")
def world():
    tris = scene_tris()
    mats, lights, env = jax_shading()
    port = (psh.materials_from_jax(**jax_fields(mats), device="cpu"),
            psh.lights_from_jax(**jax_fields(lights), device="cpu"),
            psh.environment_from_jax(**jax_fields(env), device="cpu"))
    mid = np.arange(len(tris), dtype=np.int32) % 3
    return (jax_build(tris, backend="brute"),
            build_scene_from_tri_array(tris, backend="brute", device="cpu"),
            (mats, lights, env), port, mid)


def cams(w, h):
    args = ((3.0, 3.5, 6.0), (0.0, 0.8, 0.0))
    return (generate_rays(CameraParams.look_at(*args, fov_degrees=55), w, h,
                          device="cpu"),
            jgen(JCam.look_at(*args, fov_degrees=55), w, h))


def tracers(world, cls_p, cls_j, **kw):
    js, ps, (jm, jl, je), (pm, pl, pe), mid = world
    return (cls_p(ps, pl, pe, pm, mat_id_of_prim=torch.from_numpy(mid),
                  **kw),
            cls_j(js, jl, je, jm, mat_id_of_prim=jnp.asarray(mid), **kw))


def assert_frames_close(a, b, tol=PIX_TOL, cap=DIVERGED_CAP):
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    err = (np.abs(a - b) / np.maximum(1.0, np.abs(b))).max(axis=1)
    share = float((err > tol).mean())
    assert share <= cap, f"{share:.2%} of pixels differ by > {tol}"
    return share


def test_pcg32_bit_exact_65536_seeds_8_draws():
    seeds = np.random.default_rng(40).integers(0, 2**32, 65_536,
                                               dtype=np.uint64)
    seeds[:4] = (0, 1, 2**32 - 1, 2**31)
    ps = ppt.pcg32_seed(torch.from_numpy(seeds.astype(np.int64)))
    js = jpt.pcg32_seed(jnp.asarray(seeds.astype(np.uint32)))
    np.testing.assert_array_equal(np_of(ps), np_of(js).astype(np.int64))
    for _ in range(4):
        ps, pw = ppt.pcg32_next(ps)
        js, jw = jpt.pcg32_next(js)
        np.testing.assert_array_equal(np_of(pw), np_of(jw).astype(np.int64))
        ps, pf = ppt.pcg32_float(ps)
        js, jf = jpt.pcg32_float(js)
        assert pf.dtype == torch.float32
        np.testing.assert_array_equal(np_of(pf), np_of(jf))
    np.testing.assert_array_equal(np_of(ps), np_of(js).astype(np.int64))
    assert int(ps.max()) < 2**32 and int(ps.min()) >= 0
    # the per-pixel seeding of a frame
    n, s = 70_000, 12_345
    pix = jnp.arange(n, dtype=jnp.uint32)
    want = jpt.pcg32_seed(pix * jnp.uint32(1009)
                          + jnp.uint32(s) * jnp.uint32(6529) + jnp.uint32(7))
    np.testing.assert_array_equal(np_of(ppt.pixel_seeds(n, s, "cpu")),
                                  np_of(want).astype(np.int64))


def random_surfaces(n, seed):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    view = rng.normal(size=(n, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    view = np.where((view * nrm).sum(1, keepdims=True) < 0, -view, view)
    metal = rng.random(n).astype(np.float32)
    rough = rng.uniform(0.04, 1.0, n).astype(np.float32)
    alb = rng.random((n, 3)).astype(np.float32)
    f = dict(position=rng.normal(size=(n, 3)).astype(np.float32),
             normal=nrm, view_dir=view,
             n_dot_v=np.maximum((nrm * view).sum(1), 1e-4).astype(
                 np.float32),
             albedo=alb, metallic=metal, roughness=rough,
             f0=(alb * metal[:, None] + 0.04 * (1 - metal[:, None])
                 ).astype(np.float32),
             diff=(alb * (1 - metal[:, None])).astype(np.float32),
             emission=np.zeros((n, 3), np.float32),
             uv=np.zeros((n, 2), np.float32))
    return (psh.Surface(**{k: torch.from_numpy(v) for k, v in f.items()}),
            jsh.Surface(**{k: jnp.asarray(v) for k, v in f.items()}))


def test_sampling_matches_jax():
    n = 4096
    ps, js = random_surfaces(n, 41)
    rng = np.random.default_rng(42)
    u1, u2 = (rng.random(n).astype(np.float32) for _ in range(2))
    T, J = torch.from_numpy, jnp.asarray
    for a, b in zip(ppt.construct_onb(ps.normal),
                    jpt.construct_onb(js.normal)):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=2e-6)
    np.testing.assert_allclose(
        np_of(ppt.cosine_hemisphere_sample(ps.normal, T(u1), T(u2))),
        np_of(jpt.cosine_hemisphere_sample(js.normal, J(u1), J(u2))),
        atol=2e-6)
    np.testing.assert_allclose(
        np_of(ppt.ggx_sample_half(ps.normal, ps.roughness, T(u1), T(u2))),
        np_of(jpt.ggx_sample_half(js.normal, js.roughness, J(u1), J(u2))),
        atol=2e-6)
    seeds = np.arange(n, dtype=np.int64) * 7 + 3
    pr, pd, pw, pv = ppt.sample_bounce(ps, ppt.pcg32_seed(T(seeds)))
    jr, jd, jw, jv = jpt.sample_bounce(js, jpt.pcg32_seed(
        J(seeds.astype(np.uint32))))
    np.testing.assert_array_equal(np_of(pr), np_of(jr).astype(np.int64))
    np.testing.assert_allclose(np_of(pd), np_of(jd), atol=2e-5)
    # weights: g * v.h / (n.v * n.h * p) grows where n.h -> 0
    np.testing.assert_allclose(np_of(pw), np_of(jw), rtol=1e-3, atol=1e-5)
    assert (np_of(pv) != np_of(jv)).mean() <= 1e-3   # grazing samples


def test_path_tracer_frame_matches_jax(world):
    pr, jr = cams(32, 24)
    p, j = tracers(world, ppt.PathTracer, jpt.PathTracer)
    params = (ppt.PathTraceParams(32, 24, 2, 3),
              jpt.PathTraceParams(32, 24, 2, 3))
    a = p.trace_frame(params[0], pr)
    b = j.trace_frame(params[1], jr)
    assert_frames_close(a, b)
    assert_frames_close(p.trace_frame_srgb(params[0], pr),
                        jsh.to_srgb(jsh.tonemap(b, 1)))
    # sorting the bounce rays changes nothing per pixel
    p.sort_secondary = True
    assert torch.equal(p.trace_frame(params[0], pr), a)


def test_wavefront_stages_match_jax(world):
    pr, jr = cams(32, 24)
    p, j = tracers(world, pwf.WavefrontPathTracer, jwf.WavefrontPathTracer)
    ps, js = p.generate(pr, 5), j.generate(jr, 5)
    np.testing.assert_array_equal(np_of(ps.rng), np_of(js.rng).astype(
        np.int64))
    for bounce in range(3):
        ph, jh = p.extend(ps, sort=bounce > 0), j.extend(js, sort=bounce > 0)
        same = np_of(ph.prim_id) == np_of(jh.prim_id)
        assert same.mean() >= 1 - DIVERGED_CAP
        ps, js = p.shade(ps, ph, bounce, 2), j.shade(js, jh, bounce, 2)
        ps, js = p.connect(ps, sort=bounce > 0), j.connect(js,
                                                           sort=bounce > 0)
        # RNG streams stay bit-exact: every pixel draws the same count
        np.testing.assert_array_equal(np_of(ps.rng),
                                      np_of(js.rng).astype(np.int64))
        for f in ("active", "shadow_valid", "visibility"):
            assert (np_of(getattr(ps, f)) != np_of(getattr(js, f))).mean() \
                <= DIVERGED_CAP, f
        for f in ("throughput", "accum", "pending_nee"):
            assert_frames_close(getattr(ps, f), getattr(js, f))
    # sorted and unsorted waves are the same casts, ray for ray
    hu, hs = p.extend(ps, sort=False), p.extend(ps, sort=True)
    assert torch.equal(hu.t, hs.t) and torch.equal(hu.prim_id, hs.prim_id)
    assert torch.equal(p.connect(ps, sort=False).visibility,
                       p.connect(ps, sort=True).visibility)


def test_carried_frame_matches_jax_buckets_and_uncarried(world):
    """200x200 = 40,000 rays: the JAX package's carried frame sorts live
    prefixes (40,000, then 20,480 and 16,384 rays as the waves thin out);
    the port sorts the whole wave.  Same frame, pixel by pixel (the port
    casts on its cluster tables here)."""
    pr, jr = cams(200, 200)
    p, j = tracers(world, pwf.WavefrontPathTracer, jwf.WavefrontPathTracer)
    p.scene = build_scene_from_tri_array(scene_tris(), device="cpu")
    p.bounds = (p.scene.bvh.aabb_min[0], p.scene.bvh.aabb_max[0])
    assert jwf._prefix_buckets(pr.count) == [40_000, 20_480, 16_384]
    state = p.generate(pr, 3)
    for bounce in range(2):
        state = p.shade(state, p.extend(state), bounce, 2)
    assert int(state.active.sum()) <= 20_480    # a smaller bucket is used
    a, na = p.trace_frame(pr, max_bounces=2, sample_index=3,
                          with_counts=True)
    b, nb = j.trace_frame(jr, max_bounces=2, sample_index=3,
                          with_counts=True)
    assert_frames_close(a, b)
    assert abs(int(na) - int(nb)) <= DIVERGED_CAP * int(nb)
    uncarried = p._trace_frame_stages(pr, max_bounces=2, sample_index=3,
                                      carried=False)
    assert float((a - uncarried).abs().max()) < 1e-4
    assert_frames_close(p.trace_frame_srgb(pr, 2, 3),
                        jsh.to_srgb(jsh.tonemap(b, 1)))


def test_instanced_frame_equals_flat_twin(world):
    """The wavefront frame on ``SceneTLAS.instanced_scene()`` (B1's
    instanced tables, object-space casts) against the flat twin (the
    cluster tables of the world triangles): the same RNG and waves, only
    the cast's arithmetic differs."""
    *_, (pm, pl, pe), _ = world

    def translate(t):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = t
        return m

    tlas = SceneTLAS(device="cpu")
    ball = tlas.add_mesh(meshes.uv_sphere(0.7, 8, 16))
    floor = tlas.add_mesh(meshes.plane(8.0, y=0.0, subdiv=4))
    tlas.add_instance(floor, np.eye(4))
    for t in ((0, 0.8, 0), (1.2, 0.7, 0.5), (-1.5, 1.0, -0.6)):
        tlas.add_instance(ball, translate(t))
    tlas.build_tlas()
    inst = tlas.instanced_scene()
    np.testing.assert_allclose(np_of(inst.bounds[0]), [-4, 0, -4],
                               atol=1e-6)
    pr, _ = cams(48, 32)
    wi = pwf.WavefrontPathTracer(inst, pl, pe, pm, bounds=inst.bounds)
    wf = pwf.WavefrontPathTracer(tlas.flat, pl, pe, pm)
    a = wi.trace_frame(pr, max_bounces=2)
    b = wf.trace_frame(pr, max_bounces=2)
    assert float(a.mean()) > 0.01
    assert_frames_close(a, b)
    # without bounds the instanced frame is the uncarried one
    c = pwf.WavefrontPathTracer(inst, pl, pe, pm).trace_frame(
        pr, max_bounces=2)
    assert float((a - c).abs().max()) < 1e-4


def test_profiler_ranges_split_a_carried_frame(world):
    """A carried-sort frame of 2 bounces runs its casts, sort keys, sorts,
    gathers and unshuffles inside the port's torch.profiler ranges: 3
    extend and 3 connect casts, a whole-state sort after bounces 0 and 1,
    and a sorted connect wave at bounces 1 and 2."""
    from torch.profiler import ProfilerActivity, profile

    *_, (pm, pl, pe), _ = world
    scene = build_scene_from_tri_array(scene_tris(), device="cpu")
    pt = pwf.WavefrontPathTracer(scene, pl, pe, pm)
    pr, _ = cams(24, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pt.trace_frame(pr, max_bounces=2)
    names = [e.name for e in prof.events()]
    assert names.count("cast") == 6
    assert names.count("wavefront.take") == 2
    assert names.count("morton.key") == names.count("morton.sort") == 4
    assert names.count("morton.gather") == names.count(
        "morton.unshuffle") == 2


@pytest.mark.gpu
def test_card_path_trace_equals_cpu(world):
    """The wavefront frame on the card (B1) against the CPU: PCG32 streams
    equal, radiance within PIX_TOL on all but DIVERGED_CAP of pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    *_, (pm, pl, pe), mid = world
    out = []
    for dev in ("cpu", "cuda"):
        def put(s):
            return dataclasses.replace(s, **{
                f.name: getattr(s, f.name).to(dev)
                for f in dataclasses.fields(s)
                if isinstance(getattr(s, f.name), torch.Tensor)})

        scene = build_scene_from_tri_array(scene_tris(), device=dev)
        pt = pwf.WavefrontPathTracer(scene, put(pl), put(pe), put(pm),
                                     mat_id_of_prim=torch.from_numpy(
                                         mid).to(dev))
        rays = cams(64, 48)[0].to(dev)
        out.append((pt.trace_frame(rays, max_bounces=3, sample_index=2),
                    ppt.pixel_seeds(rays.count, 2, dev),
                    ppt.pcg32_float(ppt.pixel_seeds(rays.count, 7, dev))))
    (a, sa, (ra, fa)), (b, sb, (rb, fb)) = out
    assert torch.equal(sb.cpu(), sa) and torch.equal(rb.cpu(), ra)
    assert torch.equal(fb.cpu(), fa)
    assert_frames_close(b, a)
