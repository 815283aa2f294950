"""The port's shading, attributes, textures, HDR files, RayRenderer and
RTReflections against the JAX package's.

Shading state is made once on the JAX side and carried to the port through
the ``*_from_jax`` converters, so both packages shade identical inputs.
Scenes cast on the brute oracle on both sides (the port's renderer is also
run on its cluster tables).  Tolerances: elementwise shading functions
agree to rtol 2e-5 / atol 2e-6 (XLA:CPU and torch round transcendentals
differently at the last ulp), surfaces (normal-mapped normals) to 1e-4;
rendered float AOVs to 5e-4 on every pixel (ulps in linear light, which
the sRGB curve steepens near black), POSITION's wrapped cell coordinates
modulo 1; integer-valued AOVs (HIT_MASK, PRIM_ID) exactly."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import jax_fields, np_of

from messyerraytracer_tpu.core import attributes as jattr
from messyerraytracer_tpu.render import framebuffer as jfb
from messyerraytracer_tpu.render import hdr as jhdr
from messyerraytracer_tpu.render import reflections as jrefl
from messyerraytracer_tpu.render import renderer as jren
from messyerraytracer_tpu.render import shade as jsh
from messyerraytracer_tpu.render import textures as jtex
from messyerraytracer_tpu.render.camera import CameraParams as JCam
from messyerraytracer_tpu.render.camera import generate_rays as jgen
from messyerraytracer_tpu.scene.scene import (
    build_scene_from_tri_array as jax_build)
from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS
from messyerraytracer_tpu_torch.core import attributes as pattr
from messyerraytracer_tpu_torch.render import camera as pcam
from messyerraytracer_tpu_torch.render import framebuffer as pfb
from messyerraytracer_tpu_torch.render import hdr as phdr
from messyerraytracer_tpu_torch.render import reflections as prefl
from messyerraytracer_tpu_torch.render import renderer as pren
from messyerraytracer_tpu_torch.render import shade as psh
from messyerraytracer_tpu_torch.render import textures as ptex
from messyerraytracer_tpu_torch.render.camera import CameraParams
from messyerraytracer_tpu_torch.render.camera import generate_rays
from messyerraytracer_tpu_torch.scene.scene import build_scene_from_tri_array
from messyerraytracer_tpu_torch.utils import meshes

RTOL, ATOL = 2e-5, 2e-6     # elementwise shading functions
IMG_ATOL = 5e-4             # rendered float AOVs, every pixel
W, H = 32, 24


def to_port(jax_struct, conv):
    return conv(**jax_fields(jax_struct), device="cpu")


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np_of(a), np_of(b), rtol=rtol, atol=atol)


def scene_tris():
    return np.concatenate([
        meshes.plane(8.0, y=0.0, subdiv=6),
        meshes.uv_sphere(1.0, 10, 20, center=(0, 1.1, 0)),
        meshes.box((0.8, 1.2, 0.8), center=(1.8, 0.6, -0.5))])


def shading_state(num_tris):
    """JAX-side materials, lights, environments, attributes and atlas."""
    rng = np.random.default_rng(30)
    mats = jsh.make_materials(
        albedo=[[0.8, 0.7, 0.6], [0.3, 0.5, 0.9], [0.9, 0.9, 0.2]],
        metallic=[0.0, 0.8, 0.2], roughness=[0.7, 0.25, 0.02],
        specular=[0.5, 0.6, 0.3],
        emission=[[0, 0, 0], [0, 0, 0], [0.5, 0.2, 0.1]],
        albedo_tex=[1, 0, 2], normal_tex=[0, 3, 0],
        normal_scale=[1.0, 0.7, 1.0])
    lights = jsh.make_lights([
        {"type": jsh.LIGHT_DIRECTIONAL, "direction": (0.3, 1.0, 0.5),
         "energy": 1.2},
        {"type": jsh.LIGHT_POINT, "position": (1.5, 3.0, 2.0),
         "energy": 6.0, "range": 9.0, "attenuation": 1.5},
        {"type": jsh.LIGHT_SPOT, "position": (-2.0, 3.0, 1.0),
         "direction": (0.5, -1.0, -0.2), "energy": 8.0, "range": 12.0,
         "spot_angle": 0.6, "spot_angle_attenuation": 2.0}])
    pan = (rng.random((16, 32, 3)) * 2.0).astype(np.float32)
    envs = [jsh.make_environment(tonemap_mode=m) for m in range(5)]
    envs.append(jsh.make_environment(panorama=pan, panorama_energy=1.5,
                                     tonemap_mode=3))
    uv = rng.uniform(-1.5, 2.5, (num_tris, 3, 2)).astype(np.float32)
    nrm = rng.normal(size=(num_tris, 3, 3)).astype(np.float32)
    tan = np.concatenate([rng.normal(size=(num_tris, 3, 3)),
                          rng.choice([-1.0, 1.0], (num_tris, 3, 1))],
                         axis=2).astype(np.float32)
    tan[::5] = 0.0                                   # absent tangents
    attrs = jattr.make_attributes(num_tris, uv=uv, normals=nrm,
                                  tangents=tan)
    reg = jtex.TextureRegistry(size=8)
    for k in range(3):
        reg.add(rng.random((8 + 3 * k, 6 + k, 3)).astype(np.float32))
    return mats, lights, envs, attrs, reg.build()


def port_state(mats, lights, envs, attrs, atlas):
    return (to_port(mats, psh.materials_from_jax),
            to_port(lights, psh.lights_from_jax),
            [to_port(e, psh.environment_from_jax) for e in envs],
            to_port(attrs, pattr.attributes_from_jax),
            to_port(atlas, ptex.atlas_from_jax))


@pytest.fixture(scope="module")
def world():
    tris = scene_tris()
    js = jax_build(tris, backend="brute")
    ps = build_scene_from_tri_array(tris, backend="brute", device="cpu")
    pc = build_scene_from_tri_array(tris, device="cpu")
    jstate = shading_state(len(tris))
    return js, ps, pc, jstate, port_state(*jstate)


def random_surface_inputs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    x = rng.random(n).astype(np.float32)
    return rng, d, pos, x


def test_brdf_and_light_pieces_match_jax(world):
    *_, (jm, jl, jenvs, _, _), (pm, pl, penvs, _, _) = world
    rng, d, pos, x = random_surface_inputs(512, 31)
    r = rng.uniform(0.04, 1.0, 512).astype(np.float32)
    f0 = rng.random((512, 3)).astype(np.float32)
    T = torch.from_numpy
    J = jnp.asarray
    close(psh.distribution_ggx(T(x), T(r)), jsh.distribution_ggx(J(x), J(r)))
    close(psh.fresnel_schlick(T(x)[:, None], T(f0)),
          jsh.fresnel_schlick(J(x)[:, None], J(f0)))
    close(psh.geometry_smith_ggx(T(x), T(x[::-1].copy()), T(r)),
          jsh.geometry_smith_ggx(J(x), J(x[::-1].copy()), J(r)))
    dist = x * 12.0
    S = torch.tensor
    close(psh.distance_attenuation(T(dist), S(9.0), S(1.5)),
          jsh.distance_attenuation(J(dist), 9.0, 1.5))
    fwd = np.float32([0.5, -1.0, -0.2]) / np.linalg.norm([0.5, -1.0, -0.2])
    close(psh.spot_attenuation(T(d), T(fwd), S(0.6), S(2.0)),
          jsh.spot_attenuation(J(d), J(fwd), J(np.float32(0.6)), 2.0))
    for a, b in zip(psh.direction_to_equirect_uv(T(d)),
                    jsh.direction_to_equirect_uv(J(d))):
        close(a, b)
    for pe, je in zip(penvs, jenvs):
        close(psh.sky_color(T(d), pe), jsh.sky_color(J(d), je))
        close(psh.ambient_color_at(T(d), pe), jsh.ambient_color_at(J(d), je))
    for li in range(3):
        for a, b in zip(psh.light_sample(T(pos), pl, li),
                        jsh.light_sample(J(pos), jl, li)):
            close(a, b)
    pick = rng.integers(0, 3, 512).astype(np.int32)
    for a, b in zip(psh.light_sample_picked(T(pos), pl, T(pick)),
                    jsh.light_sample_picked(J(pos), jl, J(pick))):
        close(a, b)


def hits_of(scene, rays):
    return scene.cast_rays(rays)[0]


def test_surface_and_cook_torrance_match_jax(world):
    js, ps, _, jstate, pstate = world
    jm, jl, _, ja, jt = jstate
    pm, pl, _, pa, pt = pstate
    cam = CameraParams.look_at((3, 4, 6), (0, 0.8, 0), fov_degrees=55)
    jcam = JCam.look_at((3, 4, 6), (0, 0.8, 0), fov_degrees=55)
    pr, jr = generate_rays(cam, W, H, device="cpu"), jgen(jcam, W, H)
    ph, jh = hits_of(ps, pr), hits_of(js, jr)
    np.testing.assert_array_equal(np_of(ph.prim_id), np_of(jh.prim_id))
    mid = (np_of(ph.prim_id).clip(0) % 3).astype(np.int32)
    lit = np.random.default_rng(32).random((3, W * H)) < 0.7
    for attrs_atlas in ((None, None), ((pa, pt), (ja, jt))):
        pkw = jkw = {}
        if attrs_atlas[0] is not None:
            pkw = dict(attrs=pa, atlas=pt)
            jkw = dict(attrs=ja, atlas=jt)
        psf = psh.extract_surface(ph, pr.direction, pm,
                                  torch.from_numpy(mid), **pkw)
        jsf = jsh.extract_surface(jh, jr.direction, jm, jnp.asarray(mid),
                                  **jkw)
        for f in dataclasses.fields(psf):
            close(getattr(psf, f.name), getattr(jsf, f.name), atol=1e-4)
        # 5e-4 relative: the near-mirror lobe (roughness 0.04) steepens
        # the surfaces' last-ulp differences
        close(psh.cook_torrance_multi_light(psf, pl, torch.from_numpy(lit)),
              jsh.cook_torrance_multi_light(jsf, jl, jnp.asarray(lit)),
              rtol=5e-4, atol=1e-4)
        close(psh.cook_torrance_multi_light(psf, pl, None),
              jsh.cook_torrance_multi_light(jsf, jl, None),
              rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("mode", range(5))
def test_tonemaps_and_srgb_match_jax(mode):
    c = np.random.default_rng(33).uniform(-0.5, 12.0, (256, 3)).astype(
        np.float32)
    a = psh.tonemap(torch.from_numpy(c), mode)
    b = jsh.tonemap(jnp.asarray(c), mode)
    close(a, b)
    close(psh.to_srgb(a), jsh.to_srgb(b))
    with pytest.raises(ValueError):
        psh.tonemap(torch.from_numpy(c), 5)


def test_attribute_interpolation_matches_jax(world):
    *_, (_, _, _, ja, _), (_, _, _, pa, _) = world
    rng = np.random.default_rng(34)
    n = 400
    pid = rng.integers(-1, ja.count, n).astype(np.int32)   # -1: a miss
    u = rng.random(n).astype(np.float32) * 0.6
    v = rng.random(n).astype(np.float32) * 0.4
    T, J = torch.from_numpy, jnp.asarray
    close(pattr.interpolate_uv(pa, T(pid), T(u), T(v)),
          jattr.interpolate_uv(ja, J(pid), J(u), J(v)))
    close(pattr.interpolate_normal(pa, T(pid), T(u), T(v)),
          jattr.interpolate_normal(ja, J(pid), J(u), J(v)))
    pt, ps_, ph = pattr.interpolate_tangent(pa, T(pid), T(u), T(v))
    jt, js_, jh = jattr.interpolate_tangent(ja, J(pid), J(u), J(v))
    close(pt, jt)
    np.testing.assert_array_equal(np_of(ps_), np_of(js_))
    np.testing.assert_array_equal(np_of(ph), np_of(jh))
    assert not bool(ph.all())
    nrm = np_of(pattr.interpolate_normal(pa, T(pid), T(u), T(v)))
    samp = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scale = rng.uniform(0, 2, (n, 1)).astype(np.float32)
    close(pattr.perturb_normal(T(nrm), pt, ps_, T(samp), T(scale)),
          jattr.perturb_normal(J(nrm), jt, js_, J(samp), J(scale)))
    close(pattr.perturb_normal(T(nrm), pt, ps_, T(samp), 0.5),
          jattr.perturb_normal(J(nrm), jt, js_, J(samp), 0.5))
    d = pattr.make_attributes(3, face_normals=np.eye(3), device="cpu")
    e = jattr.make_attributes(3, face_normals=np.eye(3))
    for f in ("uv", "normal", "tangent"):
        np.testing.assert_array_equal(np_of(getattr(d, f)),
                                      np_of(getattr(e, f)))
    assert d.count == 3 and d.replace(uv=d.uv * 2).count == 3


def test_texture_sampling_matches_jax(world):
    *_, (_, _, _, _, jt), (_, _, _, _, pt) = world
    np.testing.assert_array_equal(np_of(pt.data), np_of(jt.data))
    assert pt.count == jt.count == 4
    rng = np.random.default_rng(35)
    n = 500
    tid = rng.integers(0, 4, n).astype(np.int32)
    u = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    v = rng.uniform(-2.0, 3.0, n).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    for pf, jf in ((ptex.sample_nearest, jtex.sample_nearest),
                   (ptex.sample_bilinear, jtex.sample_bilinear)):
        close(pf(pt, T(tid), T(u), T(v)), jf(jt, J(tid), J(u), J(v)))
    reg = ptex.TextureRegistry(size=4)
    assert reg.add(np.full((5, 3), 0.25, np.float32)) == 1
    atlas = reg.build(device="cpu")
    assert atlas.data.shape == (2, 4, 4, 3)
    assert float(atlas.data[1].mean()) == pytest.approx(0.25)


def test_hdr_files_match_jax(tmp_path):
    rng = np.random.default_rng(36)
    img = (rng.uniform(0, 1, (16, 32, 3)) ** 2 * 40).astype(np.float32)
    img[0, 0] = 0.0
    a, b = str(tmp_path / "p.hdr"), str(tmp_path / "j.hdr")
    phdr.write_hdr(a, img)
    jhdr.write_hdr(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(phdr.read_hdr(a), jhdr.read_hdr(a))
    # a new-style RLE scanline: a run and a literal span per channel
    w = 16
    body = bytearray([2, 2, w >> 8, w & 0xFF])
    for val in (64, 128, 32, 129):
        body += bytes([128 + 8, val]) + bytes([8] + [val] * 8)
    rle = str(tmp_path / "rle.hdr")
    with open(rle, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + f"-Y 1 +X {w}\n".encode() + bytes(body))
    np.testing.assert_array_equal(phdr.read_hdr(rle), jhdr.read_hdr(rle))
    pan = phdr.load_panorama(a, device="cpu")
    assert isinstance(pan, torch.Tensor) and pan.device.type == "cpu"
    assert phdr.load_panorama(a, device="cpu") is pan        # cached
    np.testing.assert_array_equal(np_of(pan), np_of(jhdr.load_panorama(a)))
    with pytest.raises(ValueError, match="not a Radiance"):
        (tmp_path / "x.hdr").write_bytes(b"P6\n")
        phdr.read_hdr(str(tmp_path / "x.hdr"))


def renderers(world, channels, env_index=3, accumulate=True, scene="brute"):
    js, ps, pc, jstate, pstate = world
    jm, jl, jenvs, ja, jt = jstate
    pm, pl, penvs, pa, pt = pstate
    cam = CameraParams.look_at((3, 4, 6), (0, 0.8, 0), fov_degrees=55)
    jcam = JCam.look_at((3, 4, 6), (0, 0.8, 0), fov_degrees=55)
    mid = np.arange(ja.count, dtype=np.int32) % 3
    pst = pren.RenderSettings(W, H, channels=channels, accumulate=accumulate)
    jst = jren.RenderSettings(W, H, channels=channels, accumulate=accumulate)
    p = pren.RayRenderer(ps if scene == "brute" else pc, cam, pl,
                         penvs[env_index], pm, torch.from_numpy(mid),
                         attributes=pa, atlas=pt, settings=pst,
                         device="cpu")
    j = jren.RayRenderer(js, jcam, jl, jenvs[env_index], jm,
                         jnp.asarray(mid), attributes=ja, atlas=jt,
                         settings=jst)
    return p, j


EXACT = (pfb.HIT_MASK, pfb.PRIM_ID)


def assert_same_frame(pf, jf, channels, pixels=W * H):
    for ch in channels:
        a, b = pf.get(ch), jf.get(ch)
        assert tuple(a.shape) == tuple(b.shape) == (pixels, 4)
        if ch in EXACT:
            np.testing.assert_array_equal(np_of(a), np_of(b), err_msg=ch)
        elif ch == pfb.POSITION:        # cell coordinates wrap at 1
            diff = np.abs(np_of(a) - np_of(b))
            assert np.minimum(diff, 1.0 - diff).max() <= IMG_ATOL, ch
        else:
            np.testing.assert_allclose(np_of(a), np_of(b), rtol=0,
                                       atol=IMG_ATOL, err_msg=ch)


def test_all_aovs_match_jax(world):
    assert pfb.ALL_CHANNELS == jfb.ALL_CHANNELS
    p, j = renderers(world, pfb.ALL_CHANNELS, accumulate=False)
    pf, jf = p.render_frame(), j.render_frame()
    assert_same_frame(pf, jf, pfb.ALL_CHANNELS)
    assert set(p.timings) == set(j.timings)
    assert pf.to_u8().shape == (H, W, 4)
    np.testing.assert_array_equal(pf.to_u8(pfb.NORMAL), jf.to_u8(jfb.NORMAL))
    # the same frame without attributes and atlas (geometric normals,
    # barycentric UVs, flat albedo) and with the panorama sky
    for r in (p, j):
        r.attributes = r.atlas = None
        r.env = (world[4][2][5] if r is p else world[3][2][5])
    assert_same_frame(p.render_frame(), j.render_frame(), pfb.ALL_CHANNELS)


def test_accumulation_and_camera_reset_match_jax(world):
    p, j = renderers(world, (pfb.COLOR,), env_index=1)
    for k in range(3):
        pf, jf = p.render_frame(), j.render_frame()
        assert p._accum_frames == j._accum_frames == k + 1
        assert_same_frame(pf, jf, (pfb.COLOR,))
    assert pren.halton(5, 3) == jren.halton(5, 3)
    p.camera = CameraParams.look_at((-3, 3, 6), (0, 0.8, 0), fov_degrees=55)
    j.camera = JCam.look_at((-3, 3, 6), (0, 0.8, 0), fov_degrees=55)
    pf, jf = p.render_frame(), j.render_frame()
    assert p._accum_frames == j._accum_frames == 1      # reset, then one
    assert_same_frame(pf, jf, (pfb.COLOR,))


def test_cluster_and_instanced_scenes_render_like_brute(world):
    """The renderer on the cluster tables (B1's plain version) and on an
    instanced view of the same triangles equals its brute frame on the hit
    mask and prim ids, and within 1e-4 on color."""
    ch = (pfb.COLOR, pfb.HIT_MASK, pfb.PRIM_ID, pfb.DEPTH)
    ref = renderers(world, ch, accumulate=False)[0].render_frame()
    p, _ = renderers(world, ch, accumulate=False, scene="cluster")
    assert_same_frame(p.render_frame(), ref, ch)
    tlas = SceneTLAS(device="cpu")
    tlas.add_instance(tlas.add_mesh(scene_tris()), np.eye(4))
    tlas.build_tlas()
    p.scene = tlas.instanced_scene()
    assert_same_frame(p.render_frame(), ref, ch)


def test_reflections_match_jax(world):
    js, ps, *_ = world
    cam = CameraParams.look_at((3, 4, 6), (0, 0.8, 0), fov_degrees=55)
    jcam = JCam.look_at((3, 4, 6), (0, 0.8, 0), fov_degrees=55)
    pr, jr = generate_rays(cam, W, H, device="cpu"), jgen(jcam, W, H)
    ph, jh = hits_of(ps, pr), hits_of(js, jr)
    env_p = psh.make_environment(device="cpu")
    env_j = jsh.make_environment()
    pre = prefl.RTReflections(ps, env_p, prefl.ReflectionSettings())
    jre = jrefl.RTReflections(js, env_j, jrefl.ReflectionSettings())
    rng = np.random.default_rng(37)
    for frame in range(2):
        base = rng.random((H, W, 3)).astype(np.float32)
        rough = rng.random((H, W)).astype(np.float32)
        a = pre.render(ph, pr.direction, torch.from_numpy(base),
                       torch.from_numpy(rough), W, H)
        b = jre.render(jh, jr.direction, jnp.asarray(base),
                       jnp.asarray(rough), W, H)
        close(a, b, rtol=1e-4, atol=1e-5)
    assert pre._history is not None
    pre.reset()
    assert pre._history is None


def test_new_entry_points_default_to_the_card():
    from messyerraytracer_tpu_torch.api.service import RayTracerService
    from messyerraytracer_tpu_torch.dispatch import dispatcher  # noqa: F401

    cuda = torch.device("cuda")
    for fn in (RayTracerService.__init__, pren.RayRenderer.__init__,
               psh.make_environment, psh.make_materials,
               psh.default_materials, psh.make_lights,
               psh.materials_from_jax, psh.lights_from_jax,
               psh.environment_from_jax, pattr.make_attributes,
               pattr.attributes_from_jax, ptex.atlas_from_jax,
               ptex.TextureRegistry.build, phdr.load_panorama):
        assert inspect.signature(fn).parameters["device"].default == cuda, fn


def test_profiler_ranges_split_a_frame(world):
    """Each stage of a COLOR frame runs inside its torch.profiler range,
    the two casts (trace and the batched shadow rays) inside ``cast``."""
    from torch.profiler import ProfilerActivity, profile

    _, _, pc, _, (pm, pl, penvs, _, _) = world
    cam = CameraParams.look_at((3, 4, 6), (0, 0.8, 0), fov_degrees=55)
    r = pren.RayRenderer(pc, cam, pl, penvs[0], pm, device="cpu",
                         settings=pren.RenderSettings(W, H))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r.render_frame()
    names = [e.name for e in prof.events()]
    for stage in ("render.raygen", "render.trace", "render.shadows",
                  "render.shade"):
        assert names.count(stage) == 1, stage
    assert names.count("cast") == 2


# the benchmark's primary cells' cameras (raybench/configs/*.json) and frame
# sizes, orbited about y as raybench/kinds/primary_frames.py orbits them
CELL_CAMERAS = (((0.0, 26.0, 55.0), (0.0, 1.0, 0.0), 60.0, (1920, 1080)),
                ((0.0, 14.0, 30.0), (0.0, 2.0, 0.0), 60.0, (1024, 768)))
ORBIT_YAWS = (0.0, 1.0, 90.0, 179.5, 359.0)
BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def orbit(eye, yaw_degrees):
    a = np.deg2rad(yaw_degrees)
    x, y, z = (float(c) for c in eye)
    return (x * np.cos(a) + z * np.sin(a), y, -x * np.sin(a) + z * np.cos(a))


def camera_cases():
    """(camera, width, height, jitter) of the card test: the cells' cameras
    at their sizes and orbit yaws, both jitter extremes, odd sizes, per-pixel
    jitter, orthographic, and an up parallel to the view (+X fallback)."""
    rng = np.random.default_rng(12)
    halton = (pren.halton(1, 2), pren.halton(1, 3))
    persp = CameraParams.look_at((0, 26, 55), (0, 1, 0), fov_degrees=60.0)
    ortho = CameraParams.look_at((0, 2, 5), (0, 0, 0), ortho=True)
    down = CameraParams.look_at((0, 9, 0), (0, 0, 0), up=(0, 1, 0))
    cases = []
    for eye, target, fov, (w, h) in CELL_CAMERAS:
        for yaw in ORBIT_YAWS:
            cam = CameraParams.look_at(orbit(eye, yaw), target,
                                       fov_degrees=fov)
            cases.append((cam, w, h, halton))
        for j in (0.0, BELOW_ONE):
            cases.append((cam, w, h, (j, j)))
    for w, h in ((1, 1), (7, 5), (33, 17)):
        for cam in (persp, ortho, down):
            for jit in ((0.5, 0.5), (0.0, BELOW_ONE),
                        tuple(rng.uniform(0, 1, (h, w)).astype(np.float32)
                              for _ in range(2))):
                cases.append((cam, w, h, jit))
    cases += [(persp, W, H, tuple(rng.uniform(0, 1, (H, W)).astype(
                  np.float32) for _ in range(2))),
              (ortho, W, H, (0.5, 0.5)), (down, 1920, 1080, halton)]
    return cases


@pytest.mark.gpu
def test_camera_rays_on_the_card_equal_cpu():
    """Rays are built on the card, bit for bit the CPU's, by one launch of
    the camera kernel a call: the benchmark cells' cameras at 1920x1080 and
    1024x768 over orbit yaws 0-359, jitter 0 and the largest float32 below
    1, odd sizes, per-pixel jitter, orthographic, and an up parallel to
    the view.  A profiled call links one kernel to ``camera.launch``,
    counts the frame's rays in ``camera.kernel_rays`` and opens none of
    the plain version's stages."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from messyerraytracer_tpu_torch.kernels.camera_rays import cuda_library
    from messyerraytracer_tpu_torch.utils import trace

    for cam, w, h, jit in camera_cases():
        launches = cuda_library.launches
        a = generate_rays(cam, w, h, jitter=jit, device="cuda")
        assert cuda_library.launches == launches + 1
        b = generate_rays(cam, w, h, jitter=jit, device="cpu")
        assert a.origin.device.type == "cuda"
        for f in ("origin", "direction", "t_min", "t_max"):
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), (
                f, cam, w, h)
    cam, w, h, jit = camera_cases()[0]
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        generate_rays(cam, w, h, jitter=jit, device="cuda")
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    linked = [k for e in events if e.name == "camera.launch"
              for k in e.kernels]
    assert len(kernels) == len(linked) == 1, [k.name for k in kernels]
    assert "camera_rays" in linked[0].name
    # the kernel's counter: every ray of the frame, from the one launch
    assert trace.counters() == {"camera.kernel_rays": w * h}
    trace.reset()
    names = {e.name for e in events}
    assert not {"camera.grid", "camera.ndc", "camera.plane", "camera.dirs",
                "camera.length", "camera.unit", "camera.make"} & names


def f64_values(x):
    """What the plain version's ``_f64`` makes of ``x``, as float64."""
    return [float(v) for v in
            pcam._f64(x, torch.device("cpu")).reshape(-1).tolist()]


@pytest.mark.parametrize("case", range(12))
def test_camera_kernel_scalars_equal_the_plain_versions(case):
    """The camera kernel's scalars, rounded to float32 on the host and
    passed by value, are the float32 values the plain version's ``_f64``
    uploads: origin, basis, jitter, width, height, the plane's scales
    (half_w and tan(fov/2), or half_w and half_h), t_min and t_max.  An
    (H, W) jitter goes in by pointer, a scalar pair with none."""
    from messyerraytracer_tpu_torch.kernels.camera_rays import kernel_args

    cpu = torch.device("cpu")
    cases = camera_cases()
    cam, w, h, jit = cases[case * len(cases) // 12]
    if case % 3 == 2:           # the fov and the ortho size vary too
        cam = dataclasses.replace(cam, fov_degrees=17.3 + 11 * case,
                                  ortho_size=0.7 * case)
    planes = [pcam._jitter_plane(j, w, h, cpu) for j in jit]
    outs = [torch.empty(1) for _ in range(4)]
    args = kernel_args(w, h, cam.ortho, cam.origin, cam.basis, planes,
                       pcam._plane_scales(cam, w, h), outs)
    if cam.ortho:
        sx, sy = cam.ortho_size * 0.5 * (w / h), cam.ortho_size * 0.5
    else:
        sy = float(np.tan(np.deg2rad(cam.fov_degrees) * 0.5))
        sx = sy * (w / h)
    rays = generate_rays(cam, 1, 1, device="cpu")
    jitter = [0.0 if isinstance(p, torch.Tensor) else f64_values(j)[0]
              for p, j in zip(planes, jit)]
    want = ([w, h, int(cam.ortho)] + f64_values(cam.origin)
            + f64_values(cam.basis) + jitter
            + [p.data_ptr() if isinstance(p, torch.Tensor) else None
               for p in planes]
            + f64_values([w, h, sx, sy])
            + [float(rays.t_min[0]), float(rays.t_max[0])]
            + [t.data_ptr() for t in outs])
    assert len(args) == len(want) == 29
    for k, (a, b) in enumerate(zip(args, want)):
        assert type(a) is type(b) and a == b, (k, a, b)
        if isinstance(a, float):
            assert np.float32(a).view(np.int32) == np.float32(b).view(
                np.int32), (k, a, b)
    for p, j in zip(planes, jit):
        if isinstance(p, torch.Tensor):
            assert torch.equal(p, pcam._f64(j, cpu).to(torch.float32))


def test_cpu_camera_rays_never_build_or_load_the_kernel(monkeypatch):
    """A CPU call takes the plain version: it neither builds nor loads the
    camera library and counts no launch; the kernel's wrapper refuses a
    CPU device."""
    from messyerraytracer_tpu_torch import native
    from messyerraytracer_tpu_torch.kernels import camera_rays as kcam

    def refuse(*a, **k):
        raise AssertionError("the camera library was asked for")

    loader = kcam.cuda_library
    launches, lib = loader.launches, loader.lib
    monkeypatch.setattr(kcam, "cuda_library", refuse)
    monkeypatch.setattr(native, "build_shared_library", refuse)
    for cam, w, h, jit in camera_cases()[-12:]:
        generate_rays(cam, w, h, jitter=jit, device="cpu")
    assert loader.launches == launches
    assert loader.lib is lib    # None unless a card test loaded it
    with pytest.raises(ValueError, match="CUDA"):
        kcam.camera_rays_cuda(4, 3, False, (0, 0, 0), np.eye(3), (0.5, 0.5),
                              (1.0, 1.0), "cpu")


@pytest.mark.gpu
def test_card_frames_equal_cpu(world):
    """Every AOV rendered on the card (B1 on the cluster tables) against
    the same frame on the CPU: HIT_MASK and PRIM_ID equal, float AOVs
    within 5e-4 (POSITION modulo 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, pc, _, (pm, pl, penvs, pa, pt) = world
    cam = CameraParams.look_at((3, 4, 6), (0, 0.8, 0), fov_degrees=55)
    mid = torch.arange(pa.count, dtype=torch.int64) % 3
    frames = []
    for dev in ("cpu", "cuda"):
        def put(s):
            return dataclasses.replace(s, **{
                f.name: getattr(s, f.name).to(dev)
                for f in dataclasses.fields(s)
                if isinstance(getattr(s, f.name), torch.Tensor)})

        scene = (pc if dev == "cpu" else
                 build_scene_from_tri_array(scene_tris(), device=dev))
        r = pren.RayRenderer(scene, cam, put(pl), put(penvs[3]), put(pm),
                             mid.to(dev), attributes=put(pa),
                             atlas=put(pt), device=dev,
                             settings=pren.RenderSettings(
                                 64, 48, channels=pfb.ALL_CHANNELS))
        frames.append(r.render_frame())
    assert_same_frame(frames[1], frames[0], pfb.ALL_CHANNELS, 64 * 48)
