"""PyTorch port: multi-device casts (parallel/sharding.py) on meshes of CPU
entries, as the JAX suite runs its sharded casts on 8 virtual CPU devices.

The ray-sharded cast must equal the unsharded cast bit for bit, hits,
occluded flags and summed stats alike, on B1's and B4's plain versions; the
scene-sharded cast is held against the brute oracle, the unsharded pallas
cast and, once at 2 shards x 2,048 rays, the JAX package's (its B4 in
interpret mode); the sharded render step against ``PathTracer`` run shard
by shard, and the dry run end to end."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from messyerraytracer_tpu.parallel import sharding as jsh  # noqa: E402

from messyerraytracer_tpu_torch.core.brute import cast_rays_brute  # noqa
from messyerraytracer_tpu_torch.parallel import sharding as psh  # noqa
from messyerraytracer_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip,
)
from messyerraytracer_tpu_torch.render.camera import (  # noqa: E402
    CameraParams,
    generate_rays,
)
from messyerraytracer_tpu_torch.render.pathtrace import (  # noqa: E402
    PathTraceParams,
    PathTracer,
)
from messyerraytracer_tpu_torch.render.shade import (  # noqa: E402
    default_materials,
    make_environment,
    make_lights,
)
from messyerraytracer_tpu_torch.scene.scene import (  # noqa: E402
    build_scene_from_tri_array,
)
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_parity,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
    small_tris,
)

HIT_FIELDS = ("t", "position", "normal", "u", "v", "prim_id", "hit_layers")
STAT_FIELDS = ("rays_cast", "tri_tests", "bvh_nodes_visited", "hits",
               "stack_drops")
CPU8 = ["cpu"] * 8


def scene_tris():
    return np.concatenate([
        meshes.uv_sphere(1.0, 8, 16, center=(-1.5, 0, 0)),
        meshes.uv_sphere(0.7, 8, 16, center=(1.5, 0.3, 0)),
        meshes.plane(8.0, y=-1.2, subdiv=6)])


@pytest.fixture(scope="module")
def flat_scenes():
    tris = small_tris()
    return {b: build_scene_from_tri_array(tris, backend=b, device="cpu")
            for b in ("cluster", "pallas")}


def sharded_rays(n, seed):
    o, d = rand_rays_np(n, seed=seed)
    t_max = np.full(n, 3.402823466e38, np.float32)
    t_max[::53] = -1.0
    return port_rays(o, d, t_max=t_max)


@pytest.mark.parametrize("backend", ["cluster", "pallas"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("n", [15384, 1000])
def test_ray_sharded_cast_bit_equal(flat_scenes, backend, any_hit, n):
    """8 shards (15,384 rays: JAX's boundaries put 2,048 rays on each of
    the first 7 and 1,048 on the last; 1,000 rays: all on shard 0) equal
    the unsharded cast bit for bit: every hit field, the occluded flags
    and every summed stat, stack_drops included."""
    scene = flat_scenes[backend]
    mesh = psh.make_mesh(8, devices=CPU8)
    rays = sharded_rays(n, seed=n)
    assert [e - s for _, s, e in psh._shard_bounds(n, 8)] == (
        [2048] * 7 + [1048] if n == 15384 else [1000])
    hits, stats, occ = psh.cast_rays_sharded(rays, scene, mesh,
                                             any_hit=any_hit)
    cast = psh._shard_cast(psh._cast_tables(scene), rays, -1, any_hit)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(hits, f), getattr(cast[0], f)), f
    assert torch.equal(occ, cast[2])
    for f in STAT_FIELDS:
        assert int(getattr(stats, f)) == int(getattr(cast[1], f)), f
    assert int(stats.rays_cast) == n


def test_scene_sharded_cast_against_brute_pallas_and_jax():
    """4 Morton shards against the brute oracle and the unsharded pallas
    cast; 2 shards against the JAX package's scene-sharded cast (its own
    shards: the same Morton split and trees)."""
    tris = scene_tris()
    single = build_scene_from_tri_array(tris, backend="pallas", device="cpu")
    rays = sharded_rays(2048, seed=7)
    stacked, meta, id_maps = psh.build_sharded_scene(
        tris, 4, psh.make_mesh(devices=["cpu"] * 4))
    assert meta["branching"] == 8 and len(stacked) == 4
    assert sorted(np.concatenate([np_of(m) for m in id_maps])) == list(
        range(len(tris)))
    assert max(w.leaf_tri.shape[0] for w in stacked) < (
        single.wide.leaf_tri.shape[0] / 2)
    h4, s4 = psh.cast_rays_scene_sharded(rays, stacked, meta, id_maps,
                                         ["cpu"] * 4)
    hb, _ = cast_rays_brute(rays, single.tris)
    assert_parity(h4, hb)
    h1, _ = single.cast_rays(rays)
    same = assert_parity(h4, h1)
    for f in ("u", "v", "normal", "position", "hit_layers"):
        assert torch.equal(getattr(h4, f)[torch.as_tensor(same)],
                           getattr(h1, f)[torch.as_tensor(same)]), f
    assert int(s4.hits) == int(h1.hit.sum()) and int(s4.rays_cast) == 2048
    assert int(s4.stack_drops) == 0

    # the JAX package's, on 2 of the 8 virtual CPU devices
    o, d = (np_of(x) for x in (rays.origin, rays.direction))
    tmn, tmx = np_of(rays.t_min), np_of(rays.t_max)
    js, jm, ji = jsh.build_sharded_scene(tris, 2)
    hj, sj = jsh.cast_rays_scene_sharded(jax_rays(o, d, tmn, tmx), js, jm,
                                         ji, jsh.make_mesh(2))
    stacked2, meta2, id2 = psh.build_sharded_scene(tris, 2, ["cpu"] * 2)
    for k in range(2):
        np.testing.assert_array_equal(np_of(id2[k]),
                                      np.asarray(ji[k])[:len(id2[k])])
    h2, _ = psh.cast_rays_scene_sharded(rays, stacked2, meta2, id2,
                                        ["cpu"] * 2)
    same = assert_parity(h2, hj)
    np.testing.assert_array_equal(np_of(h2.hit), np_of(hj.hit))
    np.testing.assert_allclose(np_of(h2.u)[same], np_of(hj.u)[same],
                               atol=1e-5)
    assert int(jax.device_get(sj.hits)) == int(h2.hit.sum())
    with pytest.raises(ValueError, match="cannot fill"):
        psh.build_sharded_scene(tris[:3], 4, ["cpu"] * 4)


def test_render_step_sharded_is_shard_by_shard_path_tracing():
    """The sharded render step at 128 x 32, 1 bounce, on 2 CPU entries:
    2,048 pixels a shard, each traced by PathTracer on its shard's camera
    rays alone — PCG32 seeded from the shard-local pixel index, as JAX
    does under shard_map — bit for bit."""
    scene = build_scene_from_tri_array(scene_tris(), device="cpu")
    cam = CameraParams.look_at((0, 0.5, 4), (0, 0, 0), fov_degrees=60.0)
    lights = make_lights([{"type": 0, "direction": (0.3, 1.0, 0.4),
                           "energy": 1.2}], device="cpu")
    env = make_environment(device="cpu")
    img = psh.render_step_sharded(scene, cam, 128, 32, ["cpu"] * 2,
                                  lights=lights, env=env, max_bounces=1)
    assert tuple(img.shape) == (4096, 3) and bool(torch.isfinite(img).all())
    rays = generate_rays(cam, 128, 32, device="cpu")
    pt = PathTracer(psh._ShardScene(scene.cluster), lights, env,
                    default_materials(device="cpu"))
    params = PathTraceParams(128, 32, max_bounces=1)
    want = torch.cat([pt.trace_frame(params, rays.take(slice(s, s + 2048)))
                      for s in (0, 2048)])
    assert torch.equal(img, want)
    assert float(img.mean()) > 0.0


def test_dryrun_multichip_on_cpu():
    out = dryrun_multichip(2, device="cpu")
    assert out["devices"] == ["cpu", "cpu"] and out["rays"] == 2048
    assert out["hit_rate"] > 0.0


def test_make_mesh(monkeypatch):
    """No argument: every visible CUDA device, an error without one; more
    devices than exist raise rather than shrink; an explicit list may
    repeat an entry."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psh.make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert psh.make_mesh() == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="4 devices"):
        psh.make_mesh(4)
    assert psh.make_mesh(4, devices=["cuda:0"] * 4) == [
        torch.device("cuda", 0)] * 4
    assert psh.make_mesh(2, devices=CPU8) == [torch.device("cpu")] * 2
