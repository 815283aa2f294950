"""The benchmark's terrain cell (``terrain_2m.primary_1024x768``) and
kernel B1's work counters: the frozen recipe equals the port's 2M
terrain bit for bit; the cell rehearsed on the CPU at a cut reads
``correct`` untraced and traced, its bfloat16 control does not, and its
tests-a-ray metric is the casts' own ``RayStats``; every B1 cast adds its
rays, triangle tests, pops and stack drops to the counters ``b1.*`` while
a profiler records, and nothing otherwise."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from messyerraytracer_tpu_torch import bench
from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS
from messyerraytracer_tpu_torch.core.types import Rays
from messyerraytracer_tpu_torch.kernels.cluster_v2 import cast_rays_cluster_v2
from messyerraytracer_tpu_torch.scene import scene as pscene
from messyerraytracer_tpu_torch.utils import meshes
from messyerraytracer_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CELL = "terrain_2m.primary_1024x768"
CUT = {"config": {"scene": {"subdiv": 24}},
       "traffic": {"width": 64, "height": 48, "sample_rays": 256,
                   "sample_units": 2}}
SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def clean_trace():
    trace.reset()
    yield
    trace.reset()


def test_recipe_is_the_ports_2m_terrain():
    """The frozen copy has not drifted from ``bench.tris_2m()``."""
    from raybench.scenes import terrain

    with open(os.path.join(ROOT, "raybench", "configs",
                           "terrain_2m.json")) as f:
        cfg = json.load(f)
    got = terrain.make(cfg["scene"])
    assert len(got["meshes"]) == 1 and len(got["instances"]) == 1
    assert np.array_equal(got["instances"][0][1], np.eye(4))
    g = got["meshes"][0]
    del got
    want = bench.tris_2m()
    assert g.shape == want.shape == (2016032, 3, 3)
    assert cfg["counts"]["world_tris"] == g.shape[0]
    assert np.array_equal(g.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("mode", ["untraced", "traced", "control"])
def test_cell_rehearsal(mode, monkeypatch):
    """The cell on the CPU at a cut: the program reads ``correct``; traced,
    ``b1_tests_per_ray.frame`` is the traced casts' summed
    ``RayStats.tri_tests`` over their rays; the bfloat16 control in the
    program's place reads over the limit."""
    from raybench import harness

    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)
    seen = []
    cast = pscene.RayScene.cast_rays

    def counted(self, rays, *a, **k):
        hits, stats = cast(self, rays, *a, **k)
        if trace.recording():
            seen.append((int(stats.tri_tests), int(stats.rays_cast)))
        return hits, stats

    monkeypatch.setattr(pscene.RayScene, "cast_rays", counted)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    res, extras = harness.run_cell(spec, CELL, SEED, 0.5, mode == "traced",
                                   "cpu", time.perf_counter(), CUT,
                                   control=mode == "control")
    assert res["correct"] is True, extras
    assert set(res["checks"]) == {"bad_ray_share"}
    assert extras["details"]["rays"] in (256, 2 * 256)  # units kept: 1-2
    assert extras["details"]["hits"] > 0
    got = res["metrics"]
    if mode == "traced":
        assert set(got) == {"build_s", "b1_tests_per_ray.frame"}
        tests, rays = (sum(x) for x in zip(*seen))
        assert rays == len(seen) * 64 * 48
        assert got["b1_tests_per_ray.frame"]["value"] == tests / rays
        assert trace.counters()["b1.stack_drops"] == 0
    else:
        assert set(got) == {"frame_ms", "setup_s"} and seen == []
    if mode == "control":
        limit = harness.LIMITS["bad_ray_share"]
        assert extras["control"]["bad_ray_share"] > 10 * limit


def _rays(n: int, seed: int) -> Rays:
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    full = lambda v: torch.full((n,), v, dtype=torch.float32)  # noqa: E731
    return Rays(torch.from_numpy(o), torch.from_numpy(d), full(1e-3),
                full(3.4e38))


def _flat_cast():
    tris = np.concatenate([meshes.plane(8.0, y=0.0, subdiv=6),
                           meshes.uv_sphere(1.0, 8, 14, center=(0, 1.1, 0))])
    cs = pscene.build_scene_from_tri_array(tris, device=CPU).cluster
    return lambda rays, any_hit: cast_rays_cluster_v2(rays, cs,
                                                      any_hit=any_hit)[1]


def _instanced_cast():
    t = SceneTLAS(backend="cluster", device=CPU)
    m = t.add_mesh(meshes.uv_sphere(1.0, 8, 14))
    for x in (-2.0, 0.0, 2.0):
        xf = np.eye(4, dtype=np.float32)
        xf[0, 3] = x
        t.add_instance(m, xf)
    t.build_instanced()
    return lambda rays, any_hit: t.cast_rays_instanced(
        rays, any_hit=any_hit)[1]


@pytest.mark.parametrize("recording", [True, False])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("make", [_flat_cast, _instanced_cast],
                         ids=["flat", "instanced"])
def test_b1_counters(make, any_hit, recording):
    """While a profiler records, a B1 cast adds its ray count and its
    ``RayStats``' triangle tests, pops and stack drops to ``b1.*``;
    without one, nothing."""
    cast, rays = make(), _rays(600, 5)
    if not recording:
        stats = cast(rays, any_hit)
        assert int(stats.tri_tests) > 0
        assert not any(k.startswith("b1.") for k in trace.counters())
        return
    with profile(activities=[ProfilerActivity.CPU]):
        stats = [cast(rays, any_hit) for _ in range(2)]
    got = trace.counters()
    assert got["b1.rays"] == 2 * rays.count
    assert got["b1.tri_tests"] == sum(int(s.tri_tests) for s in stats) > 0
    assert got["b1.pops"] == sum(int(s.bvh_nodes_visited) for s in stats)
    assert got["b1.stack_drops"] == 0
