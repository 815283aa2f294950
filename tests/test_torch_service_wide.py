"""The port's RayTracerService constructed with ``backend="pallas"``: its
flat twin carries kernel B4's 8-wide tables (the plain B4 on the CPU),
sorted nearest and any-hit submits agree with the brute oracle before and
after a refit, and each submit adds its rays to B4's counters.  Services
constructed any other way keep kernel B1's cluster tables."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_port_helpers import assert_parity

from messyerraytracer_tpu_torch.api import service as psvc
from messyerraytracer_tpu_torch.core.brute import (any_hit_brute,
                                                   cast_rays_brute)
from messyerraytracer_tpu_torch.core.types import Rays
from messyerraytracer_tpu_torch.utils import meshes, trace

CPU = torch.device("cpu")
N_RAYS = 320        # over the dispatcher's sorting threshold of 256


def xform(x, y, z, s=1.0):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    m[:3, 3] = (x, y, z)
    return m


def fill(svc):
    """A seeded instanced scene of 296 world triangles: a ground plane,
    three spheres of one mesh and two boxes of another."""
    rng = np.random.default_rng(16)
    svc.register_mesh(meshes.plane(12.0, y=0.0, subdiv=4))
    sphere = svc.register_mesh(meshes.uv_sphere(1.0, 6, 8),
                               xform(-2.0, 1.2, 0.5))
    box = svc.register_mesh(meshes.box((1.0, 1.4, 0.8)), xform(2.5, 0.7, 0))
    s_blas = svc.tlas.instances[sphere].blas_id
    b_blas = svc.tlas.instances[box].blas_id
    for _ in range(2):
        x, z = rng.uniform(-4.0, 4.0, 2)
        svc.add_instance(s_blas, xform(x, 1.5, z, rng.uniform(0.5, 1.2)))
    svc.add_instance(b_blas, xform(-0.5, 0.7, -3.0))
    svc.build()
    return svc


def points(rng, n):
    """Origins as the benchmark draws them: uniform in +-5 with y = |y| +
    0.5."""
    p = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    p[:, 1] = np.abs(p[:, 1]) + 0.5
    return p


def nearest_rays(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays(torch.from_numpy(points(rng, N_RAYS)), torch.from_numpy(d),
                torch.full((N_RAYS,), 1e-3), torch.full((N_RAYS,), 3e38))


def sight_rays(seed):
    """Line-of-sight segments a -> b: t_max = |b - a|."""
    rng = np.random.default_rng(seed)
    a, b = points(rng, N_RAYS), points(rng, N_RAYS)
    length = np.linalg.norm(b - a, axis=1).astype(np.float32)
    d = ((b - a) / length[:, None]).astype(np.float32)
    return Rays(torch.from_numpy(a), torch.from_numpy(d),
                torch.full((N_RAYS,), 1e-3), torch.from_numpy(length))


@pytest.fixture(scope="module")
def wide_service():
    return fill(psvc.RayTracerService(backend="pallas", device=CPU))


def test_pallas_service_holds_wide_tables(wide_service):
    svc = wide_service
    assert svc.get_backend() == "pallas"
    assert svc.tlas.backend == "pallas"
    assert svc.scene.wide is not None and svc.scene.cluster is None
    assert svc.scene.wide.branching == 8
    assert svc.scene.num_tris == 296
    svc.set_backend("cluster")     # no cluster tables: the chain's next
    try:
        assert svc.get_backend() == "pallas"
    finally:
        svc.set_backend("pallas")
    other = psvc.RayTracerService(backend="pallas", device=CPU)
    other.clear_scene()
    assert other.tlas.backend == "pallas"


@pytest.mark.parametrize("backend,resolved", [
    ("auto", "cluster"), ("cluster", "cluster"), ("jnp", "jnp"),
    ("brute", "brute"), ("frontier", "frontier"),
    ("frontier_q", "frontier_q")])
def test_other_backends_keep_cluster_tables(backend, resolved):
    svc = psvc.RayTracerService(backend=backend, device=CPU)
    svc.register_mesh(meshes.uv_sphere(1.0, 4, 6))
    svc.build()
    assert svc.tlas.backend == "cluster"
    assert svc.scene.cluster is not None and svc.scene.wide is None
    assert svc.get_backend() == resolved
    svc.clear_scene()
    assert svc.tlas.backend == "cluster"


def check_against_brute(svc, seed):
    tris = svc.scene.tris
    near = nearest_rays(seed)
    got = svc.submit(psvc.RayQuery(rays=near, coherent=False))
    want, _ = cast_rays_brute(near, tris)
    assert_parity(got.hits, want)
    assert torch.equal(got.hits.hit, want.hit)
    assert int(want.hit.sum()) > N_RAYS // 8
    sight = sight_rays(seed + 1)
    got = svc.submit(psvc.RayQuery(rays=sight, mode=psvc.MODE_ANY_HIT,
                                   coherent=False))
    want = any_hit_brute(sight, tris)
    assert torch.equal(got.hit_flags, want)
    assert 0 < int(want.sum()) < N_RAYS


def test_sorted_submits_equal_brute(wide_service):
    check_against_brute(wide_service, 3)


def test_sorted_submits_equal_brute_after_refit():
    svc = fill(psvc.RayTracerService(backend="pallas", device=CPU))
    before = svc.scene.wide
    svc.set_transform(1, xform(0.5, 2.0, 1.0, 1.3))
    svc.set_transform(4, xform(-1.0, 0.5, 2.5))
    svc.refit()
    assert svc.get_backend() == "pallas"
    assert svc.scene.wide is not None and svc.scene.wide is not before
    assert not torch.equal(svc.scene.wide.node_box.nan_to_num(),
                           before.node_box.nan_to_num())
    check_against_brute(svc, 7)


def test_submits_count_b4_rays(wide_service):
    svc = wide_service
    near = nearest_rays(11).take(torch.arange(40))
    sight = sight_rays(12).take(torch.arange(24))
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            svc.submit(psvc.RayQuery(rays=near, coherent=False))
            svc.submit(psvc.RayQuery(rays=near, coherent=False))
            svc.submit(psvc.RayQuery(rays=sight, mode=psvc.MODE_ANY_HIT,
                                     coherent=False))
        got = trace.counters()
        assert got["b4.rays.nearest"] == 80
        assert got["b4.rays.any_hit"] == 24
        names = [e.name for e in prof.events()]
        assert names.count("b4.hits") == 3
        svc.submit(psvc.RayQuery(rays=near, coherent=False))
        assert trace.counters() == got   # nothing counts unrecorded
    finally:
        trace.reset()


def test_wide_build_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fill(psvc.RayTracerService(backend="pallas", device=CPU))
    assert "wide.build" in [e.name for e in prof.events()]
