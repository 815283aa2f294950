"""The port's tracing (``utils/trace.py``): spans, counters and the
request log record only while a profiler records; every span sits at its
call site; the service numbers its requests and logs them on the
profiler's clock; the path tracer's counters add up to its wave rays; the
benchmark's readers of them return numbers on a CPU rehearsal."""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS
from messyerraytracer_tpu_torch.api import service as psvc
from messyerraytracer_tpu_torch.core.types import Rays
from messyerraytracer_tpu_torch.render import shade as psh
from messyerraytracer_tpu_torch.render.camera import (CameraParams,
                                                      generate_rays)
from messyerraytracer_tpu_torch.render.wavefront import WavefrontPathTracer
from messyerraytracer_tpu_torch.scene.scene import build_scene_from_tri_array
from messyerraytracer_tpu_torch.utils import meshes
from messyerraytracer_tpu_torch.utils import trace

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def clean_trace():
    trace.reset()
    yield
    trace.reset()


def tris():
    return np.concatenate([meshes.plane(8.0, y=0.0, subdiv=4),
                           meshes.uv_sphere(1.0, 8, 14, center=(0, 1.1, 0)),
                           meshes.box((0.8, 1.2, 0.8), center=(1.8, 0.6, 0))])


def rand_rays(n: int, seed: int) -> Rays:
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n_ = lambda v: torch.full((n,), v, dtype=torch.float32)  # noqa: E731
    return Rays(torch.from_numpy(o), torch.from_numpy(d), n_(1e-3),
                n_(3.4e38))


def camera_rays(w: int = 24, h: int = 16) -> Rays:
    cam = CameraParams.look_at((0.0, 2.5, 6.0), (0.0, 0.8, 0.0),
                               fov_degrees=50.0)
    return generate_rays(cam, w, h, device=CPU)


def service():
    svc = psvc.RayTracerService(device=CPU)
    svc.register_mesh(tris())
    svc.build()
    return svc


def path_tracer():
    mats = psh.make_materials(albedo=[[0.8, 0.7, 0.6]], metallic=0.0,
                              roughness=0.6, device=CPU)
    lights = psh.make_lights([{"type": psh.LIGHT_DIRECTIONAL,
                               "direction": (0.3, 1.0, 0.5),
                               "energy": 1.3}], device=CPU)
    env = psh.make_environment(device=CPU)
    return WavefrontPathTracer(build_scene_from_tri_array(tris(),
                                                          device=CPU),
                               lights, env, mats)


def tlas():
    t = SceneTLAS(backend="cluster", device=CPU)
    m = t.add_mesh(meshes.uv_sphere(1.0, 8, 14))
    for x in (-2.0, 0.0, 2.0):
        xf = np.eye(4, dtype=np.float32)
        xf[0, 3] = x
        t.add_instance(m, xf)
    t.build_instanced()
    return t


def moved(x: float) -> np.ndarray:
    xf = np.eye(4, dtype=np.float32)
    xf[:3, 3] = (x, 0.5, 0.0)
    return xf


def _submit():
    svc = service()
    rays = rand_rays(512, 1)
    return lambda: svc.submit(psvc.RayQuery(rays=rays))


def _async():
    svc = service()
    rays = rand_rays(512, 2)
    return lambda: svc.collect_async(
        svc.submit_async(psvc.RayQuery(rays=rays)))


def _frame():
    pt, rays = path_tracer(), camera_rays()
    return lambda: pt.trace_frame(rays, max_bounces=2)


def _refit_and_cast():
    t, rays = tlas(), camera_rays()
    return lambda: (t.set_transform(1, moved(0.3)),
                    t.cast_rays_instanced(rays))


def _camera():
    return camera_rays


# (work, [(span, the span that encloses it)]): None = outermost
CALL_SITES = {
    "submit": (_submit, [
        ("service.submit", None), ("dispatch.cast", "service.submit"),
        ("service.wait", "service.submit"),
        ("service.result", "service.submit"),
        ("dispatch.sort", "dispatch.cast"), ("morton.key", "dispatch.sort"),
        ("dispatch.scene", "dispatch.cast"), ("cast", "dispatch.scene"),
        ("cast.hits", "cast")]),
    "submit_async": (_async, [
        ("service.submit", None), ("dispatch.cast", "service.submit"),
        ("cast.hits", "cast"), ("service.collect", None)]),
    "carried_frame": (_frame, [
        ("wavefront.frame", None),
        ("wavefront.generate", "wavefront.frame"),
        ("wavefront.extend", "wavefront.frame"),
        ("cast", "wavefront.extend"),
        ("wavefront.shade", "wavefront.frame"),
        ("wavefront.connect", "wavefront.frame"),
        ("wavefront.sort", "wavefront.connect"),
        ("wavefront.sort", "wavefront.frame"),
        ("wavefront.take", "wavefront.sort"),
        ("wavefront.finalize", "wavefront.frame")]),
    "set_transform_and_cast": (_refit_and_cast, [
        ("tlas.set_transform", None),
        ("refit.set_transforms", "tlas.set_transform"),
        ("refit.inverse", "refit.set_transforms"),
        ("tlas.cast", None), ("cast", "tlas.cast"), ("cast.hits", "cast")]),
    "generate_rays": (_camera, [
        ("camera.look_at", None), ("camera.rays", None)]),
}


def test_off_records_nothing():
    """Without a profiler every span is the one shared no-op, and neither
    the counters nor the request log take anything."""
    assert not trace.recording()
    off = trace.span("a")
    assert trace.span("b") is off
    assert trace.request_span("service.submit", 1) is off
    trace.count("wavefront.live", 5)
    trace.count("wavefront.live", torch.tensor(3))
    svc = service()
    svc.submit(psvc.RayQuery(rays=rand_rays(300, 3)))
    path_tracer().trace_frame(camera_rays(), max_bounces=1)
    assert trace.counters() == {} and trace.requests() == []


@pytest.mark.parametrize("case", sorted(CALL_SITES))
def test_spans_at_their_call_sites(case):
    make, sites = CALL_SITES[case]
    work = make()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
    found = collections.defaultdict(set)
    for e in prof.events():
        p = e.cpu_parent
        while p is not None and p.name.startswith("aten::"):
            p = p.cpu_parent
        found[e.name].add(None if p is None else p.name)
    for name, parent in sites:
        assert name in found, (case, name)
        assert parent in found[name], (case, name, found[name])


def test_rays_take_span():
    rays = rand_rays(64, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rays.take(torch.arange(10))
    assert [e.name for e in prof.events()].count("rays.take") == 1


def test_request_ids_unique_and_increasing():
    svc, other = service(), service()
    rays = rand_rays(300, 5)
    ids = [svc.submit(psvc.RayQuery(rays=rays)).request_id,
           svc.submit_async(psvc.RayQuery(rays=rays)),
           other.submit(psvc.RayQuery(rays=rays)).request_id,
           svc.submit(psvc.RayQuery(rays=rays)).request_id]
    hit = svc.cast_ray((0.0, 3.0, 0.0), (0.0, -1.0, 0.0))
    assert hit["hit"]
    ids.append(svc.submit(psvc.RayQuery(rays=rays)).request_id)
    assert all(b > a for a, b in zip(ids, ids[1:]))
    assert ids[-1] > ids[-2] + 1         # cast_ray took one between
    assert svc.collect_async(ids[1]).request_id == ids[1]


def test_log_on_the_profilers_clock():
    """Each logged ``service.submit`` interval lies within 200 us of its
    profiler event, and the request's spans share its id."""
    svc = service()
    rays = rand_rays(512, 6)
    svc.submit(psvc.RayQuery(rays=rays))        # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rids = [svc.submit(psvc.RayQuery(rays=rays)).request_id
                for _ in range(4)]
        rids.append(svc.submit_async(psvc.RayQuery(rays=rays)))
        svc.collect_async(rids[-1])
    log = trace.requests()
    assert {r for r, *_ in log} == set(rids)
    by_rid = collections.defaultdict(dict)
    for rid, name, a, b in log:
        assert a <= b
        by_rid[rid][name] = (a, b)
    for rid in rids[:4]:
        (a, b), (wa, wb) = by_rid[rid]["service.submit"], \
            by_rid[rid]["service.wait"]
        assert a <= wa <= wb <= b
    assert set(by_rid[rids[-1]]) == {"service.submit", "service.collect"}
    events = sorted((e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "service.submit")
    logged = sorted(v["service.submit"] for v in by_rid.values())
    assert len(events) == len(logged) == 5
    for (ea, eb), (la, lb) in zip(events, logged):
        assert abs(ea - la) <= 200_000 and abs(eb - lb) <= 200_000


def test_request_log_is_bounded(monkeypatch):
    """The log keeps the newest REQUEST_LOG_MAX entries."""
    monkeypatch.setattr(trace, "recording", lambda: True)
    monkeypatch.setattr(trace, "_RANGE",
                        lambda name: trace.contextlib.nullcontext())
    extra = 10
    for rid in range(trace.REQUEST_LOG_MAX + extra):
        with trace.request_span("service.submit", rid):
            pass
    log = trace.requests()
    assert len(log) == trace.REQUEST_LOG_MAX
    assert log[0][0] == extra and log[-1][0] == trace.REQUEST_LOG_MAX + extra - 1


def test_async_results_let_go():
    """Each ticket is held until it is collected once, then dropped."""
    svc = service()
    tickets = [svc.submit_async(psvc.RayQuery(rays=rand_rays(300, s)))
               for s in (7, 8, 9)]
    assert sorted(svc._pending) == sorted(tickets)
    for k, t in enumerate(tickets):
        assert svc.collect_async(t).hits is not None
        assert len(svc._pending) == len(tickets) - k - 1
    assert svc._pending == {}
    with pytest.raises(KeyError):
        svc.collect_async(tickets[0])


@pytest.mark.parametrize("carried", [True, False])
def test_live_counter_equals_wave_rays(carried):
    pt, rays = path_tracer(), camera_rays()
    with profile(activities=[ProfilerActivity.CPU]):
        _, wave = pt._trace_frame_stages(rays, 3, 5, with_counts=True,
                                         carried=carried)
    c = trace.counters()
    assert c["wavefront.live"] == int(wave)
    assert c["wavefront.slots"] == 2 * 4 * rays.count
    assert 0 < c["wavefront.live"] < c["wavefront.slots"]


def test_counters_add_ints_and_tensors():
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("a", 2)
        trace.count("a", torch.tensor(3))
        trace.count("b", 7)
    assert trace.counters() == {"a": 5, "b": 7}
    trace.reset()
    assert trace.counters() == {}


def test_counted_tensors_are_held_not_added():
    """A counted tensor is held as it is and summed only when the
    counters are read: counting runs no tensor op."""
    vals = [torch.tensor(k, dtype=torch.int64) for k in range(1, 6)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for v in vals:
            trace.count("held", v)
        trace.count("held", 10)
    assert not [e.name for e in prof.events() if e.name.startswith("aten::")]
    assert trace.counters() == {"held": 25}
    assert [int(v) for v in vals] == [1, 2, 3, 4, 5]


def test_held_tensors_are_summed_past_the_cap(monkeypatch):
    monkeypatch.setattr(trace, "HELD_MAX", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(1, 8):
            trace.count("held", torch.tensor(k))
    assert len(trace._HELD[("held", CPU)]) == 1    # 1+2+3, +4+5, +6+7
    assert trace.counters() == {"held": 28}


COMP = {"config": {"scene": {"ground_subdiv": 10, "sphere": 8, "boxes": 20}},
        "traffic": {"rays": 4096, "pool_batches": 2, "sample_rays": 1024,
                    "sample_units": 2, "width": 48, "height": 32}}
NEW_METRICS = {
    "composite_99k.service_random_512k": {
        "service_host_ms.submit": True, "service_host_ms_p95.submit": True},
    "composite_99k.pathtrace_640x480_3b": {
        "pt_live_share": True, "shade_ms": False},
}


@pytest.mark.parametrize("workload", sorted(NEW_METRICS))
def test_readers_on_a_rehearsal(workload, monkeypatch):
    """The cell's traced run on the CPU at a cut size, its slice cut to
    the fewest units: the readers of the request log and the counters
    return numbers; ``shade_ms`` reads device time, which a CPU trace has
    none of."""
    import json
    import os

    from raybench import harness

    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    res, _ = harness.run_cell(spec, workload, 2**31 + 977, 0.5, True, "cpu",
                              time.perf_counter(), COMP)
    assert res["correct"] is True
    for name, number in NEW_METRICS[workload].items():
        assert (name in res["metrics"]) == number, (name, res["metrics"])
    got = res["metrics"]
    if "pt_live_share" in got:
        assert 0.0 < got["pt_live_share"]["value"] < 100.0
    if "service_host_ms.submit" in got:
        mean = got["service_host_ms.submit"]["value"]
        assert 0.0 < mean <= got["service_host_ms_p95.submit"]["value"] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("backend,kernel,launch", [
    ("cluster", "cluster_cast_kernel", "b1.launch"),
    ("pallas", "wide_cast_kernel", "b4.launch")])
def test_card_kernel_linked_to_its_launch(backend, kernel, launch):
    """On the card, the profiler links each launch of kernels B1 and B4
    (ctypes) to the span around it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.autograd import DeviceType

    dev = torch.device("cuda")
    scene = build_scene_from_tri_array(tris(), backend=backend, device=dev)
    rays = rand_rays(4096, 10).to(dev)
    scene.cast_rays(rays)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            scene.cast_rays(rays)
        torch.cuda.synchronize()
    events = prof.events()
    by_name = [e for e in events if e.device_type == DeviceType.CUDA
               and kernel in e.name]
    linked = [k for e in events if e.name == launch for k in e.kernels
              if kernel in k.name]
    assert len(by_name) == len(linked) == 2
