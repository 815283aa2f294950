"""The cells ``flat_1m_wide.service_mixed_512k`` (the service on kernel
B4, nearest and line-of-sight batches) and
``composite_99k.primary_1024x768`` (primary frames on the flat 99K scene)
at a CPU size: rehearsals read ``correct``, the bfloat16 control and
planted faults read over the limit, the any-hit judge decides on the
right side of each end of a segment, B4's frozen yardstick and its
readers, and the configuration's recipe."""

from __future__ import annotations

import json
import os
import time
import types

import numpy as np
import pytest
import torch
from conftest import COMP, HEAD, ROOT, SEED
from test_raybench_control import _half_left_out

from raybench import harness
from raybench.reference import judge, occlusion

WIDE = "flat_1m_wide.service_mixed_512k"
PRIMARY = "composite_99k.primary_1024x768"
CUTS = {
    WIDE: {"config": HEAD["config"],
           "traffic": {"rays": 2048, "pool_batches": 4, "sample_rays": 1024,
                       "sample_units": 2}},
    PRIMARY: {"config": COMP["config"],
              "traffic": {"width": 64, "height": 48, "sample_rays": 512,
                          "sample_units": 2}},
}
HERE = os.path.join(ROOT, "raybench")


def rehearse(spec, workload, trace=False, control=False, seconds=0.3):
    return harness.run_cell(spec, workload, SEED, seconds, trace, "cpu",
                            time.perf_counter(), CUTS[workload],
                            control=control)


@pytest.fixture
def short_slice(monkeypatch):
    """A traced slice of the fewest units, to keep the profiler's CPU
    time small."""
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.0)


@pytest.mark.parametrize("workload", sorted(CUTS))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_reads_correct(spec, workload, trace, short_slice):
    res, extras = rehearse(spec, workload, trace=trace)
    assert res["correct"] is True, extras
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in harness.metrics_for(spec, workload, trace)}
    assert set(res["metrics"]) <= want
    assert ("build_s" if trace else "setup_s") in res["metrics"]
    assert set(res["checks"]) == {"bad_ray_share"}
    if workload == WIDE:
        d = extras["details"]        # every kept slot judges both modes
        assert d["rays"] % 1024 == 0 and d["bad_flag"] == 0
        assert d["hits"] > 0 and d["occluded"] > 0
    json.dumps(res)


@pytest.mark.parametrize("workload", sorted(CUTS))
def test_control_fails(spec, workload):
    res, extras = rehearse(spec, workload, control=True)
    assert res["correct"] is True
    assert extras["control"]["bad_ray_share"] > judge.LIMITS["bad_ray_share"]
    if workload == WIDE:
        assert extras["control_details"]["bad_flag"] > 0


def _flags_inverted(monkeypatch):
    """Kernel B4's any-hit answer inverted on every other ray."""
    from messyerraytracer_tpu_torch.kernels import traverse_pallas

    real = traverse_pallas.wide_cast

    def inverted(rays, ws, query_mask=-1, any_hit=False, *a, **k):
        fout, iout, counters = real(rays, ws, query_mask, any_hit, *a, **k)
        if any_hit:
            iout = iout.clone()
            iout[0, ::2] = torch.where(iout[0, ::2] >= 0, -1, 0)
        return fout, iout, counters

    monkeypatch.setattr(traverse_pallas, "wide_cast", inverted)


def _b4_t_long(monkeypatch):
    """Every other ray's t is 0.1% long where kernel B4 produces it."""
    from messyerraytracer_tpu_torch.kernels import traverse_pallas

    real = traverse_pallas.wide_cast

    def long(*a, **k):
        fout, iout, counters = real(*a, **k)
        fout = fout.clone()
        fout[0, ::2] *= 1.001
        return fout, iout, counters

    monkeypatch.setattr(traverse_pallas, "wide_cast", long)


def _flags_unshuffle_lost(monkeypatch):
    """The service returns the any-hit flags in the sorted order."""
    from messyerraytracer_tpu_torch.dispatch import dispatcher

    monkeypatch.setattr(dispatcher, "unshuffle_flags", lambda f, perm: f)


FAULTS = [(WIDE, _flags_inverted), (WIDE, _b4_t_long),
          (WIDE, _flags_unshuffle_lost), (PRIMARY, _half_left_out)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=lambda x: x if isinstance(x, str)
                         else x.__name__.strip("_"))
def test_fault_is_caught(spec, monkeypatch, workload, fault):
    fault(monkeypatch)
    res, extras = rehearse(spec, workload)
    assert res["correct"] is False, (res["checks"], extras["details"])


def test_service_without_b4_stops_in_setup(spec, monkeypatch):
    """A program whose service does not cast on B4 for ``pallas`` (one
    that builds cluster tables whatever its backend, and so casts on the
    per-ray ``jnp`` traversal) cannot run the cell: set-up raises before
    any unit."""
    from messyerraytracer_tpu_torch.api import service

    monkeypatch.setattr(service.RayTracerService, "get_backend",
                        lambda self: "jnp")
    with pytest.raises(RuntimeError, match="cannot run this configuration"):
        rehearse(spec, WIDE)


def _segment(a, b):
    a, b = np.float32(a), np.float32(b)
    d = (b - a) / np.linalg.norm(b - a)
    t = lambda x: torch.as_tensor(np.float32(x))[None]  # noqa: E731
    return t(a), t(d), t(1e-3), t(np.linalg.norm(b - a))


def test_occlusion_judge_sides():
    """A wall at z = 0: a segment through it must be occluded, one that
    stops short must not, one that ends on it may be either."""
    wall = torch.tensor([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0],
                          [0.0, 1.0, 0.0]]], dtype=torch.float64)
    cases = [((0, 0, -2), (0, 0, 2), True), ((0, 0, -2), (0, 0, -1), False),
             ((0, 0, -2), (0, 0, 0), None),
             ((0, 0, -1e-3), (0, 0, 2), None)]
    for a, b, want in cases:
        rays = _segment(a, b)
        for flag in (False, True):
            got = occlusion.bad_flags(torch.tensor([flag]), *rays, wall)
            assert got["bad"] == (want is not None and flag != want), \
                (a, b, flag, got)
        assert got["either"] == (want is None)


def test_yardstick_is_frozen(spec):
    from raybench.metrics import b4_roofline as b4

    y = b4.yardstick(os.path.join(HERE, "metrics"))
    cells = [w for m in spec["per_layer"]
             if m["name"].split(".")[0] == "b4_roofline"
             for w in m["workloads"]]
    assert cells == [WIDE]
    cell = y["cells"][WIDE]
    assert cell["scene_triangles"] == 1000736
    assert set(cell["modes"]) == {"nearest", "any_hit"}
    for mode, c in cell["modes"].items():
        ms, by = b4.least_ms(mode, cell, y)
        assert ms > 0 and by in ("bytes", "operations")
        assert c["counted"] and "placeholder" not in c["counted"]
        assert c["rays_per_call"] == 524288


class FakeTrace:
    """The parts of a ``raybench.trace.Digest`` that B4's readers read."""

    def __init__(self, ranges):
        self.ranges = ranges

    def count(self, name):
        return self.ranges.get(name, (0, 0.0))[0]

    def device_ms(self, name):
        r = self.ranges.get(name)
        return None if r is None else r[1]


def test_b4_readers_on_a_trace(monkeypatch):
    from messyerraytracer_tpu_torch.utils import trace

    b4 = harness.reader("b4_roofline.submit")
    epi = harness.reader("b4_epilogue_ms.submit")
    y = b4.yardstick(os.path.join(HERE, "metrics"))
    cell = y["cells"][WIDE]
    ctx = types.SimpleNamespace(
        cell=WIDE, here=os.path.join(HERE, "metrics"),
        trace=FakeTrace({"b4.launch": (4, 8.0), "cast": (4, 10.0)}))
    monkeypatch.setattr(trace, "counters", lambda: {
        "b4.rays.nearest": 3 * 524288, "b4.rays.any_hit": 2 * 524288})
    least = (3 * b4.least_ms("nearest", cell, y)[0]
             + 2 * b4.least_ms("any_hit", cell, y)[0]) / 5
    assert b4.read(ctx) == pytest.approx(100.0 * 4 * least / 8.0)
    assert epi.read(ctx) == pytest.approx(0.5)
    ctx.trace = FakeTrace({"cast": (4, 10.0)})
    assert b4.read(ctx) is None and epi.read(ctx) is None
    monkeypatch.setattr(trace, "counters", lambda: {})
    ctx.trace = FakeTrace({"b4.launch": (4, 8.0), "cast": (4, 10.0)})
    assert b4.read(ctx) is None


def test_recipe_makes_the_stated_scene():
    from raybench.scenes import headline

    with open(os.path.join(HERE, "configs", "flat_1m_wide.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "configs", "instanced_1m.json")) as f:
        assert cfg["scene"] == json.load(f)["scene"]
    inputs = headline.make(cfg["scene"])
    assert cfg["counts"] == {
        "meshes": len(inputs["meshes"]),
        "instances": len(inputs["instances"]),
        "world_tris": sum(inputs["meshes"][m].shape[0]
                          for m, _ in inputs["instances"])} == {
        "meshes": 4, "instances": 215, "world_tris": 1000736}
