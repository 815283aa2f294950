"""The comparison that decides ``correct`` has to fail what it guards
against, at a size a test run holds: the control (the plain reference in
the program's place, in bfloat16) reads over a limit in every cell, and
each fault a cell can have, planted under the timed path, turns
``correct`` false.  The harness's look for a card is skipped: these runs
drive the rest of a run on the CPU."""

from __future__ import annotations

import pytest
import torch
from conftest import CUTS, rehearse

from raybench.reference import judge


@pytest.mark.parametrize("workload", sorted(CUTS))
def test_control_fails(spec, workload):
    res, extras = rehearse(spec, workload, control=True)
    assert res["correct"] is True
    over = {n: v for n, v in extras["control"].items()
            if v > judge.LIMITS[n]}
    assert over, extras["control"]


def _answer_altered(monkeypatch):
    """Every other ray's t is 0.1% long where kernel B1 produces it."""
    from messyerraytracer_tpu_torch.kernels import cluster_v2

    real = cluster_v2.cluster_cast

    def altered(rays, cs, *a, **k):
        fout, iout, counters = real(rays, cs, *a, **k)
        fout = fout.clone()
        fout[0, ::2] *= 1.001
        return fout, iout, counters

    monkeypatch.setattr(cluster_v2, "cluster_cast", altered)


def _half_left_out(monkeypatch):
    """Kernel B1 casts the first half of each batch; the rest miss."""
    from messyerraytracer_tpu_torch.core.types import Rays
    from messyerraytracer_tpu_torch.kernels import cluster_v2

    real = cluster_v2.cluster_cast

    def half(rays, cs, *a, **k):
        n = rays.count
        m = n // 2
        fout, iout, counters = real(
            Rays(*(x[:m] for x in (rays.origin, rays.direction,
                                   rays.t_min, rays.t_max))), cs, *a, **k)
        fo = torch.zeros((6, n), dtype=fout.dtype)
        io = torch.full((5, n), -1, dtype=iout.dtype)
        fo[:, :m], io[:, :m] = fout, iout
        return fo, io, counters

    monkeypatch.setattr(cluster_v2, "cluster_cast", half)


def _moves_lost(monkeypatch):
    """``set_transform`` returns with the scene unchanged."""
    from messyerraytracer_tpu_torch.accel import tlas

    monkeypatch.setattr(tlas.SceneTLAS, "set_transform",
                        lambda self, i, xf: None)


def _moved_instance_vanishes(monkeypatch):
    """``set_transform`` puts the moved instance out of every ray's
    reach (far behind the camera), as a refit that drops it would."""
    from messyerraytracer_tpu_torch.accel import tlas

    real = tlas.SceneTLAS.set_transform

    def gone(self, i, xf):
        xf = xf.copy()
        xf[2, 3] += 1.0e5
        real(self, i, xf)

    monkeypatch.setattr(tlas.SceneTLAS, "set_transform", gone)


def _rng_stuck(monkeypatch):
    """The path tracer's PCG32 step returns its state unchanged."""
    from messyerraytracer_tpu_torch.render import pathtrace, wavefront

    real = pathtrace.pcg32_float

    def stuck(state):
        return state, real(state)[1]

    monkeypatch.setattr(pathtrace, "pcg32_float", stuck)
    monkeypatch.setattr(wavefront, "pcg32_float", stuck)


def _unshuffle_lost(monkeypatch):
    """The service returns the hits in the sorted order."""
    from messyerraytracer_tpu_torch.dispatch import dispatcher

    monkeypatch.setattr(dispatcher, "unshuffle_hits", lambda h, perm: h)


FAULTS = {
    "instanced_1m.primary_1080p": [_answer_altered, _half_left_out],
    "composite_99k.service_random_512k": [_answer_altered, _half_left_out,
                                          _unshuffle_lost],
    "composite_99k.pathtrace_640x480_3b": [_answer_altered, _half_left_out,
                                           _rng_stuck],
    "instanced_1m.animated_1080p": [_answer_altered, _half_left_out,
                                    _moves_lost, _moved_instance_vanishes],
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, fs in sorted(FAULTS.items()) for f in fs],
    ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_fault_is_caught(spec, monkeypatch, workload, fault):
    fault(monkeypatch)
    res, extras = rehearse(spec, workload)
    assert res["correct"] is False, (res["checks"], extras["details"])


def test_vanished_instance_fails_the_moved_sample(spec, monkeypatch):
    """A moved instance that the program no longer hits is judged on the
    rays that the reference sends at it, not only on the program's."""
    _moved_instance_vanishes(monkeypatch)
    res, extras = rehearse(spec, "instanced_1m.animated_1080p")
    moved = res["checks"]["bad_moved_share"]
    assert moved["value"] > moved["limit"], extras["details"]
