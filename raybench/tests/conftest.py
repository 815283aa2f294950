"""Shared sizes of the raybench CPU tests: every cell cut to coarse
meshes (the headline keeps its 215 instances) and a 64x48 frame (160x96
for the animated cell), on the CPU (the port's plain versions stand in
for its kernels)."""

from __future__ import annotations

import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

HEAD = {"config": {"scene": {"terrain_subdiv": 6, "sphere_hi": 8,
                             "sphere_lo": 6}},
        "traffic": {"width": 64, "height": 48, "sample_rays": 512,
                    "sample_units": 2}}
# one mover a frame covers ~0.14% of the frame: a larger frame keeps some
# tens of its rays in the moved sample
ANIM = {"config": HEAD["config"],
        "traffic": dict(HEAD["traffic"], width=160, height=96)}
COMP = {"config": {"scene": {"ground_subdiv": 10, "sphere": 8, "boxes": 20}},
        "traffic": {"rays": 4096, "pool_batches": 2, "sample_rays": 1024,
                    "sample_units": 2, "width": 48, "height": 32}}
CUTS = {"instanced_1m.primary_1080p": HEAD,
        "instanced_1m.animated_1080p": ANIM,
        "composite_99k.service_random_512k": COMP,
        "composite_99k.pathtrace_640x480_3b": COMP}
SEED = 2**31 + 977


@pytest.fixture(scope="session")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def rehearse(spec, workload, trace=False, control=False, seconds=0.5,
             seed=SEED):
    """One run of the cell on the CPU at the cut sizes."""
    from raybench import harness

    return harness.run_cell(spec, workload, seed, seconds, trace, "cpu",
                            time.perf_counter(), CUTS[workload],
                            control=control)
