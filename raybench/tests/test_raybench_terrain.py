"""The cell ``terrain_2m.primary_1024x768`` (primary frames on the flat
2M terrain, kernel B1 at T=64): every metric it reports has a reader, the
frozen yardstick of ``b1_frame_roofline`` holds it, and that reader gives
``b1_roofline``'s formula on a fake trace."""

from __future__ import annotations

import os
import types

import pytest
from conftest import ROOT

from raybench import harness

CELL = "terrain_2m.primary_1024x768"
HERE = os.path.join(ROOT, "raybench", "metrics")


@pytest.mark.parametrize("trace", [False, True])
def test_every_metric_of_the_cell_has_a_reader(spec, trace):
    names = [m["name"] for m in harness.metrics_for(spec, CELL, trace)]
    assert names
    for n in names:
        assert callable(harness.reader(n).read), n
    if trace:
        assert {"b1_frame_roofline", "b1_tests_per_ray.frame",
                "device_idle_pct.frame", "build_s"} <= set(names)
    else:
        assert set(names) == {"frame_ms", "setup_s"}


def test_yardstick_holds_the_cell(spec):
    y = harness.reader("b1_frame_roofline").yardstick(HERE)
    b1 = harness.load_json(HERE, "b1_roofline.json")
    assert y["peaks"] == b1["peaks"]
    assert y["instructions"] == b1["instructions"]
    assert set(y["cells"]) == {CELL}
    c = y["cells"][CELL]
    assert c["rays_per_call"] == 1024 * 768
    assert c["scene_triangles"] == 2016032
    assert c["instances"] == 0 and c["children_per_node"] == 8
    assert c["nodes_per_ray"] > 0 and c["tri_tests_per_ray"] > 0
    assert c["counted"] and "placeholder" not in c["counted"]


class FakeDigest:
    """The parts of a ``raybench.trace.Digest`` that B1's readers read."""

    def __init__(self, b1_us):
        self.b1_us = b1_us

    @property
    def b1_ms(self):
        return sum(self.b1_us) / 1e3


def test_frame_roofline_is_b1_rooflines_formula():
    b1 = harness.reader("b1_roofline")
    frame = harness.reader("b1_frame_roofline")
    y = frame.yardstick(HERE)
    ctx = types.SimpleNamespace(cell=CELL, here=HERE,
                                trace=FakeDigest([1500.0, 1700.0]))
    least, by = b1.least_ms(y["cells"][CELL], y)
    assert by in ("bytes", "operations")
    assert frame.read(ctx) == pytest.approx(100.0 * least / 1.6)
    ctx.trace = FakeDigest([])
    assert frame.read(ctx) is None
    ctx.trace, ctx.cell = FakeDigest([1500.0]), "composite_99k.primary_1024x768"
    assert frame.read(ctx) is None
