"""BENCHMARK.json and the files it names: present, parseable, and within
the benchmark contract's limits on names, units and shapes."""

from __future__ import annotations

import json
import os
import re

import pytest
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HERE = os.path.join(ROOT, "raybench")


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["raybench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for word in spec["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word


def test_names_and_units(spec):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("kind", ["configs", "traffic"])
def test_cell_files_parse(spec, kind):
    key = "config" if kind == "configs" else "traffic"
    for w in spec["workloads"]:
        with open(os.path.join(HERE, kind, w[key] + ".json")) as f:
            data = json.load(f)
        if kind == "traffic":
            assert os.path.exists(os.path.join(HERE, "kinds",
                                               data["kind"] + ".py"))
        else:
            assert os.path.exists(os.path.join(HERE, "scenes",
                                               data["recipe"] + ".py"))
            assert data["reduced"] == []


@pytest.mark.parametrize("config", ["instanced_1m", "composite_99k"])
def test_recipe_makes_the_stated_scene(config):
    import importlib

    with open(os.path.join(HERE, "configs", config + ".json")) as f:
        cfg = json.load(f)
    inputs = importlib.import_module(
        f"raybench.scenes.{cfg['recipe']}").make(cfg["scene"])
    assert cfg["counts"] == {
        "meshes": len(inputs["meshes"]),
        "instances": len(inputs["instances"]),
        "world_tris": sum(inputs["meshes"][m].shape[0]
                          for m, _ in inputs["instances"])}


def test_configs(spec):
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert c["file"] == f"raybench/configs/{c['name']}.json"
        assert c["source"] and len(c["source"]) <= 200
        for k in c["reduced"]:
            assert NAME.match(k)


def test_every_metric_has_a_reader(spec):
    from raybench import harness

    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]).read), m["name"]


def test_one_reader_per_quantity(spec):
    """Every reader serves some metric, and a suffixed name
    (``epilogue_ms.submit``) finds the reader of the name before its
    first dot."""
    from raybench import harness

    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    files = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
             if f.endswith(".py")}
    assert files == {n.split(".")[0] for n in names} | {
        n for n in names if n in files}
    assert harness.reader("epilogue_ms.submit").__file__.endswith(
        os.path.join("metrics", "epilogue_ms.py"))


def test_cells_report_enough(spec):
    from raybench import harness

    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["layer"] and "\n" not in m["layer"]
        for w in m.get("workloads", []):
            moved = next(x for x in spec["end_to_end"]
                         if x["name"] == m["moves"])
            assert w in moved.get("workloads", [w])
    for w in spec["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        got = {m["name"] for m in harness.metrics_for(spec, w["name"], False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.metrics_for(spec, w["name"], True)


def test_limits_cover_every_number():
    from raybench.reference import judge

    assert set(judge.LIMITS) == {"bad_ray_share", "bad_moved_share",
                                 "bad_pixel_share", "wave_rays_gap"}
    assert all(0 < v < 1 for v in judge.LIMITS.values())


def test_yardstick_is_frozen(spec):
    from raybench.metrics import b1_roofline as b1

    y = b1.yardstick(os.path.join(HERE, "metrics"))
    cells = [w for m in spec["per_layer"]
             if m["name"].split(".")[0] == "b1_roofline"
             for w in m["workloads"]]
    assert len(cells) == 2
    for w in cells:
        c = y["cells"][w]
        ms, by = b1.least_ms(c, y)
        assert ms > 0 and by in ("bytes", "operations")
        assert c["counted"]
