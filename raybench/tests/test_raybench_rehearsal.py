"""Each traffic mix rehearsed on the CPU at a cut size: the result has the
contract's shape, the program agrees with the reference, nothing of JAX
is loaded, and without a card the command exits non-zero and prints no
result."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from conftest import CUTS, ROOT, SEED, rehearse

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", sorted(CUTS))
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_line(spec, workload, trace):
    from raybench import harness

    res, extras = rehearse(spec, workload, trace=trace)
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert res["correct"] is True, extras
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in harness.metrics_for(spec, workload, trace)}
    assert set(res["metrics"]) <= want
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] == v["value"]
    if trace:
        assert "build_s" in res["metrics"]
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert "setup_s" in res["metrics"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)


def test_banned_names_are_compared_whole(monkeypatch):
    from raybench import run

    for name in ("jax.numpy", "messyerraytracer_tpu.core", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    found = run.banned_modules()
    assert "jax.numpy" in found and "messyerraytracer_tpu.core" in found
    assert "jaxtyping" not in found
    assert not any(m.startswith("messyerraytracer_tpu_torch") for m in found)


def test_rehearsal_loads_no_jax():
    code = ("import json, sys, time; sys.path.insert(0, %r); "
            "sys.path.insert(0, %r); from conftest import rehearse; "
            "spec = json.load(open(%r)); "
            "rehearse(spec, 'composite_99k.service_random_512k'); "
            "from raybench.run import banned_modules; "
            "print(json.dumps(banned_modules()))"
            % (ROOT, os.path.dirname(__file__),
               os.path.join(ROOT, "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _command(args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-m", "raybench"] + args,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(["--workload", "instanced_1m.primary_1080p", "--seed",
                    str(SEED), "--seconds", "1", "--trace", "0"], env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_exits_nonzero(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "raybench"), tmp_path / "raybench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _command(["--workload", "instanced_1m.primary_1080p", "--seed",
                    "3", "--seconds", "1"], cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
