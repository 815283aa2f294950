"""The port's headline benchmark (messyerraytracer_tpu_torch/bench.py)
against the repo's root bench.py, the JAX package's: its frame and
subsample helpers against bench.py's own functions (camera rays within the
tolerance of test_torch_scene.py's camera test, subsample indices equal),
its parity rule against ``bench.parity`` on crafted hits, the headline
recipe's size and its flattened world triangles against the JAX
package's ``SceneTLAS``, and the whole run on the CPU at patched tiny
sizes: the keys of its ``extra`` are those an AST scan finds in bench.py,
less the TPU-only ones, and every parity flag is true."""

import ast
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench as root_bench  # noqa: E402  (the repo's root bench.py)
import messyerraytracer_tpu as jmrt  # noqa: E402
from messyerraytracer_tpu.accel.tlas import (  # noqa: E402
    SceneTLAS as JaxSceneTLAS,
)
from torch_port_helpers import jax_rays, np_of, port_rays  # noqa: E402

from messyerraytracer_tpu_torch import bench  # noqa: E402
from messyerraytracer_tpu_torch.core.brute import parity  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# every size of the run cut down, every iteration count to 1
TINY = {
    "FRAME": (64, 48), "TERRAIN_SUBDIV": 4, "SPHERE_HI": 6, "SPHERE_LO": 4,
    "PARITY_RAYS": 256, "EXACT_RAYS": 128, "ITERS": 1,
    "FRAME_99K": (32, 24), "GROUND_SUBDIV_99K": 8, "SPHERE_99K": 8,
    "BOXES_99K": 20, "ITERS_99K": 1,
    "SUBDIV_2M": 16, "FRAME_2M": (32, 24), "PARITY_RAYS_2M": 128,
    "ITERS_2M": 1,
    "INCOHERENT_RAYS": 2048, "ITERS_INCOHERENT": 1,
    "PT_FRAME": (24, 18), "PT_ITERS": 1,
}


def bench_py():
    return ast.parse((ROOT / "bench.py").read_text())


def bench_py_extra_keys() -> set:
    """The top-level string keys root bench.py puts in ``extra``: its dict
    literal, ``extra.update({...})`` and ``extra[...] =``."""
    keys = set()

    def dict_keys(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}

    for node in ast.walk(bench_py()):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id == "extra"
                        and isinstance(node.value, ast.Dict)):
                    keys |= dict_keys(node.value)
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "extra"
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "extra"):
            for a in node.args:
                if isinstance(a, ast.Dict):
                    keys |= dict_keys(a)
    return keys


def bench_py_line_constants() -> dict:
    """The constant values of the JSON object root bench.py prints."""
    for node in ast.walk(bench_py()):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return {k.value: v.value for k, v in zip(node.keys, node.values)
                    if isinstance(v, ast.Constant)}
    raise AssertionError("bench.py prints no metric")


@pytest.fixture
def tiny(monkeypatch):
    for name, value in TINY.items():
        assert hasattr(bench, name), name
        monkeypatch.setattr(bench, name, value)


def test_frame_rays_and_subsample_match_bench_py():
    cam = jmrt.CameraParams.look_at(bench.EYE, bench.TARGET,
                                    fov_degrees=bench.FOV)
    rj = root_bench.block_swizzled_frame_rays(jmrt, 64, 48, cam)
    rp = bench.block_swizzled_frame_rays(64, 48, bench.headline_camera(),
                                         device="cpu")
    np.testing.assert_array_equal(np_of(rp.origin), np_of(rj.origin))
    np.testing.assert_allclose(np_of(rp.direction), np_of(rj.direction),
                               atol=1e-7)
    np.testing.assert_array_equal(np_of(rp.t_min), np_of(rj.t_min))
    np.testing.assert_array_equal(np_of(rp.t_max), np_of(rj.t_max))
    # t_max numbers the rays, so equal t_max means equal indices
    n = rp.count
    o = np.random.default_rng(0).normal(size=(n, 3)).astype(np.float32)
    t_max = np.arange(1, n + 1, dtype=np.float32)
    t_min = np.zeros(n, np.float32)
    for k in (100, 256, 1000):
        sj = root_bench.subsample(jax_rays(o, o, t_min, t_max), k)
        sp = bench.subsample(port_rays(o, o, t_min, t_max), k)
        assert sp.count == k
        np.testing.assert_array_equal(np_of(sp.t_max), np_of(sj.t_max))
        np.testing.assert_array_equal(np_of(sp.origin), np_of(sj.origin))


def hits(t, prim):
    return types.SimpleNamespace(t=torch.tensor(t, dtype=torch.float32),
                                 prim_id=torch.tensor(prim,
                                                      dtype=torch.int32))


@pytest.mark.parametrize("t, prim, verdict", [
    ([1.0, 2.0, 3.0e38], [3, 7, -1], True),                # exact match
    ([1.0, 2.0 * (1 + 3e-6), 3.0e38], [3, 8, -1], True),   # edge tie
    ([1.0, 2.0 * (1 + 8e-6), 3.0e38], [3, 8, -1], False),  # larger-t swap
    ([1.0 + 2e-5, 2.0, 3.0e38], [3, 7, -1], False),        # t off by 2e-5
])
def test_parity_rule_matches_bench_py(t, prim, verdict):
    oracle = hits([1.0, 2.0, 3.0e38], [3, 7, -1])
    got = hits(t, prim)
    assert parity(got, oracle) is verdict
    assert root_bench.parity(got, oracle) is verdict


def test_headline_recipe_size():
    mesh_list, inst = bench.headline_recipe()
    assert len(mesh_list) == 4 and len(inst) == 215
    assert sum(mesh_list[m].shape[0] for m, _ in inst) == 1_000_736


def test_headline_world_triangles_equal_jax(monkeypatch):
    """At a small subdivision the built headline TLAS flattens to the
    JAX package's world triangles, bit for bit."""
    for name, value in (("TERRAIN_SUBDIV", 6), ("SPHERE_HI", 8),
                        ("SPHERE_LO", 6)):
        monkeypatch.setattr(bench, name, value)
    tlas, times = bench.headline_tlas("cpu")
    assert set(times) == {"meshes", "flatten", "instanced", "build_tlas_s"}
    mesh_list, inst = bench.headline_recipe()
    jt = JaxSceneTLAS(backend="brute")
    for m in mesh_list:
        jt.add_mesh(m)
    for blas_id, xf in inst:
        jt.add_instance(blas_id, xf)
    jt.build_tlas()
    want = jt._world_tris_np()
    got = tlas._world_tris_np()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_run_keys_and_gates_on_the_cpu(tiny, capsys, monkeypatch):
    # main() runs on the default device: the CPU here
    monkeypatch.setattr(bench, "DEFAULT_DEVICE", torch.device("cpu"))
    assert bench.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    line = bench_py_line_constants()
    assert out["metric"] == line["metric"] == bench.METRIC
    assert out["unit"] == line["unit"] == bench.UNIT
    assert bench.BASELINE_CPU_MRAYS == root_bench.BASELINE_CPU_MRAYS
    assert abs(out["vs_baseline"]
               - out["value"] / root_bench.BASELINE_CPU_MRAYS) < 1e-3
    want = bench_py_extra_keys() - set(bench.TPU_ONLY_KEYS) - {"pt_error"}
    assert set(bench.TPU_ONLY_KEYS) < bench_py_extra_keys()
    assert set(out["extra"]) == want == set(bench.EXTRA_KEYS)
    assert list(out["extra"]) == list(bench.EXTRA_KEYS)
    e = out["extra"]
    flags = {k: v for k, v in e.items() if k.startswith("parity_")}
    assert sorted(flags) == ["parity_1m_flat", "parity_2m", "parity_99k",
                             "parity_tlas_vs_brute"]
    assert all(v is True for v in flags.values()), flags
    assert e["stack_drops_2m"] == 0
    assert e["instances"] == 215 and e["meshes"] == 4
    assert e["rays"] == 64 * 48 and e["tris_2m"] == 2 * 16 * 16
    assert set(e["build_phase_s"]) == {"meshes", "flatten", "instanced"}
    assert e["pt_wave_rays"] > 0 and e["pops_99k"] > 0


def test_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run()
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main()


@pytest.mark.parametrize("drop, add", [(0, "unlisted"), (1, None)])
def test_run_refuses_a_key_set_off_the_list(monkeypatch, drop, add):
    """A tier that fills a key EXTRA_KEYS does not list, or leaves one
    out, fails the run instead of being dropped or raising KeyError."""
    keys = bench.EXTRA_KEYS[1 + drop:]

    def tier(device, extra, *scenes):
        extra.update(dict.fromkeys(keys, 0))
        if add:
            extra[add] = 0
        return 1.0, None

    for name in ("_headline", "_flat_99k", "_capacity_2m", "_incoherent",
                 "_path_traced"):
        monkeypatch.setattr(bench, name, tier)
    want = add or bench.EXTRA_KEYS[1]
    with pytest.raises(RuntimeError, match=f"EXTRA_KEYS.*{want}"):
        bench.run("cpu")
