"""The port's public surface against the JAX package's.

An AST scan finds, for every module of ``messyerraytracer_tpu/``, each of
its public names in the port's counterpart module (same path under
``messyerraytracer_tpu_torch/``), or on the explicit TPU-only list below
with its reason.  The scan counts top-level defs, classes and their
methods, assignments, and names imported into the module; a name imported
from another module of the JAX package is also found where the port
defines it (the counterpart of the module it came from).

The names the port added last are then held against JAX: the constants
equal, ``centroid_of_triangles`` within 1 ulp, ``zero_stats`` all zero,
and ``native_build_wide8_tables`` table-identical to JAX's on the scenes
of tests/test_native_tables.py."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import load_native_libraries  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "messyerraytracer_tpu"
PORT_PKG = ROOT / "messyerraytracer_tpu_torch"

# Names imported from outside the package that the port's module does not
# import: JAX itself, or a helper library its PyTorch code does not need.
EXTERNAL = {
    "jax": "the port imports torch, never jax",
    "jnp": "jax.numpy; the port computes in torch",
    "pl": "jax.experimental.pallas; the kernels are CUDA C++ (kernels/csrc)",
    "pltpu": "Pallas' TPU backend; no TPU in the port",
    "Mesh": "jax.sharding.Mesh; the port's mesh is a list of torch devices",
    "P": "jax.sharding.PartitionSpec; shards are cut by _shard_bounds",
    "partial": "functools.partial for jax.jit; the port does not jit",
    "functools": "functools.partial / lru_cache around jax.jit",
    "np": "the port's module computes in torch and needs no numpy",
    "sys": "the JAX builder's import path; the port's needs no sys",
    "annotations": "utils/struct.py's __future__ import",
    "dataclasses": "utils/struct.py's helper module",
    "Sequence": "utils/struct.py's typing import",
}

# Public names defined by a JAX module that exist only for the TPU, with
# the reason the port has no counterpart.  The port accepts the TPU knobs
# as keyword arguments and ignores them (ROADMAP, queue B).
_CLUSTER_KNOB = ("a Pallas tiling knob of the cluster kernel (queue depth, "
                 "SMEM rows, group size); B1 is one ray per thread")
_SLAB_LAYOUT = ("a 128-lane slab row layout of the TPU tables; the port's "
                "tables are plain (N, k) tensors")
TPU_ONLY = {
    "kernels/cluster.py": {
        "CLUSTER_QD": _CLUSTER_KNOB,
        "CLUSTER_SROWS": _CLUSTER_KNOB,
        "CLUSTER_GR": _CLUSTER_KNOB,
        "CLUSTER_INNER": _CLUSTER_KNOB,
        "QCAP": "the TPU kernel's per-tile queue cap; B1 keeps a stack per "
                "ray, sized from the tree",
        "MAX_ITERS": "the TPU kernel's bounded while-loop trip count; B1 "
                     "loops until its stack empties",
        "ALLOW_PROBES": "the probe= timing modes of the TPU kernel",
        "ClusterScene.block_rows": "rows of a VMEM block of the TPU slabs",
        "NODES8_PER_ROW": _SLAB_LAYOUT,
    },
    "kernels/cluster_tlas.py": {
        "CLUSTER_QD": _CLUSTER_KNOB,
        "CLUSTER_SROWS": _CLUSTER_KNOB,
    },
    "kernels/cluster_v2.py": {
        "CLUSTER_QD": _CLUSTER_KNOB,
        "V2_NWAY": _CLUSTER_KNOB,
        "V2_QD": _CLUSTER_KNOB,
        "V2_SROWS": _CLUSTER_KNOB,
        "QCAP": "the TPU kernel's per-tile queue cap",
        "MAX_ITERS": "the TPU kernel's bounded loop trip count",
        "KSTACK": "the TPU kernel's fixed SMEM stack; B1 sizes its stack "
                  "from the tree",
        "NODE8_STRIDE": _SLAB_LAYOUT,
        "WIDE8_CAP": "the VMEM cap of the resident wide-node slab",
    },
    "kernels/traverse_pallas.py": {
        "TILE": "the Pallas ray tile (2048 rays); the port's sharding keeps "
                "it as parallel/sharding.py::TILE for JAX's shard bounds",
        "TILE_ROWS": _SLAB_LAYOUT,
        "SROWS": "SMEM stack rows of the TPU kernel",
        "VMEM_LIMIT": "the TPU's VMEM budget",
        "KSTACK": "the TPU kernel's fixed stack depth; B4 sizes its stack "
                  "from the tree (floor 64)",
        "MAX_ITERS": "the TPU kernel's bounded loop trip count",
        "UNROLL": "a Pallas loop-unroll knob",
        "QDRAIN": "the TPU kernel's queue drain knob",
        "DIM_SEMANTICS": "Pallas grid dimension semantics",
        "MEGA_COLUMNAR": "a layout knob of the TPU mega kernel",
        "MEGA_COND_DRAIN": "a drain knob of the TPU mega kernel",
        "MEGA_OR_ANY": "a reduction knob of the TPU mega kernel",
        "MEGA_UNROLL": "an unroll knob of the TPU mega kernel",
        "N_SLOTS": "the DMA ring's slot count",
        "NODE_STRIDE": _SLAB_LAYOUT,
        "NODE8_STRIDE": _SLAB_LAYOUT,
        "NODES_PER_ROW": _SLAB_LAYOUT,
        "NODES8_PER_ROW": _SLAB_LAYOUT,
        "LEAF_STRIDE": _SLAB_LAYOUT,
        "LEAVES_PER_ROW": _SLAB_LAYOUT,
        "COL_LEAF_F": _SLAB_LAYOUT,
        "QCOL_F": _SLAB_LAYOUT,
    },
    "kernels/wide.py": {
        "NODES_PER_ROW": _SLAB_LAYOUT,
        "NODES8_PER_ROW": _SLAB_LAYOUT,
        "LEAVES_PER_ROW": _SLAB_LAYOUT,
    },
    "utils/struct.py": {
        "pytree_dataclass": "registers a dataclass as a JAX pytree; the "
                            "port's containers are plain dataclasses",
    },
}
# every JAX module that imports pytree_dataclass
for _mod in ("accel/bvh.py", "accel/frontier.py", "accel/tlas_frontier.py",
             "core/attributes.py", "core/types.py", "kernels/cluster.py",
             "kernels/cluster_tlas.py", "kernels/wide.py",
             "render/shade.py", "render/textures.py", "render/wavefront.py"):
    TPU_ONLY.setdefault(_mod, {})["pytree_dataclass"] = (
        TPU_ONLY["utils/struct.py"]["pytree_dataclass"])


def _source_module(rel: Path, node: ast.ImportFrom) -> Path | None:
    """The package-relative path of the module a relative import reads."""
    if node.level == 0:
        return None
    base = rel.parent
    for _ in range(node.level - 1):
        base = base.parent
    mod = base.joinpath(*(node.module or "").split(".")) if node.module \
        else base
    for cand in (mod.with_suffix(".py"), mod / "__init__.py"):
        if (JAX_PKG / cand).exists():
            return cand
    return None


def public_names(path: Path, rel: Path) -> dict:
    """{public name: the package module it was imported from, or None}."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = None
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{m.name}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        out[n.id] = None
        elif isinstance(node, ast.Import):
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = None
        elif isinstance(node, ast.ImportFrom):
            src = _source_module(rel, node)
            for a in node.names:
                out[a.asname or a.name] = src
    return {n: s for n, s in out.items()
            if not any(p.startswith("_") for p in n.split("."))}


def _jax_modules():
    return sorted(p.relative_to(JAX_PKG) for p in JAX_PKG.rglob("*.py"))


def missing_names(port_pkg: Path = PORT_PKG) -> dict:
    """{module: [JAX public names the port lacks, off the lists]}."""
    out = {}
    for rel in _jax_modules():
        listed = TPU_ONLY.get(rel.as_posix(), {})
        port = port_pkg / rel
        have = public_names(port, rel) if port.exists() else {}
        miss = []
        for name, src in public_names(JAX_PKG / rel, rel).items():
            if name in have or name in listed or name in EXTERNAL:
                continue
            if src is not None and (port_pkg / src).exists() and \
                    name in public_names(port_pkg / src, src):
                continue        # ported where the JAX package defines it
            miss.append(name)
        if miss:
            out[rel.as_posix()] = miss
    return out


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    assert missing_names() == {}


def test_the_tpu_only_list_names_only_what_the_port_lacks():
    """Each listed name is public in its JAX module and absent from the
    port's counterpart, and every entry gives a reason."""
    for mod, names in TPU_ONLY.items():
        jax_names = public_names(JAX_PKG / mod, Path(mod))
        port = PORT_PKG / mod
        port_names = public_names(port, Path(mod)) if port.exists() else {}
        for name, reason in names.items():
            assert name in jax_names, (mod, name)
            assert name not in port_names, (mod, name)
            assert len(reason) > 10, (mod, name)


def test_the_scan_finds_a_removed_name(tmp_path):
    """The scan is live: a JAX name whose port counterpart is gone is
    reported."""
    copy = tmp_path / "port"
    for p in PORT_PKG.rglob("*.py"):
        dst = copy / p.relative_to(PORT_PKG)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(p.read_text())
    geo = copy / "core" / "geometry.py"
    geo.write_text(geo.read_text().replace("def centroid_of_triangles",
                                           "def _centroid_of_triangles"))
    assert missing_names(copy) == {
        "core/geometry.py": ["centroid_of_triangles"]}


# ---------------------------------------------------------------------------
# the names added last, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,name", [
    ("accel.bvh", "STACK_DEPTH"),
    ("render.wavefront", "PI"),
    ("parallel.sharding", "RAY_AXIS"),
])
def test_constants_equal_jax(module, name):
    import importlib

    j = importlib.import_module(f"messyerraytracer_tpu.{module}")
    p = importlib.import_module(f"messyerraytracer_tpu_torch.{module}")
    assert getattr(p, name) == getattr(j, name)


def test_one_definition_of_each_constant():
    """traverse.py and wavefront.py read the constant they share with
    another module instead of defining their own."""
    from messyerraytracer_tpu_torch.accel import bvh, traverse
    from messyerraytracer_tpu_torch.render import pathtrace, wavefront

    assert traverse.STACK_DEPTH is bvh.STACK_DEPTH
    assert wavefront.PI is pathtrace.PI
    for path in ("accel/traverse.py", "render/wavefront.py"):
        assert not any(
            isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in ("STACK_DEPTH", "PI")
                for t in n.targets)
            for n in ast.parse((PORT_PKG / path).read_text()).body), path


def test_centroid_of_triangles_within_one_ulp_of_jax():
    from messyerraytracer_tpu.core.geometry import (
        centroid_of_triangles as jcentroid)
    from messyerraytracer_tpu_torch.core.geometry import (
        centroid_of_triangles as pcentroid)

    rng = np.random.default_rng(7)
    v = rng.uniform(-50, 50, (3, 4096, 3)).astype(np.float32)
    got = pcentroid(*(torch.from_numpy(x) for x in v)).numpy()
    want = np.asarray(jcentroid(*v))
    assert got.dtype == np.float32 and got.shape == want.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert int(ulps.max()) <= 1


def test_zero_stats_all_zero():
    from messyerraytracer_tpu.core.types import zero_stats as jzero
    from messyerraytracer_tpu_torch.core.types import RayStats, zero_stats

    z = zero_stats(device="cpu")
    assert isinstance(z, RayStats)
    j = jzero()
    for f in ("rays_cast", "tri_tests", "bvh_nodes_visited", "hits"):
        assert int(getattr(z, f)) == int(getattr(j, f)) == 0
        assert getattr(z, f).device.type == "cpu"
    assert int(z.stack_drops) == 0
    total = z + zero_stats(device="cpu")
    assert int(total.rays_cast) == 0 and total.hit_rate() == 0.0


def _native_scenes():
    """The scenes of tests/test_native_tables.py."""
    from messyerraytracer_tpu_torch.utils import meshes

    g = meshes.plane(40.0, y=0.0, subdiv=24)
    g[:, :, 1] = (np.sin(g[:, :, 0] * 0.6) * np.cos(g[:, :, 2] * 0.5)) * 1.5
    rng = np.random.default_rng(3)
    return {
        "terrain+sphere": np.concatenate(
            [g, meshes.uv_sphere(2.0, 10, 20, center=(0, 4, 0))]),
        "tiny": meshes.uv_sphere(1.0, 4, 8),
        "soup": rng.uniform(-1, 1, (2000, 3, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_native_scenes()))
def test_native_build_wide8_tables_identical_to_jax(name):
    from messyerraytracer_tpu import native as jnative
    from messyerraytracer_tpu.accel.bvh import build_bvh
    from messyerraytracer_tpu_torch import native as pnative

    load_native_libraries()
    tri = _native_scenes()[name]
    host = build_bvh(tri[:, 0], tri[:, 1], tri[:, 2]).host
    args = (host["aabb_min"], host["aabb_max"], host["left_first"],
            host["count"], tri.shape[0])
    want = jnative.native_build_wide8_tables(*args)
    got = pnative.native_build_wide8_tables(*args)
    assert want is not None and got is not None
    assert len(got) == len(want) == 8
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[6:] == want[6:]


def test_native_build_wide8_tables_none_without_a_library(monkeypatch):
    from messyerraytracer_tpu_torch import native as pnative

    monkeypatch.setattr(pnative, "get_native_lib", lambda: None)
    z = np.zeros((1, 3), np.float32)
    i = np.zeros(1, np.int32)
    assert pnative.native_build_wide8_tables(z, z, i, i + 1, 1) is None
