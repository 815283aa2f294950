"""PyTorch port: both packages' native SAH builders load in every test
worker (a worker whose JAX library failed to load gets it from the atomic
build that the port's test helpers make), and both build bit-identical
BVH tables."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu import native as jnative  # noqa: E402
from messyerraytracer_tpu.scene import scene as jscene  # noqa: E402

from messyerraytracer_tpu_torch import native as pnative  # noqa: E402
from messyerraytracer_tpu_torch.scene import scene as pscene  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    JAX_NATIVE_SO,
    load_native_libraries,
    np_of,
    small_tris,
    terrain_tris,
)


def test_both_native_libraries_load():
    jlib, plib = load_native_libraries()
    assert jlib is not None and plib is not None
    assert jlib is jnative.get_native_lib()
    assert plib is pnative.get_native_lib()


def test_a_failed_load_is_rebuilt_atomically():
    """A worker that loaded a half-written library is left with no library
    and the numpy builder for good; the helpers rebuild the JAX package's
    source atomically in the port's build directory and load that."""
    saved = (jnative._SO, jnative._LIB, jnative._TRIED)
    try:
        jnative._LIB, jnative._TRIED = None, True      # the failed state
        assert jnative.get_native_lib() is None
        jlib, _ = load_native_libraries()
        assert jlib is not None and jlib is jnative.get_native_lib()
        assert jnative._SO == os.path.join(pnative.BUILD_DIR, JAX_NATIVE_SO)
        assert (os.path.getmtime(jnative._SO)
                >= os.path.getmtime(jnative._SRC))
    finally:
        jnative._SO, jnative._LIB, jnative._TRIED = saved


@pytest.mark.parametrize("fn", ["native_build_bvh", "native_build_bvh_aabbs"])
def test_native_builders_build_identical_tables(fn):
    tris = np.concatenate([terrain_tris(12, extent=8.0), small_tris()])
    v = (tris[:, 0], tris[:, 1], tris[:, 2])
    if fn == "native_build_bvh":
        args = v
    else:
        lo = np.minimum(np.minimum(v[0], v[1]), v[2])
        hi = np.maximum(np.maximum(v[0], v[1]), v[2])
        args = (lo, hi, (lo + hi) * 0.5, 4)
    pj, pp = getattr(jnative, fn)(*args), getattr(pnative, fn)(*args)
    assert pj is not None and pp is not None
    assert len(pj) == len(pp) == 8 and pj[-1] == pp[-1] > 1
    for a, b in zip(pj[:-1], pp[:-1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
def test_scene_builds_share_one_tree(backend):
    tris = small_tris()
    js = jscene.build_scene_from_tri_array(tris, backend=backend)
    ps = pscene.build_scene_from_tri_array(tris, backend=backend,
                                           device="cpu")
    for f in ("aabb_min", "aabb_max", "left_first", "count", "tri_order",
              "split_axis"):
        np.testing.assert_array_equal(np_of(getattr(ps.bvh, f)),
                                      np_of(getattr(js.bvh, f)), err_msg=f)


def test_a_changed_build_command_rebuilds(tmp_path, monkeypatch):
    """A cached library is reused only when its source is older and its
    build command is the same: another flag builds it anew."""
    import sys

    monkeypatch.setattr(pnative, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    runs = tmp_path / "runs"
    # a stand-in compiler: writes the flags it got and counts its runs
    fake = [sys.executable, "-c",
            "import sys; a = sys.argv[1:]; o = a[a.index('-o') + 1]; "
            "open(o, 'w').write(' '.join(a[:a.index('-o')])); "
            f"open({str(runs)!r}, 'a').write('x')"]
    out = pnative.build_shared_library(fake + ["-O3"], [str(src)], "k.so")
    assert pnative.build_shared_library(fake + ["-O3"], [str(src)],
                                        "k.so") == out
    assert runs.read_text() == "x"
    pnative.build_shared_library(fake + ["-O3", "-cudart", "shared"],
                                 [str(src)], "k.so")
    assert runs.read_text() == "xx"
    assert open(out).read() == "-O3 -cudart shared"
    pnative.build_shared_library(fake + ["-O3", "-cudart", "shared"],
                                 [str(src)], "k.so")
    assert runs.read_text() == "xx"


def stand_in_library(tmp_path, monkeypatch):
    """A ``CudaLibrary`` of ``int mrt_add(int a, int b)``, built by a
    stand-in nvcc that checks it got ``NVCC_FLAGS``, builds the source as
    C with the host's compiler and counts its runs in the returned
    file."""
    import ctypes
    import sys

    monkeypatch.setattr(pnative, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "add.cu"
    src.write_text("int mrt_add(int a, int b) { return a + b; }\n")
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import subprocess, sys\n"
        "a = sys.argv[1:]; o = a[a.index('-o') + 1]\n"
        f"assert a[:a.index('-o')] == {pnative.NVCC_FLAGS!r}\n"
        f"open({str(runs)!r}, 'a').write('x')\n"
        "subprocess.run(['gcc', '-shared', '-fPIC', '-x', 'c', '-o', o, "
        "a[-1]], check=True)\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(pnative, "nvcc", lambda: str(nvcc))
    lib = pnative.CudaLibrary(str(src), "libadd.so", {
        "mrt_add": [ctypes.c_int, ctypes.c_int]})
    return lib, src, runs


def test_a_kernel_library_is_built_once_and_declared(tmp_path, monkeypatch):
    """``CudaLibrary`` builds its source at first call, with ``nvcc()`` and
    ``NVCC_FLAGS``, once however many threads ask, loads it once and
    declares each entry to return an int."""
    import ctypes
    import threading

    lib, src, runs = stand_in_library(tmp_path, monkeypatch)
    assert lib.lib is None and lib.source == str(src)
    got = []
    threads = [threading.Thread(target=lambda: got.append(lib()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert runs.read_text() == "x"
    assert len(got) == 4 and all(g is lib.lib for g in got)
    assert lib().mrt_add(2, 40) == 42
    assert lib().mrt_add.restype is ctypes.c_int
    assert lib.load(lib.lib._name).mrt_add.argtypes == [ctypes.c_int] * 2
    assert runs.read_text() == "x"


def test_a_launch_counts_only_what_the_entry_accepted(tmp_path,
                                                      monkeypatch):
    """``CudaLibrary.launch`` calls the entry inside the device guard with
    the current stream appended: a return code of 0 counts one launch; a
    non-zero code raises ``RuntimeError`` naming the entry and the code
    and counts none.  (The stand-in entry returns its argument plus the
    stand-in stream, 40.)"""
    import contextlib
    import types

    lib, _, _ = stand_in_library(tmp_path, monkeypatch)
    guarded = []

    @contextlib.contextmanager
    def guard(device):
        guarded.append(device)
        yield

    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=40))
    assert lib.launches == 0
    lib.launch("mrt_add", [-40], "cuda:0", "test.launch")
    assert lib.launches == 1 and guarded == ["cuda:0"]
    with pytest.raises(RuntimeError, match="mrt_add .*CUDA error 2$"):
        lib.launch("mrt_add", [-38], "cuda:0", "test.launch")
    assert lib.launches == 1 and guarded == ["cuda:0"] * 2


@pytest.fixture(scope="module")
def table_classes():
    """One small CPU instance of each table class kernels read."""
    from messyerraytracer_tpu_torch.kernels.cluster_tlas import (
        build_cluster_tlas)

    tris = small_tris()
    moved = np.eye(4)
    moved[:3, 3] = (20.0, 0.0, 0.0)
    return {
        "ClusterScene": pscene.build_scene_from_tri_array(
            tris, device="cpu").cluster,
        "ClusterTLAS": build_cluster_tlas(
            [tris], [(0, np.eye(4)), (0, moved)], device="cpu"),
        "WideScene": pscene.build_scene_from_tri_array(
            tris, backend="pallas", device="cpu").wide,
    }


_FAULTS = {
    "dtype": lambda t: t.to(torch.float64 if t.is_floating_point()
                            else torch.int64),
    "shape": lambda t: t[:-1],
    "strides": lambda t: torch.stack([t, t], dim=-1)[..., 0],
    "device": lambda t: t.to("meta"),
}


@pytest.mark.parametrize("fault", list(_FAULTS))
@pytest.mark.parametrize("owner,table", [
    ("ClusterScene", "node_box"), ("ClusterScene", "tri_layers"),
    ("ClusterTLAS", "iinv"), ("ClusterTLAS", "pair_slot"),
    ("WideScene", "leaf_tri"), ("WideScene", "slot_layers")])
def test_a_malformed_table_is_refused_at_construction(table_classes, owner,
                                                      table, fault):
    """Each table class checks the tables its kernels read when it is
    made, whichever way: a table of another dtype or shape, a
    non-contiguous one or one on another device raises ``ValueError``
    naming it, and the well-formed copy passes."""
    import dataclasses
    import re

    tables = table_classes[owner]
    good = getattr(tables, table)
    assert dataclasses.replace(tables, **{table: good.clone()})
    with pytest.raises(ValueError, match=re.escape(f"{owner}.{table} ")):
        dataclasses.replace(tables, **{table: _FAULTS[fault](good)})


def c_entry_types(source: str, entry: str) -> list:
    """The ctypes type of each parameter of the C entry ``entry`` in
    ``source``: any pointer a void pointer, int an int, float a float."""
    import ctypes
    import re

    text = open(source).read()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, entry
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
            for p in (q.strip() for q in m.group(1).split(","))]


@pytest.mark.parametrize("module", ["cluster_v2", "traverse_pallas",
                                    "cluster_tlas", "camera_rays",
                                    "morton_keys"])
def test_each_kernel_library_declares_its_c_entry(module):
    """Each kernel's library object names a source under kernels/csrc/
    and declares every C entry with the source's own parameter types, in
    order; nothing is built to check it."""
    import importlib

    mod = importlib.import_module(
        f"messyerraytracer_tpu_torch.kernels.{module}")
    lib = mod.cuda_library
    assert isinstance(lib, pnative.CudaLibrary)
    assert os.path.dirname(lib.source) == pnative.KERNEL_SRC
    assert os.path.exists(lib.source) and lib.name.endswith(".so")
    assert lib.entries
    for entry, argtypes in lib.entries.items():
        assert list(argtypes) == c_entry_types(lib.source, entry), entry
