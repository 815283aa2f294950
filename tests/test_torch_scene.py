"""PyTorch port: the slice end to end on the CPU — scene build and casts,
the instanced TLAS API, ray generation, and the package's independence
from JAX."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import messyerraytracer_tpu as jmrt  # noqa: E402
from messyerraytracer_tpu.core.brute import (  # noqa: E402
    any_hit_brute as jax_any_hit_brute,
    cast_rays_brute as jax_brute,
)
from messyerraytracer_tpu.dispatch import morton as jmorton  # noqa: E402
from messyerraytracer_tpu.utils import meshes as jmeshes  # noqa: E402

import messyerraytracer_tpu_torch as pmrt  # noqa: E402
from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS  # noqa: E402
from messyerraytracer_tpu_torch.core.brute import (  # noqa: E402
    cast_rays_brute,
)
from messyerraytracer_tpu_torch.dispatch import morton as pmorton  # noqa
from messyerraytracer_tpu_torch.scene.scene import (  # noqa: E402
    build_scene,
    build_scene_from_tri_array,
)
from messyerraytracer_tpu_torch.utils import meshes as pmeshes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    ANCHOR_ATOL,
    assert_parity,
    assert_same_hits,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
    terrain_tris,
)

PKG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "messyerraytracer_tpu_torch")


def rays_pair(rj):
    """The port's copy of a JAX Rays batch."""
    return port_rays(np_of(rj.origin), np_of(rj.direction),
                     np_of(rj.t_min), np_of(rj.t_max))


def test_skill_canonical_drive_equals_jax():
    sphere = pmeshes.uv_sphere(radius=1.0, rings=16, segments=32)
    rj = jmrt.debug_grid_rays((0, 0, 4), (0, 0, -1), 16, 12, 60.0)
    rp = pmrt.debug_grid_rays((0, 0, 4), (0, 0, -1), 16, 12, 60.0,
                              device="cpu")
    np.testing.assert_allclose(np_of(rp.direction), np_of(rj.direction),
                               atol=1e-7)
    tj = jmrt.make_triangles(sphere[:, 0], sphere[:, 1], sphere[:, 2])
    hj, _ = jax_brute(rj, tj)
    scene = build_scene_from_tri_array(sphere, device="cpu")
    for h, _ in (scene.cast_rays(rp), cast_rays_brute(rp, scene.tris)):
        assert_same_hits(h, hj)
        mask = h.hit.numpy().reshape(12, 16)
        np.testing.assert_array_equal(mask,
                                      np_of(hj.hit).reshape(12, 16))
        # centered blob silhouette, center t ~ 3.03, normals face the camera
        assert mask[5:7, 7:9].all() and not mask[0].any()
        assert abs(float(h.t.reshape(12, 16)[6, 8]) - 3.03) < 0.01
        assert (h.normal[h.hit][:, 2] > 0).all()
        assert abs(float(h.hit.float().mean()) - 0.23) < 0.01


def test_flat_scene_end_to_end_vs_jax_brute():
    tris = np.concatenate([terrain_tris(40),
                           pmeshes.uv_sphere(2.0, 16, 32, center=(0, 2, 0))])
    layers = np.where(np.arange(len(tris)) < 3200, 0b01, 0b10).astype(
        np.int32)
    o, d = rand_rays_np(1024, seed=21, extent=9.0)
    rj = jax_rays(o, d)
    tj = jmrt.make_triangles(tris[:, 0], tris[:, 1], tris[:, 2],
                             layers=layers)
    scene = build_scene_from_tri_array(tris, layers=layers, device="cpu")
    for qm in (-1, 0b10):
        hj, _ = jax_brute(rj, tj, qm)
        h, s = scene.cast_rays(rays_pair(rj), qm)
        assert_same_hits(h, hj, atol=1e-4, t_atol=ANCHOR_ATOL)
        assert int(s.stack_drops) == 0 and int(s.hits) > 20
        np.testing.assert_array_equal(
            scene.any_hit_rays(rays_pair(rj), qm).numpy(),
            np_of(jax_any_hit_brute(rj, tj, qm)))
    brute = build_scene_from_tri_array(tris, layers=layers, backend="brute",
                                       device="cpu")
    assert brute.cluster is None
    hb, _ = brute.cast_rays(rays_pair(rj))
    assert_same_hits(hb, jax_brute(rj, tj)[0], rtol=1e-6)


def test_scene_tlas_end_to_end_vs_jax():
    from messyerraytracer_tpu.accel.tlas import SceneTLAS as JaxSceneTLAS

    def xf(tx, ty, tz, s=1.0):
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = s
        m[:3, 3] = (tx, ty, tz)
        return m

    rng = np.random.default_rng(11)
    terrain = terrain_tris(12, extent=10.0)
    sphere = pmeshes.uv_sphere(1.0, 12, 12)
    jt, pt = JaxSceneTLAS(backend="brute"), SceneTLAS(device="cpu")
    for t in (jt, pt):
        t.add_mesh(terrain)
        t.add_mesh(sphere)
    for k in range(4):
        m = xf((k % 2 - 0.5) * 10, 0.0, (k // 2 - 0.5) * 10)
        jt.add_instance(0, m)
        pt.add_instance(0, m)
    for _ in range(12):
        c = rng.uniform(-8, 8, 2)
        m = xf(c[0], rng.uniform(1.0, 2.0), c[1], s=rng.uniform(0.5, 1.2))
        jt.add_instance(1, m)
        pt.add_instance(1, m)
    jt.build_tlas()
    pt.build_tlas()
    pt.build_instanced()
    cam = pmrt.CameraParams.look_at((0, 8, 14), (0, 1, 0), fov_degrees=60.0)
    perm = pmorton.raster_block_permutation(64, 48, 32)
    rp = pmrt.generate_rays(cam, 64, 48, device="cpu").take(perm)
    rj = jax_rays(np_of(rp.origin), np_of(rp.direction))
    hj, _, ij = jt.cast_rays(rj)                       # JAX flat brute
    hi, si, occ, ii = pt.cast_rays_instanced(rp)
    hf, sf = pt.flat.cast_rays(rp)
    for h in (hi, hf):
        assert_parity(h, hj)
        np.testing.assert_array_equal(h.hit.numpy(), np_of(hj.hit))
    same = hi.prim_id.numpy() == np_of(hj.prim_id)
    np.testing.assert_array_equal(ii.numpy()[same], np_of(ij)[same])
    assert 0.3 < float(hi.hit.float().mean()) < 1.0
    assert int(si.stack_drops) == 0 and int(sf.stack_drops) == 0
    # the flat twin's instance ids through SceneTLAS.cast_rays
    _, _, i_flat = pt.cast_rays(rp)
    np.testing.assert_array_equal(i_flat.numpy()[same], np_of(ij)[same])


def test_camera_and_swizzle_match_jax():
    cam = jmrt.CameraParams.look_at((0, 26, 55), (0, 1, 0), fov_degrees=60.0)
    pcam = pmrt.CameraParams.look_at((0, 26, 55), (0, 1, 0),
                                     fov_degrees=60.0)
    assert cam.origin == pcam.origin and cam.basis == pcam.basis
    rj = jmrt.generate_rays(cam, 96, 54)
    rp = pmrt.generate_rays(pcam, 96, 54, device="cpu")
    np.testing.assert_array_equal(np_of(rp.origin), np_of(rj.origin))
    np.testing.assert_allclose(np_of(rp.direction), np_of(rj.direction),
                               atol=1e-7)
    ocam = jmrt.CameraParams.look_at((0, 5, 5), (0, 0, 0), ortho=True)
    pocam = pmrt.CameraParams.look_at((0, 5, 5), (0, 0, 0), ortho=True)
    oj = jmrt.generate_rays(ocam, 16, 8)
    op = pmrt.generate_rays(pocam, 16, 8, device="cpu")
    np.testing.assert_allclose(np_of(op.origin), np_of(oj.origin), atol=1e-6)
    np.testing.assert_allclose(np_of(op.direction), np_of(oj.direction),
                               atol=1e-7)
    for w, h, b in ((1920, 1080, 32), (100, 37, 16)):
        np.testing.assert_array_equal(
            pmorton.raster_block_permutation(w, h, b),
            jmorton.raster_block_permutation(w, h, b))


def test_meshes_copy_matches_jax():
    for name, args in (("uv_sphere", (1.6, 8, 12)), ("plane", (20.0, 0.0, 5)),
                       ("box", ((1.4, 1.0, 1.2),)), ("cornell_room", ()),
                       ("random_soup", (50,))):
        np.testing.assert_array_equal(getattr(pmeshes, name)(*args),
                                      getattr(jmeshes, name)(*args))


def test_unported_backends_raise():
    """Every backend of the JAX package is ported (the frontier pair
    since A.10): both build and cast, also on a scene switched to them;
    a backend no package has raises."""
    tris = pmeshes.box()
    o = np.float32([[0.1, 0.2, 3.0]])
    d = np.float32([[0.0, 0.0, -1.0]])
    want, _ = build_scene_from_tri_array(tris, backend="brute",
                                         device="cpu").cast_rays(
        port_rays(o, d))
    for backend in ("frontier", "frontier_q"):
        scene = build_scene_from_tri_array(tris, backend=backend,
                                           device="cpu")
        assert scene.cluster is None and scene.wide is None
        h, _ = scene.cast_rays(port_rays(o, d))
        assert torch.equal(h.t, want.t) and torch.equal(h.prim_id,
                                                        want.prim_id)
    scene = build_scene_from_tri_array(tris, device="cpu")
    scene.backend = "frontier"
    assert bool(scene.any_hit_rays(port_rays(o, d))[0])
    with pytest.raises(ValueError, match="backend"):
        build_scene_from_tri_array(tris, backend="gpu", device="cpu")


def test_build_scene_keeps_prim_ids_and_layers():
    tris = pmeshes.uv_sphere(1.0, 8, 8)
    n = len(tris)
    pid = np.arange(n, dtype=np.int32)[::-1] + 100
    lay = (np.arange(n) % 5 + 1).astype(np.int32)
    scene = build_scene(tris[:, 0], tris[:, 1], tris[:, 2], layers=lay,
                        prim_id=pid, device="cpu")
    perm = scene.bvh.host["tri_order"]
    np.testing.assert_array_equal(scene.tris.prim_id.numpy(), pid[perm])
    o = np.tile(np.float32([[0, 0, 4]]), (3, 1))
    d = np.tile(np.float32([[0, 0, -1]]), (3, 1))
    h, _ = scene.cast_rays(port_rays(o, d))
    k = int(np.nonzero(pid == int(h.prim_id[0]))[0][0])
    assert int(h.hit_layers[0]) == lay[k]


JAX_NAME = "messyerraytracer_tpu"
# the one exception: the port's lint spells the JAX package's name out, as
# a match pattern (tools/lint.py), and reads it only in these places
LINT = os.path.join("tools", "lint.py")
LINT_LINE = f'JAX_PKG_NAME = "{JAX_NAME}"'
LINT_USES = (LINT_LINE, "re.escape(JAX_PKG_NAME)",
             'JAX_MODULES = ("jax", "jaxlib", JAX_PKG_NAME)')
# a string literal naming the JAX package, as a path or an #include would
PATH_RE = re.compile(r"[\"'][^\"'\n]*\bmessyerraytracer_tpu\b(?!_torch)")
# the name built from pieces: the port's suffix stripped off its own name,
# or the head of the name as a literal of its own
PIECES_RE = re.compile(r"removesuffix\(|[\"']_torch[\"']"
                       r"|[\"']messyerraytracer_?[\"']")


def _imports(src: str) -> list:
    """The modules of jax, jaxlib or the JAX package a module imports."""
    bad = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        bad += [f"line {node.lineno}: imports {m}" for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", JAX_NAME)]
    return bad


def jax_refs(pkg) -> dict:
    """{file: [offences]} for every way a file of the port's package at
    ``pkg`` imports jax or the JAX package, names the JAX package in a
    string literal or builds its name from pieces.  Docstrings and comments
    may cite its files.  Dynamic imports are caught at run time by
    ``test_imports_and_casts_with_jax_blocked``."""
    found, seen = {}, set()
    for root, _, files in os.walk(pkg):
        for f in files:
            ext = os.path.splitext(f)[1]
            if ext not in (".py", ".cpp", ".cu"):
                continue
            seen.add(ext)
            rel = os.path.relpath(os.path.join(root, f), pkg)
            with open(os.path.join(root, f)) as fh:
                src = fh.read()
            text, bad = src, []
            if rel == LINT:
                if src.count(LINT_LINE) != 1:
                    bad.append("JAX_PKG_NAME is not assigned its name once")
                for use in LINT_USES:
                    text = text.replace(use, "", 1)
                if "JAX_PKG_NAME" in text:
                    bad.append("JAX_PKG_NAME used other than as a match "
                               "pattern")
            bad += [f"string literal {m.group(0)!r}"
                    for m in PATH_RE.finditer(text)]
            bad += [f"name built from pieces: {m.group(0)!r}"
                    for m in PIECES_RE.finditer(src)]
            if ext == ".py":
                bad += _imports(src)
            if bad:
                found[rel] = bad
    assert seen == {".py", ".cpp", ".cu"}
    return found


def test_port_sources_never_import_jax():
    assert jax_refs(PKG) == {}


# each way around the guard, planted in a copy of the package: (file,
# text appended to it)
WAYS_OUT = {
    "import jax": ("core/x.py", "import jax\n"),
    "import among others": ("core/x.py", "import os, jax\n"),
    "import the JAX package": ("core/x.py", "import messyerraytracer_tpu\n"),
    "from the JAX package": ("core/x.py",
                             "from messyerraytracer_tpu.core import brute\n"),
    "path literal": ("core/x.py",
                     "P = os.path.join(ROOT, 'messyerraytracer_tpu')\n"),
    "adjacent literals": ("core/x.py",
                          "M = importlib.import_module('messyerraytracer_' "
                          "'tpu')\n"),
    "concatenation": ("core/x.py", "M = 'messyerraytracer' + '_tpu'\n"),
    "join": ("core/x.py", "M = '_'.join(['messyerraytracer', 'tpu'])\n"),
    "format": ("core/x.py", "M = '{}_tpu'.format('messyerraytracer')\n"),
    "removesuffix": ("core/x.py",
                     "M = 'messyerraytracer_tpu_torch'.removesuffix("
                     "'_torch')\n"),
    "replace": ("core/x.py", "M = PKG.replace('_torch', '')\n"),
    "suffix in a name": ("core/x.py", "S = '_torch'\nM = PKG.split(S)[0]\n"),
    "lint: the old trick": ("tools/lint.py",
                            "J = PKG_NAME.removesuffix(SUFFIX)\n"),
    "lint: the name as a path": ("tools/lint.py",
                                 "D = ROOT / JAX_PKG_NAME\n"),
    "lint: a second literal": ("tools/lint.py",
                               "D = ROOT / 'messyerraytracer_tpu'\n"),
    "lint: a second assignment": ("tools/lint.py", LINT_LINE + "\n"),
    "cuda include": ("kernels/csrc/cluster_cast.cu",
                     '#include "messyerraytracer_tpu/kernels/x.h"\n'),
    "c++ path": ("native/sah_builder.cpp",
                 'static const char *p = "messyerraytracer_tpu/native";\n'),
}


@pytest.mark.parametrize("way", sorted(WAYS_OUT))
def test_the_guard_refuses_each_way_out(way, tmp_path):
    import shutil

    rel, text = WAYS_OUT[way]
    dst = tmp_path / "pkg"
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    assert jax_refs(dst) == {}
    f = dst / rel
    f.write_text((f.read_text() if f.exists() else "") + text)
    found = jax_refs(dst)
    assert list(found) == [os.path.normpath(rel)], found


def test_imports_and_casts_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "import messyerraytracer_tpu_torch as mrt\n"
        "from messyerraytracer_tpu_torch.scene.scene import "
        "build_scene_from_tri_array\n"
        "from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS\n"
        "from messyerraytracer_tpu_torch.utils import meshes\n"
        "s = build_scene_from_tri_array(meshes.uv_sphere(1.0, 8, 16), "
        "device='cpu')\n"
        "r = mrt.debug_grid_rays((0, 0, 4), (0, 0, -1), 8, 6, 60.0, "
        "device='cpu')\n"
        "h, _ = s.cast_rays(r)\n"
        "t = SceneTLAS(device='cpu')\n"
        "t.add_instance(t.add_mesh(meshes.box()), np.eye(4))\n"
        "t.build_tlas()\n"
        "hi = t.cast_rays_instanced(r)[0]\n"
        "assert int(h.hit.sum()) > 0 and int(hi.hit.sum()) > 0\n"
        "from messyerraytracer_tpu_torch.parallel.dryrun import "
        "dryrun_multichip\n"
        "f = build_scene_from_tri_array(meshes.uv_sphere(1.0, 8, 16), "
        "backend='frontier', device='cpu')\n"
        "assert int(f.cast_rays(r)[0].hit.sum()) == int(h.hit.sum())\n"
        "assert int(t.cast_rays_two_level_fast(r)[0].hit.sum()) > 0\n"
        "dryrun_multichip(2, device='cpu')\n"
        "from messyerraytracer_tpu_torch import bench  # noqa: F401\n"
        "assert sys.modules['jax'] is None\n"
        "assert not any(m.startswith('messyerraytracer_tpu.') or "
        "m == 'messyerraytracer_tpu' for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(PKG))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_port_alone_builds_its_native_builder(tmp_path):
    """Only the port's package, with no JAX package beside it and jax
    blocked: the native SAH builder compiles from the port's own copy of
    its source, and a flat scene builds and casts through it."""
    import shutil

    dst = tmp_path / "messyerraytracer_tpu_torch"
    shutil.copytree(PKG, dst, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['messyerraytracer_tpu'] = None\n"
        "import messyerraytracer_tpu_torch as mrt\n"
        "from messyerraytracer_tpu_torch import native\n"
        "from messyerraytracer_tpu_torch.scene.scene import "
        "build_scene_from_tri_array\n"
        "from messyerraytracer_tpu_torch.utils import meshes\n"
        "here = os.path.dirname(mrt.__file__)\n"
        "assert here == os.path.join(os.getcwd(), "
        "'messyerraytracer_tpu_torch'), here\n"
        "assert native.SAH_SRC == os.path.join(here, 'native', "
        "'sah_builder.cpp')\n"
        "assert native.get_native_lib() is not None\n"
        "lib = os.path.join(native.BUILD_DIR, 'libmrt_native.so')\n"
        "assert lib.startswith(here) and os.path.getmtime(lib) >= "
        "os.path.getmtime(native.SAH_SRC)\n"
        "s = build_scene_from_tri_array(meshes.uv_sphere(1.0, 8, 16), "
        "device='cpu')\n"
        "r = mrt.debug_grid_rays((0, 0, 4), (0, 0, -1), 8, 6, 60.0, "
        "device='cpu')\n"
        "assert int(s.cast_rays(r)[0].hit.sum()) > 0\n"
        "assert not any(m.startswith('messyerraytracer_tpu.') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_entry_points_default_to_the_card():
    import inspect

    from messyerraytracer_tpu_torch.accel import bvh as pbvh
    from messyerraytracer_tpu_torch.core import types as ptypes
    from messyerraytracer_tpu_torch.debug import debug as pdebug
    from messyerraytracer_tpu_torch.kernels import cluster as pcluster
    from messyerraytracer_tpu_torch.kernels import cluster_tlas as pctlas
    from messyerraytracer_tpu_torch.render import camera as pcamera
    from messyerraytracer_tpu_torch.scene import serialize as pserialize

    cuda = torch.device("cuda")
    for fn in (build_scene, SceneTLAS.__init__, pbvh.build_bvh,
               pbvh._finalize_bvh, pbvh.build_bvh_over_aabbs,
               pctlas.build_cluster_tlas, pctlas.cluster_tlas_from_jax,
               pcluster.cluster_scene_from_jax, ptypes.make_miss,
               ptypes.make_triangles, pcamera.generate_rays,
               pcamera.debug_grid_rays, pdebug.cast_debug_rays,
               pserialize.load_scene):
        assert inspect.signature(fn).parameters["device"].default == cuda, fn
    # make_rays follows a tensor argument, else the card
    assert inspect.signature(
        ptypes.make_rays).parameters["device"].default is None
    o = torch.zeros((2, 3))
    assert pmrt.make_rays(o, torch.ones((2, 3))).origin.device == o.device

    tris = pmeshes.box()
    cam = pmrt.CameraParams.look_at((0, 0, 3), (0, 0, 0), fov_degrees=30.0)
    if torch.cuda.is_available():                  # decided here, not at import
        assert build_scene_from_tri_array(tris).tris.v0.device.type == "cuda"
        assert pmrt.generate_rays(cam, 4, 3).origin.device.type == "cuda"
    else:
        # no silent fallback to the CPU: torch's own error
        with pytest.raises((AssertionError, RuntimeError)):
            build_scene_from_tri_array(tris)
        with pytest.raises((AssertionError, RuntimeError)):
            pmrt.generate_rays(cam, 4, 3)
        with pytest.raises((AssertionError, RuntimeError)):
            pmrt.make_rays(np.zeros((1, 3)), np.ones((1, 3)))
    scene = build_scene_from_tri_array(tris, device="cpu")
    rays = pmrt.generate_rays(cam, 4, 3, device="cpu")
    h, _ = scene.cast_rays(rays)
    assert h.t.device.type == "cpu" and bool(h.hit.any())
