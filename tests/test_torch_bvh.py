"""PyTorch port: BVH build, native builder binding and the host-side cluster
helpers, bit for bit against the JAX package."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu import native as jnative  # noqa: E402
from messyerraytracer_tpu.accel import bvh as jbvh  # noqa: E402
from messyerraytracer_tpu.kernels import cluster as jcluster  # noqa: E402
from messyerraytracer_tpu.kernels import wide as jwide  # noqa: E402

from messyerraytracer_tpu_torch import native as pnative  # noqa: E402
from messyerraytracer_tpu_torch.accel import bvh as pbvh  # noqa: E402
from messyerraytracer_tpu_torch.core import types as ptypes  # noqa: E402
from messyerraytracer_tpu_torch.kernels import cluster as pcluster  # noqa
from messyerraytracer_tpu_torch.kernels import wide as pwide  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    jax_cluster_scene,
    small_tris,
    terrain_tris,
)

FIELDS = ("aabb_min", "aabb_max", "left_first", "count", "tri_order",
          "split_axis")


def soup(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10.0, 10.0, (n, 1, 3)).astype(np.float32)
    return c + rng.uniform(-0.3, 0.3, (n, 3, 3)).astype(np.float32)


def assert_bvh_equal(bp, bj):
    for f in FIELDS:
        a = bp.host[f]
        np.testing.assert_array_equal(a, np.asarray(getattr(bj, f)))
        np.testing.assert_array_equal(getattr(bp, f).numpy(), a)
    assert len(bp.levels) == len(bj.levels)
    for lp, lj in zip(bp.levels, bj.levels):
        assert lp.dtype == torch.int32
        np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))


def test_native_library_builds_from_the_jax_source():
    lib = pnative.get_native_lib()
    assert lib is not None
    # the port compiles its own verbatim copy of the JAX package's source
    assert pnative.SAH_SRC.endswith("messyerraytracer_tpu_torch/native/"
                                    "sah_builder.cpp")
    jax_src = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "messyerraytracer_tpu", "native",
                           "sah_builder.cpp")
    with open(pnative.SAH_SRC, "rb") as a, open(jax_src, "rb") as b:
        assert a.read() == b.read()
    assert pnative.BUILD_DIR.endswith("messyerraytracer_tpu_torch/_build")


@pytest.mark.parametrize("scene", ["soup", "terrain"])
def test_build_bvh_matches_jax(scene):
    tris = soup(3000, 1) if scene == "soup" else terrain_tris(30)
    v = (tris[:, 0], tris[:, 1], tris[:, 2])
    assert_bvh_equal(pbvh.build_bvh(*v, device="cpu"), jbvh.build_bvh(*v))


@pytest.mark.parametrize("max_leaf_size", [1, 4])
def test_build_bvh_over_aabbs_matches_jax(max_leaf_size):
    rng = np.random.default_rng(2)
    lo = rng.uniform(-20, 20, (700, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 2, (700, 3)).astype(np.float32)
    c = (lo + hi) * 0.5
    assert_bvh_equal(pbvh.build_bvh_over_aabbs(lo, hi, c, max_leaf_size,
                                                device="cpu"),
                     jbvh.build_bvh_over_aabbs(lo, hi, c, max_leaf_size))


def test_numpy_builder_matches_jax():
    tris = soup(150, 3)
    lo = np.minimum(np.minimum(tris[:, 0], tris[:, 1]), tris[:, 2])
    hi = np.maximum(np.maximum(tris[:, 0], tris[:, 1]), tris[:, 2])
    c = tris.mean(axis=1)
    assert_bvh_equal(
        pbvh.build_bvh_over_aabbs(lo, hi, c, use_native=False,
                                  device="cpu"),
        jbvh.build_bvh_over_aabbs(lo, hi, c, use_native=False))


@pytest.mark.parametrize("fn", ["mrt_build_bvh", "mrt_build_bvh_aabbs",
                                "mrt_build_wide8_tables"])
def test_native_bindings_match_jax(fn):
    def sig(lib):
        f = getattr(lib, fn)
        return f.restype, [(a.__name__, getattr(a, "_dtype_", None))
                           for a in f.argtypes]

    assert sig(pnative.get_native_lib()) == sig(jnative.get_native_lib())


def test_cluster_helpers_match():
    b = jbvh.build_bvh(*(terrain_tris(25)[:, k] for k in range(3))).host
    lf, cnt = b["left_first"], b["count"]
    for tcap in (32, 64):
        for a, j in zip(pcluster.cluster_cut(lf, cnt, tcap),
                        jcluster.cluster_cut(lf, cnt, tcap)):
            np.testing.assert_array_equal(a, j)
    for a, j in zip(pwide._collapse8(b["aabb_min"], b["aabb_max"], lf, cnt),
                    jwide._collapse8(b["aabb_min"], b["aabb_max"], lf, cnt)):
        np.testing.assert_array_equal(a, j)
    assert (pwide.NODE8_STRIDE, pwide.WIDE8_CAP) == (jwide.NODE8_STRIDE,
                                                     jwide.WIDE8_CAP)
    for n in (0, 30, 62, 63, 200):
        assert ptypes.kstack_for(n) == jcluster._kstack_for(n)
    for n in (10, 300_000, 300_001, 10**6):
        assert pcluster.cluster_tcap_for(n) == jcluster.cluster_tcap_for(n)


@pytest.mark.parametrize("tcap", [32, 64])
def test_stack_need_and_dummy_enc_match(tcap):
    tris = terrain_tris(40)
    _, jcs = jax_cluster_scene(tris, tcap)
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    ps = build_scene_from_tri_array(tris, device="cpu")
    pcs = pcluster.build_cluster_scene(ps.bvh, ps.tris, tcap=tcap)
    assert pcs.stack_need == jcs.stack_need
    assert pcs.dummy_enc == jcs.dummy_enc
    assert pcs.num_clusters == jcs.num_clusters
    assert pcs.node_child.shape[0] == jcs.dummy_enc // 2


def test_prim_id_guard_kept():
    tris = small_tris()
    b = pbvh.build_bvh(*(tris[:, k] for k in range(3)), device="cpu")
    n = len(tris)
    host = (tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0],
            None, np.full(n, 1 << 24, np.int32), np.full(n, -1, np.int32))
    with pytest.raises(ValueError, match="2\\^24"):
        pcluster.build_cluster_scene(b, None, _np=host)

