"""PyTorch port: the wide-node layouts (binary dual-AABB and 8-wide) and
their quantized nodes, table for table against the JAX package, and the
wide cast's plain version against the JAX kernels in interpret mode
(``_mega_kernel``, and ``_traverse_kernel`` for the streamed casts) on
small scenes."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from messyerraytracer_tpu.kernels.traverse_pallas import (  # noqa: E402
    _to_columnar_q,
    cast_rays_wide as jax_cast_wide,
)
from messyerraytracer_tpu.scene import scene as jscene  # noqa: E402

import messyerraytracer_tpu_torch as pmrt  # noqa: E402
from messyerraytracer_tpu_torch.core.brute import cast_rays_brute  # noqa
from messyerraytracer_tpu_torch.kernels.traverse_pallas import (  # noqa
    cast_rays_wide,
    wide_cast_plain,
)
from messyerraytracer_tpu_torch.kernels.wide import (  # noqa: E402
    wide_scene_from_jax,
)
from messyerraytracer_tpu_torch.scene import scene as pscene  # noqa: E402
from messyerraytracer_tpu_torch.utils import meshes  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    assert_parity,
    assert_same_hits,
    jax_rays,
    np_of,
    port_rays,
    rand_rays_np,
    small_tris,
)

TABLES = ("node_box", "node_child", "node_axis", "leaf_tri", "leaf_count",
          "slot_prim_id", "slot_layers", "slot_normal", "slot_tri")
META = ("branching", "dummy_enc", "dummy_leaf", "stream_leaves",
        "stream_nodes", "stack_need")


def scene_tris(name):
    """(triangles, layers) of the table-test scenes."""
    if name == "sphere":
        return meshes.uv_sphere(1.0, 8, 16), None
    if name == "plane_sphere":
        tris = small_tris()
        lay = np.where(np.arange(len(tris)) % 3 == 0, 0b01, 0b10)
        return tris, lay.astype(np.int32)
    if name == "single":
        return np.float32([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]]), None
    # root-is-leaf: 3 triangles fit one leaf
    return meshes.box()[:3], None


def builds(name, branching):
    tris, lay = scene_tris(name)
    js = jscene.build_scene_from_tri_array(tris, layers=lay,
                                           backend="pallas",
                                           branching=branching)
    ps = pscene.build_scene_from_tri_array(tris, layers=lay,
                                           backend="pallas",
                                           branching=branching, device="cpu")
    return js, ps


def converted(jw):
    return wide_scene_from_jax(
        np.asarray(jw.nodes), np.asarray(jw.leaf_tris),
        np.asarray(jw.slot_prim_id), np.asarray(jw.slot_layers),
        np.asarray(jw.slot_normal), np.asarray(jw.slot_tri),
        branching=jw.branching, dummy_enc=jw.dummy_enc,
        dummy_leaf=jw.dummy_leaf, stream_leaves=jw.stream_leaves,
        stream_nodes=jw.stream_nodes, device="cpu")


@pytest.mark.parametrize("branching", [2, 8])
@pytest.mark.parametrize("name", ["sphere", "plane_sphere", "single",
                                  "root_leaf"])
def test_tables_equal_converted_jax_tables(name, branching):
    js, ps = builds(name, branching)
    conv, pw = converted(js.wide), ps.wide
    for f in TABLES:
        np.testing.assert_array_equal(np_of(getattr(pw, f)),
                                      np_of(getattr(conv, f)), err_msg=f)
    for f in META:
        assert getattr(pw, f) == getattr(conv, f), f
    assert (pw.dummy_enc, pw.dummy_leaf) == (js.wide.dummy_enc,
                                             js.wide.dummy_leaf)
    assert pw.branching == branching
    # the slot tables point at the scene's own triangles
    np.testing.assert_array_equal(np_of(ps.tris.prim_id)[np_of(pw.slot_tri)]
                                  [np_of(pw.slot_prim_id) >= 0],
                                  np_of(pw.slot_prim_id)[
                                      np_of(pw.slot_prim_id) >= 0])


@pytest.mark.parametrize("name", ["sphere", "plane_sphere", "root_leaf"])
def test_quantized_nodes_equal_jax(name):
    js, ps = builds(name, 8)
    nw = ps.wide.node_child.shape[0]
    q = np_of(_to_columnar_q(js.wide.nodes)).swapaxes(1, 2).reshape(-1, 32)
    q = q[:nw]
    anchor, scale, qlo, qhi = (np_of(x) for x in ps.wide.quantized())
    np.testing.assert_array_equal(anchor, q[:, 0:3])
    np.testing.assert_array_equal(scale, q[:, 3:6])
    np.testing.assert_array_equal(qlo, q[:, 6:14].astype(np.int32))
    np.testing.assert_array_equal(qhi, q[:, 14:22].astype(np.int32))
    # the decoded boxes contain the exact ones
    box = np_of(ps.wide.node_box)
    dec = np_of(ps.wide.quantized_boxes())
    present = np_of(ps.wide.node_child) >= 0
    assert np.all(dec[present][:, :3] <= box[present][:, :3])
    assert np.all(dec[present][:, 3:] >= box[present][:, 3:])


def test_vmem_fit_flags_match_jax():
    for n_int, n_leaf in ((10, 10), (10, 400_000), (2_000_000, 10),
                          (100_000, 300_000)):
        count = np.concatenate([np.zeros(n_int, np.int32),
                                np.ones(n_leaf, np.int32)])
        bvh = types.SimpleNamespace(host={"count": count})
        for k in (2, 8):
            assert (pscene._wide_vmem_fit(bvh, k)
                    == jscene._wide_vmem_fit(bvh, k))


def wide_rays(n, seed):
    """Rays from a seed over the small scene, with dead and
    zero-direction rays mixed in: (origin, direction, t_max)."""
    o, d = rand_rays_np(n, seed=seed)
    d[::53] = 0.0
    t_max = np.full(n, 3.402823466e38, np.float32)
    t_max[::41] = -1.0
    return o, d, t_max


@pytest.fixture(scope="module")
def small_wide():
    """JAX and port scenes of the small scene with layers, both layouts."""
    return {k: builds("plane_sphere", k) for k in (2, 8)}


# one interpret-mode JAX cast per case (<= 300 triangles, 1024 rays)
CASES = {
    "wide8_q": (8, {"columnar": "q"}),
    "wide8_mask": (8, {"query_mask": 0b10}),
    "binary": (2, {"columnar": True}),
    "wide8_stream": (8, {"stream_leaves": True, "stream_nodes": True}),
    "binary_stream_any": (2, {"stream_leaves": True, "stream_nodes": True,
                              "any_hit": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_cast_matches_jax_kernel(small_wide, case):
    branching, kw = CASES[case]
    js, ps = small_wide[branching]
    o, d, t_max = wide_rays(1024, seed=31)
    rj = jax_rays(o, d, t_max=t_max)
    rp = port_rays(o, d, t_max=t_max)
    hj, _, occ_j = jax_cast_wide(rj, js.wide, interpret=True, **kw)
    hp, sp, occ_p = cast_rays_wide(rp, ps.wide, **kw)
    if kw.get("any_hit"):
        # only occlusion is the any-hit contract: a TPU tile keeps
        # traversing until all its rays hit, so JAX's t/slot are not
        # first hits
        np.testing.assert_array_equal(occ_p.numpy(), np_of(occ_j))
    else:
        assert_same_hits(hp, hj)
        np.testing.assert_array_equal(occ_p.numpy(), np_of(hj.hit))
    assert int(sp.stack_drops) == 0
    dead = t_max < 0
    assert not occ_p.numpy()[dead].any()
    assert int(occ_p.sum()) > 100
    for f in ("t", "u", "v", "normal", "position"):
        assert bool(torch.isfinite(getattr(hp, f)).all())


@pytest.mark.parametrize("branching", [8, 2])
def test_tie_goes_to_the_lower_slot(branching):
    """Every triangle twice, the copy at a higher index: both copies share
    a leaf, and the strictly-closer update of the leaf test keeps the
    lower slot (the JAX kernel's rule, traverse_pallas.py:776-787)."""
    sph = meshes.uv_sphere(1.0, 6, 12)
    tris = np.concatenate([sph, sph])
    js = jscene.build_scene_from_tri_array(tris, backend="pallas",
                                           branching=branching)
    ps = pscene.build_scene_from_tri_array(tris, backend="pallas",
                                           branching=branching, device="cpu")
    cam = pmrt.CameraParams.look_at((0.3, 0.5, 4.0), (0, 0, 0),
                                    fov_degrees=40.0)
    r = pmrt.generate_rays(cam, 32, 32, device="cpu")
    o, d = np_of(r.origin), np_of(r.direction)
    rp = port_rays(o, d)
    w = ps.wide
    _, iout, _ = wide_cast_plain(rp.origin, rp.direction, rp.t_min,
                                 rp.t_max, w)
    slot = iout[0].numpy()
    hit = slot >= 0
    assert hit.sum() > 300
    tri = np_of(w.slot_prim_id).reshape(-1, 4) % len(sph)   # copy -> tri
    leaf, k = slot[hit] // 4, slot[hit] % 4
    same = tri[leaf] == tri[leaf, k][:, None]                # its copies
    assert (same.sum(axis=1) == 2).all()                     # share a leaf
    np.testing.assert_array_equal(k, same.argmax(axis=1))    # lower slot
    # the JAX kernel in interpret mode keeps the same slots, so the same
    # prim ids; the brute oracle agrees by the parity rule
    hp, _, _ = cast_rays_wide(rp, w)
    hj, _, _ = jax_cast_wide(jax_rays(o, d), js.wide, interpret=True)
    assert_same_hits(hp, hj)
    np.testing.assert_array_equal(np_of(hp.prim_id), np_of(hj.prim_id))
    hb, _ = cast_rays_brute(rp, ps.tris)
    assert_parity(hp, hb)
