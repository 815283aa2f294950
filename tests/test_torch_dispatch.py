"""The port's Morton sort and RayDispatcher against the JAX package's.

Morton keys and sort permutations must be exactly equal; casts compare by
the bench.py parity rule (the port casts on its cluster tables, the JAX
side on its brute oracle).  Inputs are made with numpy from a seed."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (ANCHOR_ATOL, assert_parity, jax_rays,
                                np_of, port_rays, rand_rays_np)

from messyerraytracer_tpu.dispatch import dispatcher as jdisp
from messyerraytracer_tpu.dispatch import morton as jm
from messyerraytracer_tpu.scene.scene import (
    build_scene_from_tri_array as jax_build)
from messyerraytracer_tpu_torch.dispatch import dispatcher as pdisp
from messyerraytracer_tpu_torch.dispatch import morton as pm
from messyerraytracer_tpu_torch.scene.scene import build_scene_from_tri_array
from messyerraytracer_tpu_torch.utils import meshes

LO = np.float32([-5.0, -1.0, -4.0])
HI = np.float32([6.0, 4.5, 5.0])


def scene_tris():
    return np.concatenate([
        meshes.uv_sphere(radius=1.2, rings=8, segments=14,
                         center=(0, 1.2, 0)),
        meshes.plane(6.0, y=0.0, subdiv=10)])


@pytest.fixture(scope="module")
def scenes():
    tris = scene_tris()
    return (build_scene_from_tri_array(tris, device="cpu"),
            jax_build(tris, backend="brute"))


def test_morton_keys_exact_10k():
    rng = np.random.default_rng(1)
    v = np.arange(1024, dtype=np.int32)
    np.testing.assert_array_equal(
        np_of(pm.morton_spread_10(torch.from_numpy(v))),
        np_of(jm.morton_spread_10(jnp.asarray(v))))
    xyz = rng.integers(0, 1024, (3, 10_000)).astype(np.int32)
    np.testing.assert_array_equal(
        np_of(pm.morton_encode_3d(*(torch.from_numpy(a) for a in xyz))),
        np_of(jm.morton_encode_3d(*(jnp.asarray(a) for a in xyz))))
    o, d = rand_rays_np(10_000, seed=2)
    d[::37] = 0.0                        # zero directions: octant 0
    o[::41] = HI + 1.0                   # outside the box: clamped
    for pf, args in (("ray_direction_morton", (d,)),
                     ("ray_position_morton", (o, LO, HI)),
                     ("ray_6d_morton", (o, d, LO, HI))):
        got = getattr(pm, pf)(*(torch.from_numpy(a) for a in args))
        want = getattr(jm, pf)(*(jnp.asarray(a) for a in args))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np_of(got), np_of(want))


@pytest.mark.parametrize("octant_major,dir_bits,with_live", [
    (True, 1, False), (True, 1, True), (True, 2, False), (True, 2, True),
    (False, 1, False), (False, 1, True)])
def test_sort_perm_6d_exact_10k(octant_major, dir_bits, with_live):
    o, d = rand_rays_np(10_000, seed=3)
    live = np.random.default_rng(4).random(10_000) < 0.6
    kw = dict(octant_major=octant_major, dir_bits=dir_bits)
    got = pm.sort_perm_6d(port_rays(o, d), torch.from_numpy(LO),
                          torch.from_numpy(HI),
                          live=torch.from_numpy(live) if with_live else None,
                          **kw)
    want = jm.sort_perm_6d(jax_rays(o, d), jnp.asarray(LO), jnp.asarray(HI),
                           live=jnp.asarray(live) if with_live else None,
                           **kw)
    np.testing.assert_array_equal(np_of(got), np_of(want))
    # the sorted rays and the direction-only sort agree as well
    sr, sp = pm.sort_rays_6d(port_rays(o, d), LO, HI, **kw)
    jr, jp = jm.sort_rays_6d(jax_rays(o, d), jnp.asarray(LO),
                             jnp.asarray(HI), **kw)
    np.testing.assert_array_equal(np_of(sp), np_of(jp))
    np.testing.assert_array_equal(np_of(sr.origin), np_of(jr.origin))
    _, dp = pm.sort_rays_by_direction(port_rays(o, d))
    _, dj = jm.sort_rays_by_direction(jax_rays(o, d))
    np.testing.assert_array_equal(np_of(dp), np_of(dj))


def test_full_wave_sort_equals_prefix_buckets():
    """The wavefront tracer sorts the whole wave where the JAX package
    sorts a live prefix and appends the tail: with every ray past the
    prefix dead, the two permutations are equal."""
    n, b = 40_000, 20_480
    o, d = rand_rays_np(n, seed=5)
    live = np.random.default_rng(6).random(n) < 0.5
    live[b:] = False
    lo, hi = jnp.asarray(LO), jnp.asarray(HI)
    sub = jax_rays(o[:b], d[:b])
    want = np.concatenate([
        np_of(jm.sort_perm_6d(sub, lo, hi, live=jnp.asarray(live[:b]))),
        np.arange(b, n)])
    got = pm.sort_perm_6d(port_rays(o, d), LO, HI,
                          live=torch.from_numpy(live))
    np.testing.assert_array_equal(np_of(got), want)


def test_two_pass_key_in_int64():
    """The two-pass destination key, against an independent numpy int64
    key; its uint32 form (the JAX package's) wraps for destinations high
    in the box."""
    n = 4096
    rng = np.random.default_rng(7)
    o = rng.uniform(LO, HI, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ph_t = rng.uniform(0.1, 3.0, n).astype(np.float32)
    ph_hit = rng.random(n) < 0.7
    t_max = np.where(rng.random(n) < 0.5, 3e38, 2.5).astype(np.float32)
    diag = float(np.linalg.norm(HI - LO))
    cap, keys = pdisp.destination_keys(
        port_rays(o, d, t_max=t_max), torch.from_numpy(ph_t),
        torch.from_numpy(ph_hit), LO, HI, diag)
    assert keys.dtype == torch.int64
    dest_t = np.where(ph_hit, ph_t, np.minimum(t_max, np.float32(diag)))
    dest = o + d * dest_t[:, None]
    q = (np.clip((dest - LO) / np.maximum(HI - LO, 1e-12), 0, 1)
         * 1023.0).astype(np.int64)

    def spread(v):
        out = np.zeros_like(v)
        for bit in range(10):
            out |= ((v >> bit) & 1) << (3 * bit)
        return out

    okey = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    octant = ((d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2
              + (d[:, 2] < 0)).astype(np.int64)
    want = (okey << 3) | octant
    np.testing.assert_array_equal(np_of(keys), want)
    np.testing.assert_array_equal(
        np_of(cap), np.where(ph_hit, ph_t * np.float32(1.001), t_max))
    assert (want >= 1 << 32).any()          # the uint32 key would wrap
    assert (want.astype(np.uint32) != want).any()


def test_sort_unshuffle_roundtrip(scenes):
    ps, _ = scenes
    o, d = rand_rays_np(777, seed=8)
    rays = port_rays(o, d)
    sr, perm = pm.sort_rays_by_direction(rays)
    assert sorted(np_of(perm).tolist()) == list(range(777))
    keys = np_of(pm.ray_direction_morton(sr.direction))
    assert (np.diff(keys) >= 0).all()
    flags = torch.from_numpy(np.arange(777) % 3 == 0)
    np.testing.assert_array_equal(
        np_of(pm.unshuffle_flags(flags[perm], perm)), np_of(flags))
    ref, _ = ps.cast_rays(rays)
    hs, _ = ps.cast_rays(sr)
    back = pm.unshuffle_hits(hs, perm)
    for f in ("t", "position", "normal", "u", "v", "prim_id",
              "hit_layers"):
        assert torch.equal(getattr(back, f), getattr(ref, f)), f


def test_profiler_ranges_split_a_sorted_cast(scenes):
    """Each stage of a sorted cast runs inside its torch.profiler range,
    once per cast: key, sort, gather, cast (kernel B1 and its hit
    assembly) and unshuffle; a coherent cast runs only the cast."""
    from torch.profiler import ProfilerActivity, profile

    ps, _ = scenes
    o, d = rand_rays_np(640, seed=10, extent=4.0)
    disp = pdisp.RayDispatcher(ps)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        disp.cast_rays(port_rays(o, d))
        disp.any_hit_rays(port_rays(o, d))
        disp.cast_rays(port_rays(o, d), coherent=True)
    names = [e.name for e in prof.events()]
    for stage in ("morton.key", "morton.sort", "morton.gather",
                  "morton.unshuffle"):
        assert names.count(stage) == 2, stage
    assert names.count("cast") == 3


@pytest.mark.parametrize("sort", ["6d", "6d-origin", "direction"])
def test_dispatcher_sorted_equals_unsorted_and_jax(scenes, sort):
    ps, js = scenes
    o, d = rand_rays_np(640, seed=9, extent=4.0)
    disp = pdisp.RayDispatcher(ps, sort=sort)
    hs, ss = disp.cast_rays(port_rays(o, d))
    hu, su = disp.cast_rays(port_rays(o, d), coherent=True)
    for f in ("t", "position", "normal", "u", "v", "prim_id",
              "hit_layers"):
        assert torch.equal(getattr(hs, f), getattr(hu, f)), f
    assert int(ss.hits) == int(su.hits) == int(hs.hit.sum())
    hj, _ = jdisp.RayDispatcher(js, sort=sort).cast_rays(jax_rays(o, d))
    assert_parity(hs, hj, atol=ANCHOR_ATOL)
    occ = disp.any_hit_rays(port_rays(o, d))
    occ_u = disp.any_hit_rays(port_rays(o, d), coherent=True)
    assert torch.equal(occ, occ_u) and torch.equal(occ, hs.hit)
    np.testing.assert_array_equal(
        np_of(occ), np_of(jdisp.RayDispatcher(js).any_hit_rays(
            jax_rays(o, d))))


def test_batches_under_256_are_not_sorted(scenes, monkeypatch):
    ps, _ = scenes
    calls = []
    real = pdisp.sort_rays_6d
    monkeypatch.setattr(pdisp, "sort_rays_6d",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    disp = pdisp.RayDispatcher(ps)
    for n, sorted_ in ((pdisp.MIN_BATCH_FOR_SORTING - 1, False),
                       (pdisp.MIN_BATCH_FOR_SORTING, True)):
        calls.clear()
        o, d = rand_rays_np(n, seed=10)
        h, _ = disp.cast_rays(port_rays(o, d))
        disp.any_hit_rays(port_rays(o, d))
        assert bool(calls) == sorted_, n
        ref, _ = ps.cast_rays(port_rays(o, d))
        assert torch.equal(h.t, ref.t) and torch.equal(h.prim_id,
                                                       ref.prim_id)


def _finite_ranges(n, seed):
    o, d = rand_rays_np(n, seed=seed, extent=4.0)
    rng = np.random.default_rng(seed + 1)
    t_min = rng.uniform(0, 0.5, n).astype(np.float32)
    t_max = np.where(rng.random(n) < 0.3, rng.uniform(1, 6, n),
                     3e38).astype(np.float32)
    return o, d, t_min, t_max


def _assert_equal_hits(a, b):
    for f in ("t", "position", "normal", "u", "v", "prim_id",
              "hit_layers"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("sort", ["6d", "6d-origin"])
def test_windowed_cast_exact_parity(scenes, sort):
    ps, js = scenes
    o, d, t_min, t_max = _finite_ranges(640, 11)
    rays = port_rays(o, d, t_min, t_max)
    ref, ref_stats = pdisp.RayDispatcher(ps, sort=sort).cast_rays(rays)
    hits, stats = pdisp.RayDispatcher(
        ps, sort=sort, windows=(0.2, 0.05, 0.5)).cast_rays(rays)
    _assert_equal_hits(hits, ref)
    assert int(stats.rays_cast) == 640
    assert int(stats.hits) == int(ref_stats.hits)
    assert int(stats.stack_drops) == 0
    hj, _ = jdisp.RayDispatcher(js, sort=sort, windows=(0.05, 0.2, 0.5)
                                ).cast_rays(jax_rays(o, d, t_min, t_max))
    assert_parity(hits, hj, atol=ANCHOR_ATOL)
    with pytest.raises(ValueError, match="> 0"):
        pdisp.RayDispatcher(ps, windows=(0.0,)).cast_rays(rays)


@pytest.mark.parametrize("slack,rescue_batch", [
    (1.001, 8192),      # the shipped caps: a rescue only on a crack
    (0.5, 8192),        # caps below the hit: every proxy hit is rescued
    (0.5, 4)])          # more lost rays than a rescue batch: full re-cast
def test_two_pass_proxy_exact_and_counts_merged_hits(monkeypatch, slack,
                                                     rescue_batch):
    tris = np.concatenate([
        meshes.uv_sphere(radius=1.2, rings=8, segments=14,
                         center=(0, 1.2, 0)),
        meshes.plane(6.0, y=0.0, subdiv=24)])       # a proxy of 172 tris
    ps = build_scene_from_tri_array(tris, device="cpu")
    js = jax_build(tris, backend="brute")
    monkeypatch.setattr(pdisp, "PROXY_MIN_BATCH", 256)
    monkeypatch.setattr(pdisp, "PROXY_SLACK", slack)
    monkeypatch.setattr(pdisp, "RESCUE_BATCH", rescue_batch)
    o, d = rand_rays_np(768, seed=4, extent=3.0)
    h0, s0 = pdisp.RayDispatcher(ps).cast_rays(port_rays(o, d))
    disp = pdisp.RayDispatcher(ps, proxy=True)
    h1, s1 = disp.cast_rays(port_rays(o, d))
    assert disp._proxy_scene(ps).num_tris == -(-len(tris) // 8)
    _assert_equal_hits(h1, h0)
    assert int(s1.rays_cast) == 768
    # hits are counted from the merged result, rescued rays included
    assert int(s1.hits) == int(h1.hit.sum()) == int(s0.hits)
    assert int(s1.tri_tests) > int(s0.tri_tests)   # the proxy pass counts
    hj, _ = jdisp.RayDispatcher(js).cast_rays(jax_rays(o, d))
    assert_parity(h1, hj, atol=ANCHOR_ATOL)


def test_recycled_scene_never_gets_stale_bounds():
    """The per-scene caches hold the BVH weakly: an entry dies with its
    scene, so a later scene (which may reuse the dead one's id()) always
    gets its own bounds."""
    o, d = rand_rays_np(512, seed=12)
    small = build_scene_from_tri_array(meshes.uv_sphere(1.0, 6, 12),
                                       device="cpu")
    disp = pdisp.RayDispatcher(small)
    disp.cast_rays(port_rays(o, d))
    assert len(disp._bounds_cache) == 1
    lo, hi = disp._scene_bounds(small)
    np.testing.assert_array_equal(np_of(hi), small.bvh.host["aabb_max"][0])
    del small, lo, hi
    disp.scene = None
    gc.collect()
    assert len(disp._bounds_cache) == 0
    for k in range(4):          # new scenes, new extents, maybe old ids
        big = build_scene_from_tri_array(
            meshes.uv_sphere(2.0 + k, 6, 12), device="cpu")
        disp.scene = big
        h, _ = disp.cast_rays(port_rays(o, d))
        lo, hi = disp._scene_bounds(big)
        np.testing.assert_array_equal(np_of(lo), big.bvh.host["aabb_min"][0])
        np.testing.assert_array_equal(np_of(hi), big.bvh.host["aabb_max"][0])
        assert disp._scene_diag(big) == pytest.approx(
            float(np.linalg.norm(np_of(hi) - np_of(lo))))
        ref, _ = big.cast_rays(port_rays(o, d))
        _assert_equal_hits(h, ref)
        del big, lo, hi
        disp.scene = None
        gc.collect()
        assert len(disp._bounds_cache) == 0


@pytest.mark.gpu
def test_card_dispatch_equals_cpu(scenes):
    """The sorted cast on the card (kernel B1) against the CPU (its plain
    version) on the same scene and rays: equal prim ids, layers and hit
    flags; t, u, v and normals within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = build_scene_from_tri_array(scene_tris(), device="cpu")
    card = build_scene_from_tri_array(scene_tris(), device="cuda")
    o, d = rand_rays_np(4096, seed=13, extent=4.0)
    hc, _ = pdisp.RayDispatcher(cpu).cast_rays(port_rays(o, d))
    hg, sg = pdisp.RayDispatcher(card).cast_rays(
        port_rays(o, d).to("cuda"))
    assert int(sg.stack_drops) == 0
    for f in ("prim_id", "hit_layers"):
        assert torch.equal(getattr(hg, f).cpu(), getattr(hc, f)), f
    for f in ("t", "u", "v", "normal"):
        np.testing.assert_allclose(np_of(getattr(hg, f)),
                                   np_of(getattr(hc, f)), atol=1e-6,
                                   rtol=1e-6)
    occ = pdisp.RayDispatcher(card).any_hit_rays(port_rays(o, d).to("cuda"))
    assert torch.equal(occ.cpu(), hc.hit)
