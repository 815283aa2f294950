"""The port's RayTracerService, RayBatch and probe_cast against the JAX
package's.  The port casts on its cluster tables (the plain version on the
CPU), the JAX service on its brute oracle; hits compare by the bench.py
parity rule, ids and flags exactly."""

import numpy as np
import pytest
import torch
from torch_port_helpers import (ANCHOR_ATOL, assert_parity, jax_rays,
                                np_of, port_rays, rand_rays_np)

from messyerraytracer_tpu.api import service as jsvc
from messyerraytracer_tpu_torch.api import service as psvc
from messyerraytracer_tpu_torch.utils import meshes


def translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def fill(svc):
    svc.register_mesh(meshes.uv_sphere(1.0, 8, 16), translate((0, 0, 0)))
    svc.register_mesh(meshes.uv_sphere(0.5, 6, 12), translate((2, 0.5, 0)),
                      layers=0b10)
    svc.register_mesh(meshes.plane(20.0, y=-2.0), None)
    svc.build()
    return svc


@pytest.fixture(scope="module")
def services():
    port = fill(psvc.RayTracerService(device="cpu"))
    jax = fill(jsvc.RayTracerService(backend="brute"))
    return port, jax


PROBES = [((0.11, 0.07, 4), (0, 0, -1)), ((0.11, 10, 4), (0, 0, -1)),
          ((2.03, 0.52, 4), (0, 0, -1)), ((5, 3, 5), (-0.5, -0.6, -0.6)),
          ((0.3, 5, 0.2), (0, -1, 0))]


def assert_same_dict(p, j):
    assert p["hit"] == j["hit"]
    for k in ("prim_id", "hit_layers", "instance_id"):
        assert p[k] == j[k], k
    if p["hit"]:
        assert p["distance"] == pytest.approx(j["distance"], rel=1e-5)
    else:
        assert p["distance"] == j["distance"] == float("inf")
    for k in ("position", "normal"):
        np.testing.assert_allclose(p[k], np.asarray(j[k]), atol=1e-5)


def test_cast_ray_dict_equals_jax(services):
    port, jax = services
    for o, d in PROBES:
        assert_same_dict(port.cast_ray(o, d), jax.cast_ray(o, d))
    # a layer mask and a t_max
    for kw in ({"layer_mask": 0b10}, {"t_max": 2.5}):
        o, d = (2.03, 0.52, 4), (0, 0, -1)
        assert_same_dict(port.cast_ray(o, d, **kw), jax.cast_ray(o, d, **kw))


@pytest.mark.parametrize("n,coherent", [(300, False), (300, True),
                                        (64, False)])
def test_submit_equals_jax(services, n, coherent):
    port, jax = services
    o, d = rand_rays_np(n, seed=n, extent=3.0)
    pr = port.submit(psvc.RayQuery(rays=port_rays(o, d), coherent=coherent))
    jr = jax.submit(jsvc.RayQuery(rays=jax_rays(o, d), coherent=coherent))
    assert_parity(pr.hits, jr.hits, atol=ANCHOR_ATOL)
    assert pr.elapsed_ms > 0 and pr.hit_flags is None
    ps, js = port.get_last_stats(), jax.get_last_stats()
    assert set(ps) == set(js)
    assert ps["rays_cast"] == js["rays_cast"] == n
    assert ps["hits"] == js["hits"] == int(pr.hits.hit.sum())
    assert ps["backend"] == "cluster"
    pf = port.submit(psvc.RayQuery(rays=port_rays(o, d),
                                   mode=psvc.MODE_ANY_HIT,
                                   coherent=coherent)).hit_flags
    jf = jax.any_hit_batch(jax_rays(o, d))
    np.testing.assert_array_equal(np_of(pf), np_of(jf))
    assert torch.equal(pf, pr.hits.hit)
    hb, sb = port.cast_rays_batch(port_rays(o, d), coherent=coherent)
    assert torch.equal(hb.t, pr.hits.t) and int(sb.hits) == ps["hits"]


def test_async_tickets(services):
    port, _ = services
    batches = [rand_rays_np(300, seed=s) for s in (1, 2, 3)]
    tickets = [port.submit_async(psvc.RayQuery(rays=port_rays(o, d),
                                               mode=mode))
               for (o, d), mode in zip(batches, (psvc.MODE_NEAREST,
                                                 psvc.MODE_ANY_HIT,
                                                 psvc.MODE_NEAREST))]
    for t, (o, d) in reversed(list(zip(tickets, batches))):
        got = port.collect_async(t)
        ref = port.submit(psvc.RayQuery(rays=port_rays(o, d)))
        if got.hits is None:
            assert torch.equal(got.hit_flags, ref.hits.hit)
        else:
            assert torch.equal(got.hits.t, ref.hits.t)
            assert int(got.stats.hits) == int(ref.stats.hits)


def test_backend_chain_equals_jax(services):
    port, jax = services
    o, d = PROBES[0]
    want = jax.cast_ray(o, d)
    try:
        for b in ("jnp", "brute", "pallas", "cluster", "auto"):
            port.set_backend(b)
            jax.set_backend(b)
            assert port.get_backend() == jax.get_backend(), b
            assert_same_dict(port.cast_ray(o, d), want)
        with pytest.raises(ValueError, match="backend"):
            port.set_backend("gpu")
        for b in ("frontier", "frontier_q"):
            port.set_backend(b)
            jax.set_backend(b)
            assert port.get_backend() == jax.get_backend() == b
            assert_same_dict(port.cast_ray(o, d), want)
    finally:
        port.set_backend("auto")
        jax.set_backend("brute")


def test_ray_batch_and_probe_equal_jax(services):
    port, jax = services
    batches = (psvc.RayBatch(port), jsvc.RayBatch(jax))
    for b in batches:
        for o, d in PROBES:
            b.add_ray(o, d)
        b.add_ray_ex((0.11, 0.07, 4), (0, 0, -1), 1e-3, 1.0)  # t_max clips
        assert b.size == len(PROBES) + 1
        b.cast()
    pb, jb = batches
    for i in range(pb.size):
        assert pb.is_hit(i) == jb.is_hit(i)
        assert pb.get_prim_id(i) == jb.get_prim_id(i)
        assert pb.get_distance(i) == pytest.approx(jb.get_distance(i),
                                                   rel=1e-5)
        np.testing.assert_allclose(pb.get_position(i), jb.get_position(i),
                                   atol=1e-5)
        np.testing.assert_allclose(pb.get_normal(i), jb.get_normal(i),
                                   atol=1e-5)
    assert pb.get_stats()["rays_cast"] == pb.size
    pb.clear()
    assert pb.size == 0
    c, s_ = np.cos(0.5), np.sin(0.5)
    turned = np.float32([[c, 0, s_, 1.9], [0, 1, 0, 0.3], [-s_, 0, c, 4.2]])
    for m in (translate((0.11, 0.07, 4)), translate((2.03, 0.52, 4))[:3],
              turned):
        assert_same_dict(psvc.probe_cast(port, m),
                         jsvc.probe_cast(jax, m))
        assert_same_dict(psvc.probe_cast(port, m, (0, -1, 0), 3.0),
                         jsvc.probe_cast(jax, m, (0, -1, 0), 3.0))


@pytest.mark.gpu
def test_card_service_equals_cpu(services):
    """The service on the card (B1 through the dispatcher) against the CPU
    service: equal prim ids, instance ids and occlusion flags; t within
    1e-6 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    port, _ = services
    card = fill(psvc.RayTracerService())
    assert card.device.type == "cuda"
    o, d = rand_rays_np(4096, seed=21, extent=3.0)
    for mode in (psvc.MODE_NEAREST, psvc.MODE_ANY_HIT):
        rc = port.submit(psvc.RayQuery(rays=port_rays(o, d), mode=mode))
        rg = card.submit(psvc.RayQuery(rays=port_rays(o, d).to("cuda"),
                                       mode=mode))
        if mode == psvc.MODE_ANY_HIT:
            assert torch.equal(rg.hit_flags.cpu(), rc.hit_flags)
            continue
        assert torch.equal(rg.hits.prim_id.cpu(), rc.hits.prim_id)
        np.testing.assert_allclose(np_of(rg.hits.t), np_of(rc.hits.t),
                                   rtol=1e-6)
    for o1, d1 in PROBES:
        assert_same_dict(card.cast_ray(o1, d1), port.cast_ray(o1, d1))
