"""Nearest and line-of-sight batches in a closed loop through the service
on kernel B4: each unit is one ``RayTracerService.submit(RayQuery(rays,
mode=..., coherent=...))`` (range ``raybench.submit``) on a service
constructed with the traffic's ``backend`` ("pallas": the flat twin's
8-wide tables), which sorts the batch by its Morton key, casts it and
returns the answers in the submitted order.  Unit i submits pool batch
i mod ``pool_batches``: even batches are nearest queries drawn as
``service_batches.ray_pool`` draws them, odd batches any-hit queries
along segments a -> b between two points drawn as its origins (t_max =
|b - a|).  The pool is made on the device in set-up from the seed.

A kept unit is kept with the latest unit of the other mode, so that
every check judges both modes; the unit's ``sample_rays`` are split
between the two.

A program whose service does not resolve to the traffic's backend cannot
run this configuration, and the cell stops in set-up."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..reference import judge as rjudge
from ..reference import occlusion
from . import (hits_dict, judge_cast, reference_world, sample_idx,
               timed_build)
from .service_batches import ray_pool


def seed_of(seed: int, stream: int) -> int:
    """A seed for the pool's ``stream``, drawn from the run's seed."""
    rng = np.random.default_rng([seed % (1 << 63), stream])
    return int(rng.integers(0, 1 << 62))


def sight_pool(tr: dict, seed: int, device):
    """(P, N, 3) segment starts a and unit directions to the ends b, (P,
    N) t_min and t_max = |b - a|; a and b are ``ray_pool``'s origins of
    two seeds derived from ``seed``."""
    sa, sb = (seed_of(seed, k) for k in (0xA0, 0xB0))
    a, b = ray_pool(tr, sa, device)[0], ray_pool(tr, sb, device)[0]
    ab = b - a
    length = torch.linalg.vector_norm(ab, dim=-1)
    d = ab / length[..., None]
    tmin = torch.full(length.shape, float(tr["t_min"]), device=device)
    return a, d.contiguous(), tmin, length.contiguous()


def build_service(ctx):
    from messyerraytracer_tpu_torch.api.service import RayTracerService

    svc = RayTracerService(backend=ctx.traffic["backend"], device=ctx.device)
    blas = {}
    for mesh_id, xf in ctx.inputs["instances"]:
        if mesh_id in blas:
            svc.add_instance(blas[mesh_id], xf)
        else:
            svc.register_mesh(ctx.inputs["meshes"][mesh_id], xf)
            blas[mesh_id] = len(svc.tlas.meshes) - 1
    svc.build()
    return svc


class Work:
    def __init__(self, ctx):
        from messyerraytracer_tpu_torch.api.service import (MODE_ANY_HIT,
                                                            MODE_NEAREST,
                                                            RayQuery)
        from messyerraytracer_tpu_torch.core.types import Rays

        self.ctx, tr = ctx, ctx.traffic
        self.svc, self.build_s = timed_build(ctx, lambda: build_service(ctx))
        got = self.svc.get_backend()
        if got != tr["backend"]:
            raise RuntimeError(
                f"the service constructed with backend {tr['backend']!r} "
                f"casts on {got!r}: the program cannot run this "
                f"configuration")
        half = dict(tr, pool_batches=tr["pool_batches"] // 2)
        near = ray_pool(half, ctx.seed, ctx.device)
        sight = sight_pool(half, ctx.seed, ctx.device)
        # batch p: nearest at even p, any-hit at odd p
        self.pool = [(MODE_NEAREST, tuple(x[p // 2] for x in near))
                     if p % 2 == 0 else
                     (MODE_ANY_HIT, tuple(x[p // 2] for x in sight))
                     for p in range(2 * half["pool_batches"])]
        self.queries = [RayQuery(rays=Rays(*rays), mode=mode,
                                 coherent=bool(tr["coherent"]))
                        for mode, rays in self.pool]
        self.any_hit = MODE_ANY_HIT
        self.kept = {}
        self.latest = {}    # mode -> (batch, answers) of its latest unit

    def unit(self, i: int, slot):
        p = i % len(self.queries)
        q = self.queries[p]
        with record_function("raybench.submit"):
            res = self.svc.submit(q)
        this = (p, res.hit_flags if q.mode == self.any_hit else res.hits)
        if slot is not None:
            self.kept[slot] = [this] + [u for m, u in self.latest.items()
                                        if m != q.mode]
        self.latest[q.mode] = this
        return self.ctx.traffic["rays"]

    def stats(self) -> dict:
        return {}

    def release(self) -> None:
        self.svc = self.queries = None
        self.latest = {}

    def judge(self, control: bool):
        ctx, tr = self.ctx, self.ctx.traffic
        tris = reference_world(ctx)
        counts = []
        for slot, units in sorted(self.kept.items()):
            m = tr["sample_rays"] // len(units)
            for j, (p, out) in enumerate(units):
                mode, pool = self.pool[p]
                idx = torch.as_tensor(sample_idx(tr["rays"], m, ctx.seed,
                                                 2 * slot + j),
                                      device=ctx.device)
                rays = [x[idx] for x in pool]
                if mode != self.any_hit:
                    counts.append(judge_cast(hits_dict(out, idx), *rays,
                                             tris, control))
                    continue
                flags = (occlusion.control_flags(*rays, tris) if control
                         else out[idx])
                counts.append(occlusion.bad_flags(flags, *rays, tris))
        total = {}
        for c in counts:
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        return {"bad_ray_share": rjudge.share(counts)}, total
