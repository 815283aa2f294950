"""Query batches in a closed loop through the service: each unit is one
``RayTracerService.submit(RayQuery(rays, coherent=...))`` (range
``raybench.submit``), which sorts the batch by its Morton key, casts it on
kernel B1 and returns the hits in the submitted order.  The batches come
from a pool made on the device in set-up from the seed (origins uniform
in +-``origin_extent`` with y = |y| + ``origin_y_lift``, directions
normalized Gaussian), cycled through in order."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from . import (hits_dict, judge_cast, reference_world,
               sample_idx, summary, timed_build)


def ray_pool(tr: dict, seed: int, device):
    """(P, N, 3) origins and directions, (P, N) t_min and t_max."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    shape = (tr["pool_batches"], tr["rays"], 3)
    ext = float(tr["origin_extent"])
    o = (torch.rand(shape, generator=g, device=device) * 2.0 - 1.0) * ext
    o[..., 1] = o[..., 1].abs() + float(tr["origin_y_lift"])
    d = torch.randn(shape, generator=g, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    tmin = torch.full(shape[:2], float(tr["t_min"]), device=device)
    tmax = torch.full(shape[:2], float(tr["t_max"]), device=device)
    return o.contiguous(), d.contiguous(), tmin, tmax


def build_service(ctx):
    from messyerraytracer_tpu_torch.api.service import RayTracerService

    svc = RayTracerService(device=ctx.device)
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
        from messyerraytracer_tpu_torch.api.service import RayQuery
        from messyerraytracer_tpu_torch.core.types import Rays

        self.ctx, tr = ctx, ctx.traffic
        self.svc, self.build_s = timed_build(ctx, lambda: build_service(ctx))
        self.pool = ray_pool(tr, ctx.seed, ctx.device)
        self.queries = [RayQuery(rays=Rays(*(x[p] for x in self.pool)),
                                 coherent=bool(tr["coherent"]))
                        for p in range(tr["pool_batches"])]
        self.kept = {}

    def unit(self, i: int, slot):
        p = i % len(self.queries)
        with record_function("raybench.submit"):
            hits = self.svc.submit(self.queries[p]).hits
        if slot is not None:
            self.kept[slot] = (p, hits)
        return self.ctx.traffic["rays"]

    def stats(self) -> dict:
        return {}

    def release(self) -> None:
        self.svc = self.queries = None

    def judge(self, control: bool):
        ctx, tr = self.ctx, self.ctx.traffic
        tris = reference_world(ctx)
        counts = []
        for slot, (p, hits) in sorted(self.kept.items()):
            idx = torch.as_tensor(sample_idx(tr["rays"], tr["sample_rays"],
                                             ctx.seed, slot),
                                  device=ctx.device)
            rays = [x[p][idx] for x in self.pool]
            counts.append(judge_cast(hits_dict(hits, idx), *rays, tris,
                                     control))
        return summary(counts)
