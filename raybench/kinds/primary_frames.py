"""Primary frames in a closed loop: each unit generates one block-swizzled
camera frame (``generate_rays`` + ``take``, range ``raybench.raygen``) and
casts it through the instanced TLAS on kernel B1
(``cast_rays_instanced``, range ``raybench.cast``).  The camera orbits the
configuration's eye about the y axis, ``orbit_degrees_per_frame`` a frame,
from a start yaw drawn from the seed."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from . import (block_perm, build_tlas, camera_check_rays,
               frame_rays, hits_dict, judge_cast, reference_world,
               sample_idx, summary, timed_build)


def orbit(eye, yaw_degrees: float):
    a = np.deg2rad(yaw_degrees)
    x, y, z = (float(c) for c in eye)
    return (x * np.cos(a) + z * np.sin(a), y, -x * np.sin(a) + z * np.cos(a))


class Work:
    def __init__(self, ctx):
        self.ctx, tr = ctx, ctx.traffic
        self.w, self.h = tr["width"], tr["height"]
        self.tlas, self.build_s = timed_build(ctx, lambda: build_tlas(ctx))
        self.perm = block_perm(self.w, self.h, tr["block"], ctx.device)
        rng = np.random.default_rng([ctx.seed % (1 << 63), 0x0B])
        self.yaw0 = float(rng.uniform(0.0, 360.0))
        self.kept = {}

    def eye(self, i: int):
        step = self.ctx.traffic["orbit_degrees_per_frame"]
        return orbit(self.ctx.cfg["camera"]["eye"], self.yaw0 + i * step)

    def unit(self, i: int, slot):
        eye = self.eye(i)
        with record_function("raybench.raygen"):
            rays = frame_rays(self.ctx.cfg["camera"], eye, self.w, self.h,
                              self.perm, self.ctx.device)
        with record_function("raybench.cast"):
            hits = self.tlas.cast_rays_instanced(rays)[0]
        if slot is not None:
            self.kept[slot] = (eye, hits)
        return rays.count

    def stats(self) -> dict:
        return {}

    def release(self) -> None:
        self.tlas = self.perm = None

    def judge(self, control: bool):
        ctx, tr = self.ctx, self.ctx.traffic
        tris = reference_world(ctx)
        counts = []
        for slot, (eye, hits) in sorted(self.kept.items()):
            idx = sample_idx(self.w * self.h, tr["sample_rays"], ctx.seed,
                             slot)
            rays = camera_check_rays(ctx.cfg["camera"], eye, self.w, self.h,
                                     tr["block"], idx, ctx.device)
            sel = torch.as_tensor(idx, device=ctx.device)
            counts.append(judge_cast(hits_dict(hits, sel), *rays, tris,
                                     control))
        return summary(counts)
