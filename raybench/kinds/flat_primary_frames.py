"""Primary frames on a flat scene in a closed loop: each unit generates
one block-swizzled camera frame (``generate_rays`` + ``take``, range
``raybench.raygen``) and casts it through the configuration's world
triangles as one flat ``RayScene`` on kernel B1 (``RayScene.cast_rays``,
range ``raybench.cast``), with no service and no dispatch.  The camera
orbits as in ``primary_frames``; the check is that kind's."""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

from . import block_perm, frame_rays, timed_build
from . import primary_frames
from .pathtraced_frames import build_scene


class Work(primary_frames.Work):
    def __init__(self, ctx):
        self.ctx, tr = ctx, ctx.traffic
        self.w, self.h = tr["width"], tr["height"]
        self.scene, self.build_s = timed_build(ctx, lambda: build_scene(ctx))
        self.perm = block_perm(self.w, self.h, tr["block"], ctx.device)
        rng = np.random.default_rng([ctx.seed % (1 << 63), 0x0B])
        self.yaw0 = float(rng.uniform(0.0, 360.0))
        self.kept = {}

    def unit(self, i: int, slot):
        eye = self.eye(i)
        with record_function("raybench.raygen"):
            rays = frame_rays(self.ctx.cfg["camera"], eye, self.w, self.h,
                              self.perm, self.ctx.device)
        with record_function("raybench.cast"):
            hits = self.scene.cast_rays(rays)[0]
        if slot is not None:
            self.kept[slot] = (eye, hits)
        return rays.count

    def release(self) -> None:
        self.scene = self.perm = None
