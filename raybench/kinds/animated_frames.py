"""Animated frames in a closed loop: each unit moves ``moves_per_frame``
of the configuration's moving instances through
``SceneTLAS.set_transform`` (range ``raybench.move``), then casts one
block-swizzled frame from the configuration's fixed camera through the
instanced TLAS on kernel B1 (range ``raybench.cast``).  Which instances
move in frame i, and each one's bounce phase, come from the seed; an
instance that moves is lifted by ``bounce_height`` * |sin(phase + i *
bounce_radians_per_frame)| over its resting place.  The host's time in
each move is kept for the window's frames before the profiler starts.

The check judges two samples of each kept frame, drawn from the seed: rays
of the whole frame (``bad_ray_share``), and rays that touch an instance
moved in that frame, the refit layer's own answers (``bad_moved_share``):
rays whose float64 span meets the instance's world bounds before or after
the move, as the reference re-derives them, and rays whose answer from the
program names the instance."""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from ..reference import cast as rcast
from ..reference import judge as rjudge
from ..reference import scene as rscene
from . import (block_perm, build_tlas, camera_check_rays,
               frame_rays, hits_dict, judge_cast, reference_world,
               sample_idx, summary, timed_build)


class Work:
    def __init__(self, ctx):
        self.ctx, tr = ctx, ctx.traffic
        self.w, self.h = tr["width"], tr["height"]
        self.tlas, self.build_s = timed_build(ctx, lambda: build_tlas(ctx))
        cam = ctx.cfg["camera"]
        self.rays = frame_rays(cam, cam["eye"], self.w, self.h,
                               block_perm(self.w, self.h, tr["block"],
                                          ctx.device), ctx.device)
        self.rest = np.stack([xf for _, xf in ctx.inputs["instances"]]
                             ).astype(np.float32)
        self.now = self.rest.copy()
        lo, hi = ctx.cfg["moving_instances"]
        self.movers = np.arange(lo, hi)
        rng = np.random.default_rng([ctx.seed % (1 << 63), 0xA7])
        self.phase = rng.uniform(0.0, 2.0 * np.pi, len(self.rest))
        self.move_ms = []
        self.kept = {}

    def moves(self, i: int) -> np.ndarray:
        rng = np.random.default_rng([self.ctx.seed % (1 << 63), 0xA8, i])
        return rng.choice(self.movers, self.ctx.traffic["moves_per_frame"],
                          replace=False)

    def unit(self, i: int, slot):
        tr = self.ctx.traffic
        before = self.now.copy() if slot is not None else None
        t0 = time.perf_counter()
        with record_function("raybench.move"):
            for k in self.moves(i):
                xf = self.rest[k].copy()
                xf[1, 3] += tr["bounce_height"] * abs(np.sin(
                    self.phase[k] + i * tr["bounce_radians_per_frame"]))
                self.now[k] = xf
                self.tlas.set_transform(int(k), xf)
        if self.ctx.phase == "window":
            self.move_ms.append((time.perf_counter() - t0) * 1e3)
        with record_function("raybench.cast"):
            hits = self.tlas.cast_rays_instanced(self.rays)[0]
        if slot is not None:
            self.kept[slot] = (i, before, self.now.copy(), hits)
        return self.rays.count

    def stats(self) -> dict:
        return {"move_ms": self.move_ms}

    def release(self) -> None:
        self.tlas = self.rays = None

    def judge(self, control: bool):
        ctx, tr = self.ctx, self.ctx.traffic
        cam = ctx.cfg["camera"]
        n = self.w * self.h
        frame = camera_check_rays(cam, cam["eye"], self.w, self.h,
                                  tr["block"], np.arange(n), ctx.device)
        sizes = [ctx.inputs["meshes"][m].shape[0]
                 for m, _ in ctx.inputs["instances"]]
        first = np.concatenate([[0], np.cumsum(sizes)])
        counts = {"bad_ray_share": [], "bad_moved_share": []}
        for slot, (i, before, after, hits) in sorted(self.kept.items()):
            tris = reference_world(ctx, after)
            movers = self.moves(i)
            moved = self.moved_rays(frame, hits, first, movers,
                                    [before, after])
            pick = sample_idx(len(moved), tr["sample_rays"], ctx.seed,
                              slot + len(self.kept))
            whole = sample_idx(n, tr["sample_rays"], ctx.seed, slot)
            for name, idx in (("bad_ray_share", whole),
                              ("bad_moved_share", moved[pick])):
                sel = torch.as_tensor(idx, device=ctx.device)
                counts[name].append(judge_cast(
                    hits_dict(hits, sel), *(x[sel] for x in frame), tris,
                    control))
        return ({n: rjudge.share(c) for n, c in counts.items()},
                {n: summary(c)[1] for n, c in counts.items()})

    def moved_rays(self, frame, hits, first, movers, poses) -> np.ndarray:
        """Indices of the rays that touch one of ``movers``: the float64
        span of the reference's ray meets its world bounds under one of
        ``poses`` (transforms before and after the move), or the
        program's answer names it."""
        inputs = self.ctx.inputs
        on = torch.zeros(frame[0].shape[0], dtype=torch.bool,
                         device=frame[0].device)
        for xfs in poses:
            on |= rcast.crosses_boxes(*frame, rscene.instance_boxes(
                inputs["meshes"], inputs["instances"], xfs, movers))
        prim = hits.prim_id.long().to(on.device)
        for k in movers:
            on |= (prim >= int(first[k])) & (prim < int(first[k + 1]))
        return on.nonzero()[:, 0].cpu().numpy()
