"""Path-traced frames in a closed loop: each unit is one
``WavefrontPathTracer.trace_frame(rays, max_bounces, sample_index,
with_counts=True)`` (range ``raybench.pt_frame``) over the flat scene on
kernel B1, on the configuration's camera at the traffic's frame size
(block-swizzled), with the traffic's light, sky and material.  The sample
index of frame i is a start drawn from the seed, plus i."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..reference import camera as rcam
from ..reference import pathtrace as rpt
from . import (block_perm, frame_rays, reference_world,
               timed_build, world_tris_np)


def build_scene(ctx):
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    return build_scene_from_tri_array(world_tris_np(ctx.inputs),
                                      device=ctx.device)


def shading(tr: dict, device):
    from messyerraytracer_tpu_torch.render.shade import (make_environment,
                                                         make_lights,
                                                         make_materials)

    sky, mat = tr["sky"], tr["material"]
    return (make_lights([tr["light"]], device=device),
            make_environment(sky_zenith=sky["zenith"],
                             sky_horizon=sky["horizon"],
                             sky_ground=sky["ground"], device=device),
            make_materials(albedo=[mat["albedo"]], metallic=mat["metallic"],
                           roughness=mat["roughness"],
                           specular=mat["specular"], device=device))


class Work:
    def __init__(self, ctx):
        from messyerraytracer_tpu_torch.render.wavefront import (
            WavefrontPathTracer)

        self.ctx, tr = ctx, ctx.traffic
        self.w, self.h = tr["width"], tr["height"]
        self.scene, self.build_s = timed_build(ctx, lambda: build_scene(ctx))
        self.pt = WavefrontPathTracer(self.scene, *shading(tr, ctx.device))
        cam = ctx.cfg["camera"]
        self.rays = frame_rays(cam, cam["eye"], self.w, self.h,
                               block_perm(self.w, self.h, tr["block"],
                                          ctx.device), ctx.device)
        rng = np.random.default_rng([ctx.seed % (1 << 63), 0x97])
        self.sample0 = int(rng.integers(0, 1 << 31))
        self.kept = {}

    def unit(self, i: int, slot):
        s = self.sample0 + i
        with record_function("raybench.pt_frame"):
            img, wave = self.pt.trace_frame(
                self.rays, max_bounces=self.ctx.traffic["max_bounces"],
                sample_index=s, with_counts=True)
        if slot is not None:
            self.kept[slot] = (s, img, wave)
        return wave

    def stats(self) -> dict:
        return {}

    def release(self) -> None:
        self.scene = self.pt = self.rays = None

    def judge(self, control: bool):
        ctx, tr = self.ctx, self.ctx.traffic
        cam = ctx.cfg["camera"]
        tris = reference_world(ctx)
        raster = rcam.block_permutation(self.w, self.h, tr["block"])
        o, d = (torch.as_tensor(a, device=ctx.device) for a in rcam.frame_rays(
            cam["eye"], cam["target"], cam["fov_degrees"], self.w, self.h,
            raster))
        ref_dtype = torch.float64
        bad = px = 0
        gaps, details = [], []
        for slot, (s, img, wave) in sorted(self.kept.items()):
            ref, ref_wave = rpt.trace_frame(
                o, d, tris, rpt.shading_inputs(tr["light"], tr["sky"],
                                               tr["material"], ctx.device,
                                               ref_dtype),
                s, tr["max_bounces"], ref_dtype)
            if control:
                img, wave = rpt.trace_frame(
                    o, d, tris, rpt.shading_inputs(
                        tr["light"], tr["sky"], tr["material"], ctx.device,
                        torch.bfloat16), s, tr["max_bounces"], torch.bfloat16)
            wave = int(wave)
            g = rpt.pixel_gaps(img, ref)
            bad += int((g > 0).sum())
            px += g.numel()
            gaps.append(abs(wave - ref_wave) / max(ref_wave, 1))
            details.append({"sample_index": s, "wave_rays": wave,
                            "ref_wave_rays": ref_wave,
                            "bad_pixels": int((g > 0).sum()),
                            "worst_gap": float(g.max())})
        return ({"bad_pixel_share": bad / max(px, 1),
                 "wave_rays_gap": max(gaps)}, {"frames": details})
