"""Kinds of traffic: a traffic mix's ``kind`` names a module here whose
``Work(ctx)`` builds the cell on the program, runs one unit of work at a
time (``unit(i, slot)``: the i-th unit of the closed loop; ``slot`` not
None keeps its answers for the check), and judges the kept answers
against the plain reference once the window has closed
(``judge(control)``)."""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import camera as rcam
from ..reference import judge as rjudge
from ..reference import scene as rscene

FLT_MAX = 3.402823466e38


def timed_build(ctx, fn):
    """fn() with the scene build's seconds on the host clock, waited for."""
    t0 = time.perf_counter()
    out = fn()
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return out, time.perf_counter() - t0


def build_tlas(ctx):
    """The program's instanced TLAS over the recipe's meshes and
    instances, with its kernel B1 tables."""
    from messyerraytracer_tpu_torch.accel.tlas import SceneTLAS

    tlas = SceneTLAS(backend="cluster", device=ctx.device)
    for m in ctx.inputs["meshes"]:
        tlas.add_mesh(m)
    for mesh_id, xf in ctx.inputs["instances"]:
        tlas.add_instance(mesh_id, xf)
    tlas.build_instanced()
    return tlas


def world_tris_np(inputs) -> np.ndarray:
    """(F, 3, 3) float32 world triangles of a scene's instances, for the
    program's flat scenes."""
    return np.concatenate([
        np.einsum("ij,fvj->fvi", xf[:3, :3], inputs["meshes"][m])
        + xf[:3, 3] for m, xf in inputs["instances"]]).astype(np.float32)


def frame_rays(cam: dict, eye, width: int, height: int, perm, device):
    """The program's camera rays of a block-swizzled frame."""
    from messyerraytracer_tpu_torch.render.camera import (CameraParams,
                                                          generate_rays)

    c = CameraParams.look_at(eye, cam["target"],
                             fov_degrees=cam["fov_degrees"])
    return generate_rays(c, width, height, device=device).take(perm)


def block_perm(width: int, height: int, block: int, device):
    from messyerraytracer_tpu_torch.dispatch.morton import (
        raster_block_permutation)

    return torch.as_tensor(raster_block_permutation(width, height, block),
                           device=device).long()


def sample_idx(n: int, m: int, seed: int, slot: int) -> np.ndarray:
    """``m`` distinct ray indices of ``n``, drawn from the seed."""
    rng = np.random.default_rng([seed % (1 << 63), 0xC4, slot])
    return np.sort(rng.choice(n, size=min(m, n), replace=False))


def hits_dict(hits, idx: torch.Tensor) -> dict:
    return {f: getattr(hits, f)[idx] for f in rjudge.HIT_FIELDS}


def judge_cast(hits, origin, direction, t_min, t_max, tris,
               control: bool) -> dict:
    """Judge one unit's sampled rays: the program's answers, or the
    control's."""
    if control:
        hits = rjudge.control_hits(origin, direction, t_min, t_max, tris)
    return rjudge.bad_rays(hits, origin, direction, t_min, t_max, tris)


def camera_check_rays(cfg_cam, eye, width, height, block, idx, device):
    """The reference's rays of positions ``idx`` of a block-swizzled
    frame, re-derived from the camera's parameters."""
    raster = rcam.block_permutation(width, height, block)[idx]
    o, d = rcam.frame_rays(eye, cfg_cam["target"], cfg_cam["fov_degrees"],
                           width, height, raster)
    n = o.shape[0]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (t(o), t(d), t(np.full(n, 1e-3, np.float32)),
            t(np.full(n, FLT_MAX, np.float32)))


def reference_world(ctx, transforms=None):
    return rscene.world_triangles(ctx.inputs["meshes"],
                                  ctx.inputs["instances"], transforms,
                                  device=ctx.device)


def summary(counts: list[dict]) -> tuple[dict, dict]:
    total = {k: sum(c[k] for c in counts) for k in counts[0]} if counts \
        else {}
    return {"bad_ray_share": rjudge.share(counts)}, total
