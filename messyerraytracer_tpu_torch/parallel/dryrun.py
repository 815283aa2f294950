"""Multi-device dry run: the sharded paths end to end on tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``.
JAX needs a fresh process to switch platforms; a PyTorch mesh is a list of
devices, so this runs in the calling process: ``dryrun_multichip(4)`` on
every visible CUDA device (or ``device="cuda:0"`` for four entries of one
card, ``device="cpu"`` for the plain versions).
"""

from __future__ import annotations

import numpy as np
import torch


def _demo_tris() -> np.ndarray:
    from ..utils import meshes

    return np.concatenate([
        meshes.cornell_room(4.0),
        meshes.uv_sphere(0.8, 12, 24, center=(0, -1.2, 0)),
        meshes.uv_sphere(0.5, 10, 20, center=(-1.0, 0.6, -0.8)),
    ])


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run on a mesh of ``n_devices`` entries (``device`` repeated, or
    the first ``n_devices`` CUDA devices when ``device`` is None): (1) the
    ray-sharded cast of a 128 x 8n frame, (2) one ray-sharded path-traced
    render step at 1 bounce, (3) the scene-sharded cast of a 64 x 16
    frame, checked against the data-parallel cast (same hit set, t within
    rtol 1e-5: the scene axis runs B4, the data axis B1).  Raises on a
    failed check; returns a summary."""
    from ..render.camera import CameraParams, generate_rays
    from ..render.shade import make_environment, make_lights
    from ..scene.scene import build_scene_from_tri_array
    from .sharding import (build_sharded_scene, cast_rays_scene_sharded,
                           cast_rays_sharded, make_mesh,
                           render_step_sharded)

    mesh = (make_mesh(n_devices) if device is None
            else make_mesh(devices=[torch.device(device)] * n_devices))
    home = mesh[0]
    tris = _demo_tris()
    scene = build_scene_from_tri_array(tris, device=home)
    cam = CameraParams.look_at((0, 0, 5.5), (0, 0, 0), fov_degrees=60.0)

    # 1) the sharded batch cast
    rays = generate_rays(cam, 128, 8 * n_devices, device=home)
    hits, stats, _ = cast_rays_sharded(rays, scene, mesh)
    if int(stats.rays_cast) != rays.count or not bool(hits.hit.any()):
        raise RuntimeError("dryrun: sharded cast counted "
                           f"{int(stats.rays_cast)} of {rays.count} rays")

    # 2) one sharded render step (raygen -> bounce -> shadows -> radiance)
    lights = make_lights([{"type": 0, "direction": (0.3, 1.0, 0.4),
                           "energy": 1.2}], device=home)
    img = render_step_sharded(scene, cam, 128, 8 * n_devices, mesh,
                              lights=lights,
                              env=make_environment(device=home),
                              max_bounces=1)
    if tuple(img.shape) != (128 * 8 * n_devices, 3) or not bool(
            torch.isfinite(img).all()):
        raise RuntimeError("dryrun: the sharded render step is not finite")

    # 3) the scene-parallel axis against the data-parallel cast
    stacked, meta, id_maps = build_sharded_scene(tris, n_devices, mesh)
    sub = generate_rays(cam, 64, 16, device=home)
    h_sp, _ = cast_rays_scene_sharded(sub, stacked, meta, id_maps, mesh)
    h_dp, _, _ = cast_rays_sharded(sub, scene, mesh)
    if not torch.equal(h_sp.hit, h_dp.hit) or not torch.allclose(
            h_sp.t, h_dp.t, rtol=1e-5, atol=0.0):
        raise RuntimeError("dryrun: scene-sharded != data-parallel cast")
    return {"devices": [str(d) for d in mesh], "rays": rays.count,
            "hit_rate": float(hits.hit.float().mean()),
            "image_mean": float(img.mean()),
            "scene_sharded_rays": sub.count}
