"""Multi-device casts: the ray batch, or the scene, split over a mesh.

PyTorch counterpart of ``messyerraytracer_tpu/parallel/sharding.py``.  The
JAX package runs one program per chip under ``jax.shard_map`` over a 1-D
mesh and combines the shards with collectives.  The port keeps its single
controller: a mesh is an ordered list of ``torch.device`` entries, each
shard is cast on its own entry, and each collective becomes an explicit
reduction over the shards' outputs on the device of the caller's rays (the
first mesh entry for a render step):

  * ``psum`` of the stats -> a sum;
  * the two ``pmin`` of the scene-parallel merge -> a lexicographic
    (t, global prim) minimum over the shards;
  * the masked ``psum`` pick of the winner's fields -> a select.

The kernels' wrappers launch under the device guard of their rays' card,
and a render step traces each shard under its card's, so the host queues
every card's work without waiting for another's (``chip_smoke.py`` phase
7e holds a mesh of distinct cards against one card, where several are
visible).

A mesh may repeat an entry: ``make_mesh(4, devices=["cuda:0"] * 4)`` runs
the padding, the per-shard casts and the merge on one card, and a mesh of
``"cpu"`` entries runs them on the plain versions.  Tables and shading
state are copied to each distinct device of the mesh (replicated, as
``shard_map`` replicates closed-over arrays).

The shards are JAX's: a batch is split as if padded to a multiple of
``n_dev * TILE`` (``_shard_bounds``), but the padding itself is not cast.
``render_step_sharded`` therefore seeds each pixel's PCG32 stream from its
SHARD-LOCAL index, as JAX does under ``shard_map`` (every shard repeats
shard 0's streams; ROADMAP queue C).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..core.types import (
    NO_HIT,
    T_MAX_DEFAULT,
    Hits,
    Rays,
    RayStats,
)
from ..kernels.cluster import ClusterScene
from ..kernels.cluster_v2 import cast_rays_cluster_v2
from ..kernels.traverse_pallas import cast_rays_wide
from ..kernels.wide import WideScene

RAY_AXIS = "rays"   # JAX's name of the mesh axis the rays are split over
TILE = 2048     # the JAX kernel's ray tile (traverse_pallas.py:1355)
_HIT_FIELDS = ("t", "position", "normal", "u", "v", "prim_id", "hit_layers")
_STAT_FIELDS = ("rays_cast", "tri_tests", "bvh_nodes_visited", "hits",
                "stack_drops")


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """A 1-D mesh: the ordered list of devices the shards run on.

    ``devices`` None means every visible CUDA device (raises if there is
    none, or fewer than ``n_devices``); an explicit ``devices`` list may
    repeat an entry or name ``"cpu"``, and ``n_devices`` then takes its
    first entries."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices= for a mesh of other devices")
        devices = [torch.device("cuda", k) for k in range(count)]
    mesh = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(mesh):
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(mesh)} available")
        mesh = mesh[:n_devices]
    return mesh


def _shard_bounds(n: int, n_dev: int) -> list:
    """[start, end) of each shard's rays.  JAX pads the batch with dead
    rays to a multiple of ``n_dev * TILE`` and gives shard k the k-th
    equal part; the port keeps those parts but casts only their real
    rays (a dead ray counts nothing in B1 but a root pop in B4, so cast
    padding would change the summed stats), and a shard whose part is all
    padding casts nothing, except shard 0 of an empty batch."""
    per = -(-n // (n_dev * TILE)) * TILE
    bounds = [(min(k * per, n), min((k + 1) * per, n)) for k in range(n_dev)]
    return [(k, s, e) for k, (s, e) in enumerate(bounds) if e > s or k == 0]


def _to_device(x, device):
    """A copy of ``x`` (dataclasses of tensors, tuples) with every tensor
    on ``device``; tensors already there are shared, not copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_to_device(v, device) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _to_device(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


def _replicas(x, mesh: list) -> list:
    """``x`` on every entry of ``mesh`` (one copy per distinct device)."""
    copies = {}
    for d in mesh:
        if d not in copies:
            copies[d] = _to_device(x, d)
    return [copies[d] for d in mesh]


def _cast_tables(scene_like):
    """The tables the sharded paths cast: a RayScene's cluster tables
    (else its wide tables), a ``ClusterScene`` or a ``WideScene``."""
    cs = getattr(scene_like, "cluster", None)
    if cs is None and isinstance(scene_like, ClusterScene):
        cs = scene_like
    if cs is not None:
        return cs
    wide = getattr(scene_like, "wide", None)
    if wide is None and isinstance(scene_like, WideScene):
        wide = scene_like
    if wide is None:
        raise ValueError("sharded cast needs a scene with cluster or wide "
                         f"tables (got {type(scene_like).__name__})")
    return wide


def _shard_cast(tables, local: Rays, query_mask: int, any_hit: bool):
    """One shard's cast through the kernel of its tables: B1 on cluster
    tables, B4 on wide tables.  Returns (hits, stats, occluded)."""
    if isinstance(tables, ClusterScene):
        return cast_rays_cluster_v2(local, tables, query_mask=query_mask,
                                    any_hit=any_hit)
    return cast_rays_wide(local, tables, query_mask=query_mask,
                          any_hit=any_hit)


def _on(device):
    """``device`` made the current CUDA device (nothing for the CPU), so
    that work which allocates or launches without naming a device lands
    on the shard's card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _gather(parts, home):
    """Per-shard (N_k, ...) tensors concatenated on ``home``."""
    return torch.cat([p.to(home) for p in parts])


def _sum(parts, home):
    return sum(torch.as_tensor(p).to(home) for p in parts)


def cast_rays_sharded(rays: Rays, scene, mesh: list,
                      query_mask: int = -1, any_hit: bool = False,
                      interpret=None) -> tuple[Hits, RayStats, torch.Tensor]:
    """Batch cast with the ray axis split over ``mesh``.

    ``scene`` may be a RayScene (cast through its cluster or wide
    tables), a ``ClusterScene`` or a ``WideScene``; its tables are
    replicated to the mesh's devices, each shard is cast by the
    single-device kernel, the hits come back to the rays' device in order
    and the stats are summed.  ``interpret`` is the JAX package's knob,
    accepted and ignored.  Returns (hits, stats, occluded)."""
    del interpret
    home = rays.origin.device
    tables = _replicas(_cast_tables(scene), mesh)
    outs = [_shard_cast(tables[k], rays.take(slice(s, e)).to(mesh[k]),
                        int(query_mask), any_hit)
            for k, s, e in _shard_bounds(rays.count, len(mesh))]
    hits = Hits(*(_gather([getattr(h, f) for h, _, _ in outs], home)
                  for f in _HIT_FIELDS))
    stats = RayStats(*(_sum([getattr(s, f) for _, s, _ in outs], home)
                       for f in _STAT_FIELDS))
    return hits, stats, _gather([o for _, _, o in outs], home)


def build_sharded_scene(tri_array: np.ndarray, n_shards: int,
                        mesh: list | None = None):
    """Partition a triangle soup into ``n_shards`` Morton-ordered spatial
    chunks and build one ``pallas`` (8-wide) scene per chunk, shard k on
    ``mesh[k]`` (default ``make_mesh(n_shards)``).

    The scene-parallel axis: each device holds 1/n of the triangles and
    casts every ray against them; ``cast_rays_scene_sharded`` merges the
    closest hits.  Returns (stacked, meta, id_maps): ``stacked`` is the
    list of the shards' ``WideScene`` tables (the JAX package stacks them
    NaN/zero-padded on a leading axis, because ``shard_map`` traces one
    program for all chips), ``meta`` their shared static fields and
    ``id_maps`` the list of per-shard (T_k,) int32 tensors mapping a
    shard-local prim id to the original triangle id."""
    from ..dispatch.morton import morton_encode_3d
    from ..scene.scene import build_scene_from_tri_array

    tri_array = np.asarray(tri_array, np.float32)
    t = tri_array.shape[0]
    if t < n_shards:
        raise ValueError(
            f"build_sharded_scene: {t} triangles cannot fill {n_shards} "
            "shards (every shard needs >= 1 triangle) — use the "
            "replicated-scene data-parallel path for tiny scenes")
    mesh = make_mesh(n_shards) if mesh is None else mesh
    if len(mesh) != n_shards:
        raise ValueError(f"build_sharded_scene: {n_shards} shards on a "
                         f"mesh of {len(mesh)}")
    cent = tri_array.mean(axis=1)
    lo = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo, 1e-12)
    q = torch.as_tensor(np.clip(((cent - lo) / ext * 1023.0), 0,
                                1023).astype(np.uint32).astype(np.int64))
    key = morton_encode_3d(q[:, 0], q[:, 1], q[:, 2]).numpy()
    order = np.argsort(key, kind="stable")
    bounds = np.linspace(0, t, n_shards + 1).astype(np.int64)

    wides, id_maps = [], []
    for s, dev in enumerate(mesh):
        idx = order[bounds[s]:bounds[s + 1]]
        sc = build_scene_from_tri_array(
            tri_array[idx], prim_id=np.arange(len(idx), dtype=np.int32),
            backend="pallas", device=dev)
        wides.append(sc.wide)
        id_maps.append(torch.as_tensor(idx.astype(np.int32), device=dev))
    meta = {"branching": wides[0].branching,
            "stream_leaves": wides[0].stream_leaves,
            "stream_nodes": wides[0].stream_nodes}
    return wides, meta, id_maps


def cast_rays_scene_sharded(rays: Rays, stacked, meta, id_maps, mesh: list,
                            interpret=None):
    """Closest-hit cast with the SCENE split over ``mesh``.

    Every shard casts all rays against its sub-scene with kernel B4; the
    winner per ray is the lexicographic (t, global prim) minimum over the
    shards, and its position, normal, u, v and layers are selected from
    the winning shard.  ``meta`` is ``build_sharded_scene``'s (the shards'
    shared static fields; the tables carry them too) and ``interpret``
    the JAX package's knob, accepted and ignored.  Returns (hits, stats)
    on the rays' device."""
    del meta, interpret
    if not len(stacked) == len(id_maps) == len(mesh):
        raise ValueError(f"cast_rays_scene_sharded: {len(stacked)} shards, "
                         f"{len(id_maps)} id maps, a mesh of {len(mesh)}")
    home = rays.origin.device
    n = rays.count
    big = torch.tensor(3.0e38, dtype=torch.float32, device=home)
    imax = torch.tensor(2**31 - 1, dtype=torch.int32, device=home)
    shards = []
    for wide, id_map, dev in zip(stacked, id_maps, mesh):
        hits, stats, _ = cast_rays_wide(rays.to(dev), wide)
        hits = Hits(*(getattr(hits, f).to(home) for f in _HIT_FIELDS))
        found = hits.prim_id >= 0
        gprim = torch.where(found, id_map.to(home)[hits.prim_id.clamp_min(
            0).long()], torch.full_like(hits.prim_id, NO_HIT))
        shards.append((hits, stats, found, gprim,
                       torch.where(found, hits.t, big)))
    t_best = torch.stack([s[4] for s in shards]).amin(dim=0)
    cands = [found & (t_loc == t_best) for _, _, found, _, t_loc in shards]
    p_best = torch.stack([torch.where(c, s[3], imax)
                          for c, s in zip(cands, shards)]).amin(dim=0)
    found = t_best < big
    out = {f: torch.zeros_like(getattr(shards[0][0], f))
           for f in ("position", "normal", "u", "v", "hit_layers")}
    for c, (hits, _, _, gprim, _) in zip(cands, shards):
        win = c & (gprim == p_best)
        for f, x in out.items():
            y = getattr(hits, f)
            out[f] = torch.where(win[:, None] if y.dim() == 2 else win, y, x)
    hits = Hits(t=torch.where(found, t_best,
                              torch.full_like(t_best, T_MAX_DEFAULT)),
                prim_id=torch.where(found, p_best,
                                    torch.full_like(p_best, NO_HIT)),
                **out)
    stats = RayStats(
        rays_cast=torch.tensor(n, dtype=torch.int64, device=home),
        tri_tests=_sum([s[1].tri_tests for s in shards], home),
        bvh_nodes_visited=_sum([s[1].bvh_nodes_visited for s in shards],
                               home),
        hits=found.sum(),
        stack_drops=_sum([s[1].stack_drops for s in shards], home))
    return hits, stats


class _ShardScene:
    """One shard's cast view of the replicated tables, for the path
    tracer (kernel B1 on cluster tables, B4 on wide tables)."""

    def __init__(self, tables):
        self.tables = tables

    def cast_rays(self, r: Rays, query_mask=-1):
        hits, stats, _ = _shard_cast(self.tables, r, int(query_mask), False)
        return hits, stats

    def any_hit_rays(self, r: Rays, query_mask=-1):
        _, _, occ = _shard_cast(self.tables, r, int(query_mask), True)
        return occ


def render_step_sharded(scene, cam, width, height, mesh: list,
                        lights=None, env=None, materials=None,
                        max_bounces=2, sample_index=0, interpret=None):
    """One path-traced frame with the pixels split over ``mesh``: camera
    rays on the first mesh entry, split as ``cast_rays_sharded`` splits,
    each shard traced by ``PathTracer`` on its own device
    against replicated scene and shading tables; returns the (W*H, 3)
    linear radiance on the first mesh entry.  Each shard seeds PCG32 from
    its shard-local pixel index, as the JAX package does."""
    from ..render.camera import generate_rays
    from ..render.pathtrace import PathTraceParams, PathTracer
    from ..render.shade import default_materials, make_environment

    del interpret
    home = mesh[0]
    env = env if env is not None else make_environment(device=home)
    materials = (materials if materials is not None
                 else default_materials(device=home))
    rays = generate_rays(cam, width, height, device=home)
    params = PathTraceParams(width, height, max_bounces=max_bounces,
                             sample_index=sample_index)
    shading = _replicas((_cast_tables(scene), lights, env, materials), mesh)
    imgs = []
    for k, s, e in _shard_bounds(rays.count, len(mesh)):
        tables, lt, en, mat = shading[k]
        with _on(mesh[k]):
            pt = PathTracer(_ShardScene(tables), lt, en, mat)
            imgs.append(pt.trace_frame(params, rays.take(slice(s, e)).to(
                mesh[k])))
    return _gather(imgs, home)
