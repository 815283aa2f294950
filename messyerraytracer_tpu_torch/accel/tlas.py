"""Two-level acceleration: MeshBLAS + instances + SceneTLAS.

PyTorch counterpart of ``messyerraytracer_tpu/accel/tlas.py``.  Two
representations of one instanced scene, as in the reference:

  * the instanced cluster TLAS (``build_instanced`` /
    ``cast_rays_instanced``): memory ~ meshes, prim ids in the flattened
    numbering, instance ids reported — the main path;
  * the flattened world-space twin (``flat``, built lazily on first use),
    a plain ``RayScene`` over every instance's world triangles.

``instanced_scene`` gives renderers and path tracers a scene-like view of
the instanced tables.  Transform updates keep the JAX package's two steps:
``set_transform`` refits the instanced tables at once, and ``refit_tlas``
brings an already-built flat twin up to the current transforms (until
then it casts the old ones, as in JAX; a twin first built after the
update reads the new ones).  Both run on the tables' device.

Two more casts keep two-level semantics: ``cast_rays_two_level_fast``
over the frontier TLAS and BLAS forest (``accel/tlas_frontier.py``, built
lazily by ``build_two_level`` and dropped by every change of the meshes,
instances or transforms), and ``cast_rays_two_level``, a loop over the
instances through each mesh's own ``RayScene``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.bvh import _bvh_host
from ..accel.frontier import _norm
from ..core.types import ALL_LAYERS, DEFAULT_DEVICE, NO_HIT, Hits, Rays
from ..scene.scene import RayScene, _refit_slots, build_scene
from ..utils.trace import span


def _to_mat4(transform) -> np.ndarray:
    """Accept (4,4), (3,4), or (3,3) and return a (3,4) [R|t] float32."""
    m = np.asarray(transform, np.float32)
    if m.shape == (4, 4):
        return m[:3, :]
    if m.shape == (3, 4):
        return m
    if m.shape == (3, 3):
        return np.concatenate([m, np.zeros((3, 1), np.float32)], axis=1)
    raise ValueError(f"bad transform shape {m.shape}")


@dataclasses.dataclass
class MeshBLAS:
    """Per-mesh object-space BLAS: a RayScene over the mesh's triangles."""

    scene: RayScene
    tri_array: np.ndarray  # (T, 3, 3) object-space vertices (host copy)
    layers_orig: np.ndarray  # (T,) host layers, original order

    @property
    def num_tris(self) -> int:
        return self.scene.num_tris

    def object_bounds(self):
        """Object-space AABB from the BLAS root."""
        bvh = self.scene.bvh
        return _bvh_host(bvh, "aabb_min")[0], _bvh_host(bvh, "aabb_max")[0]


@dataclasses.dataclass
class BLASInstance:
    """Instance = blas_id + transform + cached inverse."""

    blas_id: int
    transform: np.ndarray      # (3,4) [R|t]
    inv_transform: np.ndarray  # (3,4) world->object
    layers: int = ALL_LAYERS

    @staticmethod
    def create(blas_id: int, transform, layers: int = ALL_LAYERS):
        m = _to_mat4(transform)
        r_inv = np.linalg.inv(m[:, :3])
        t_inv = -r_inv @ m[:, 3]
        inv = np.concatenate([r_inv, t_inv[:, None]],
                             axis=1).astype(np.float32)
        return BLASInstance(blas_id, m, inv, layers)

    def world_aabb(self, obj_min, obj_max):
        """World AABB by transforming all 8 box corners."""
        corners = np.array(
            [[x, y, z]
             for x in (obj_min[0], obj_max[0])
             for y in (obj_min[1], obj_max[1])
             for z in (obj_min[2], obj_max[2])],
            np.float32,
        )
        wc = corners @ self.transform[:, :3].T + self.transform[:, 3]
        return wc.min(axis=0), wc.max(axis=0)


@dataclasses.dataclass
class InstancedScene:
    """Scene-like cast view over the instanced ``ClusterTLAS``: the
    ``RayScene`` cast interface (``cast_rays`` -> (hits, stats),
    ``any_hit_rays`` -> flags) on kernel B1's instanced variant, so
    renderers and path tracers consume the two-level tables directly —
    memory ~ meshes, prim ids in the flattened numbering.  ``bounds`` is
    the world AABB (lo, hi) of the pair tree's root, for the bounce-wave
    coherence sort.  ``incoherent`` is accepted and ignored: the port has
    one kernel configuration."""

    cluster_tlas: object
    bounds: tuple

    def cast_rays(self, rays: Rays, query_mask=ALL_LAYERS,
                  incoherent: bool = False):
        from ..kernels.cluster_v2 import cast_rays_cluster_tlas_v2

        del incoherent
        hits, stats, _, _ = cast_rays_cluster_tlas_v2(
            rays, self.cluster_tlas, int(query_mask))
        return hits, stats

    def any_hit_rays(self, rays: Rays, query_mask=ALL_LAYERS,
                     incoherent: bool = False) -> torch.Tensor:
        from ..kernels.cluster_v2 import cast_rays_cluster_tlas_v2

        del incoherent
        _, _, occluded, _ = cast_rays_cluster_tlas_v2(
            rays, self.cluster_tlas, int(query_mask), any_hit=True)
        return occluded


def _apply_rt(m: torch.Tensor, p: torch.Tensor,
              translate: bool = True) -> torch.Tensor:
    """A (3, 4) [R|t] applied to (N, 3) points (or, with ``translate``
    False, vectors) as explicit float32 multiply-adds, row by row:
    ((m0 x + m1 y) + m2 z) + t."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    out = torch.stack([m[a, 0] * x + m[a, 1] * y + m[a, 2] * z
                       for a in range(3)], dim=-1)
    return out + m[:, 3] if translate else out


def _world_slots(obj_slots, slot_inst, transforms):
    """World vertices (v0, v1, v2), each (F, 3), of slot-ordered
    object-space triangles (F, 3, 3) under their instances' (I, 3, 4)
    transforms: ((r0 x + r1 y) + r2 z) + t per row, one float32
    operation at a time (the JAX package's refit expression)."""
    r = transforms[slot_inst.long()]                       # (F, 3, 4)
    world = (r[:, None, :, 0] * obj_slots[:, :, None, 0]
             + r[:, None, :, 1] * obj_slots[:, :, None, 1]
             + r[:, None, :, 2] * obj_slots[:, :, None, 2]
             + r[:, None, :, 3])                           # (F, 3v, 3)
    return tuple(world[:, k].contiguous() for k in range(3))


class SceneTLAS:
    """Top-level structure over BLAS instances: ``add_mesh`` ->
    ``add_instance`` -> ``build_tlas`` / ``build_instanced``."""

    def __init__(self, backend: str = "cluster", device=DEFAULT_DEVICE):
        self.backend = backend
        self.device = torch.device(device)
        self.meshes: list[MeshBLAS] = []
        self.instances: list[BLASInstance] = []
        self._flat: RayScene | None = None
        self._tri_inst: np.ndarray | None = None   # (F,) instance per tri
        self._obj_tris: np.ndarray | None = None   # (F, 3, 3) object space
        self._flat_layers: np.ndarray | None = None
        self._ctlas = None                         # ClusterTLAS cache
        self._two_level = None                     # FrontierTLAS cache
        # the flat twin's refit inputs on the device (set with the twin)
        self._slot_inst: torch.Tensor | None = None    # (F,) slot order
        self._obj_slots: torch.Tensor | None = None    # (F, 3, 3)

    # ---- build -------------------------------------------------------
    def add_mesh(self, tri_array, layers=None) -> int:
        """Register an object-space mesh; builds its BLAS.  Returns its
        blas_id."""
        tri_array = np.asarray(tri_array, np.float32)
        scene = build_scene(tri_array[:, 0], tri_array[:, 1],
                            tri_array[:, 2], layers=layers,
                            backend=self.backend, device=self.device)
        lay_np = (np.full(tri_array.shape[0], ALL_LAYERS, np.int32)
                  if layers is None else np.asarray(layers, np.int32))
        self.meshes.append(MeshBLAS(scene, tri_array, lay_np))
        self._ctlas = self._two_level = None
        return len(self.meshes) - 1

    def add_instance(self, blas_id: int, transform,
                     layers: int = ALL_LAYERS) -> int:
        """Add an instance of a registered BLAS."""
        if not 0 <= blas_id < len(self.meshes):
            raise ValueError(f"no mesh with blas_id {blas_id}")
        self.instances.append(BLASInstance.create(blas_id, transform,
                                                  layers))
        self._ctlas = self._two_level = None
        return len(self.instances) - 1

    def build_tlas(self) -> None:
        """Gather the flattening metadata of all instances; the flattened
        world-space twin itself is built lazily on first use (``flat``)."""
        if not self.instances:
            raise ValueError("build_tlas: no instances")
        self._two_level = None
        obj, inst_id, layers = [], [], []
        for i, inst in enumerate(self.instances):
            mesh = self.meshes[inst.blas_id]
            obj.append(mesh.tri_array)
            inst_id.append(np.full(mesh.tri_array.shape[0], i, np.int32))
            layers.append(mesh.layers_orig & inst.layers)
        self._obj_tris = np.concatenate(obj)
        self._tri_inst = np.concatenate(inst_id)
        self._flat_layers = np.concatenate(layers)
        self._flat = None
        self._slot_inst = self._obj_slots = None

    @property
    def flat(self) -> RayScene | None:
        """The flattened world-space twin, built on first access."""
        if self._flat is None and self._obj_tris is not None:
            self._ensure_flat()
        return self._flat

    def _ensure_flat(self) -> None:
        if self._flat is not None:
            return
        if self._obj_tris is None:
            raise RuntimeError("call build_tlas first")
        world = self._world_tris_np()
        self._flat = build_scene(
            world[:, 0], world[:, 1], world[:, 2],
            layers=self._flat_layers, backend=self.backend,
            device=self.device,
        )
        perm = _bvh_host(self._flat.bvh, "tri_order")
        self._slot_inst = torch.as_tensor(self._tri_inst[perm],
                                          device=self.device)
        self._obj_slots = torch.as_tensor(self._obj_tris[perm],
                                          device=self.device)

    def _transforms_tensor(self) -> torch.Tensor:
        """(I, 3, 4) current instance transforms on the device."""
        return torch.as_tensor(np.stack([i.transform for i in self.instances]),
                               device=self.device)

    def _world_tris_np(self) -> np.ndarray:
        tf = np.stack([i.transform for i in self.instances])  # (I,3,4)
        r = tf[self._tri_inst, :, :3]          # (F,3,3)
        t = tf[self._tri_inst, :, 3]           # (F,3)
        return np.einsum("fij,fvj->fvi", r, self._obj_tris) + t[:, None, :]

    # ---- casts through the flattened twin ----------------------------
    def cast_rays(self, rays: Rays, query_mask=ALL_LAYERS):
        """Closest-hit cast via the flattened scene.  Returns (hits,
        stats, instance_id); instance_id is -1 on a miss."""
        self._ensure_flat()
        hits, stats = self._flat.cast_rays(rays, query_mask)
        return hits, stats, self._instance_of_hits(hits)

    def any_hit_rays(self, rays: Rays, query_mask=ALL_LAYERS):
        self._ensure_flat()
        return self._flat.any_hit_rays(rays, query_mask)

    def _instance_of_hits(self, hits: Hits) -> torch.Tensor:
        inst_orig = torch.as_tensor(self._tri_inst,
                                    device=hits.prim_id.device)
        pid = hits.prim_id.clamp_min(0).long()
        return torch.where(hits.hit, inst_orig[pid],
                           torch.full_like(inst_orig[pid], -1))

    # ---- the instanced cast (cluster-TLAS kernel) ---------------------
    def build_instanced(self, tcap: int | None = None):
        """Build the instanced cluster-TLAS tables (memory ~ meshes)."""
        from ..kernels.cluster import TCAP_DEFAULT
        from ..kernels.cluster_tlas import build_cluster_tlas

        self._ctlas = build_cluster_tlas(
            [m.tri_array for m in self.meshes],
            [(i.blas_id, i.transform) for i in self.instances],
            tcap=TCAP_DEFAULT if tcap is None else tcap,
            mesh_layers=[m.layers_orig for m in self.meshes],
            inst_layers=[i.layers for i in self.instances],
            device=self.device,
        )
        return self._ctlas

    def cast_rays_instanced(self, rays: Rays, query_mask=ALL_LAYERS,
                            any_hit: bool = False):
        """Frame-scale instanced cast on kernel B1.  Returns (hits, stats,
        occluded, instance_id); prim ids are in the flattened numbering,
        so results compare directly with ``cast_rays``.  Runs inside the
        span ``tlas.cast``."""
        from ..kernels.cluster_v2 import cast_rays_cluster_tlas_v2

        if self._ctlas is None:
            self.build_instanced()
        with span("tlas.cast"):
            return cast_rays_cluster_tlas_v2(rays, self._ctlas,
                                             query_mask=query_mask,
                                             any_hit=any_hit)

    def instanced_scene(self) -> InstancedScene:
        """Scene-like view over the instanced cluster tables for renderers
        and path tracers: full frames with memory ~ meshes, never
        flattening.  Prim ids are in the flattened numbering, so material
        and attribute tables built for the flat scene apply."""
        if self._ctlas is None:
            self.build_instanced()
        ct = self._ctlas
        lo, hi = ct.pair_bounds
        return InstancedScene(
            cluster_tlas=ct,
            bounds=(torch.as_tensor(lo, device=self.device),
                    torch.as_tensor(hi, device=self.device)))

    # ---- dynamic updates ---------------------------------------------
    def set_transform(self, instance_id: int, transform) -> None:
        """Move one instance.  The instanced tables, if built, are refit
        at once on their device (``set_transforms``); an already-built
        flat twin keeps the old transforms until ``refit_tlas``.  Runs
        inside the span ``tlas.set_transform``."""
        from ..kernels.cluster_tlas import set_transforms

        with span("tlas.set_transform"):
            inst = self.instances[instance_id]
            self.instances[instance_id] = BLASInstance.create(
                inst.blas_id, _to_mat4(transform), inst.layers)
            self._two_level = None
            if self._ctlas is not None:
                self._ctlas = set_transforms(
                    self._ctlas, [i.transform for i in self.instances])

    def refit_tlas(self) -> None:
        """Bring the flat twin to the current transforms on its device:
        world triangles from the object-space slots (explicit float32
        multiply-adds), then the scene refit (triangles re-derived, BVH
        refit, tables refreshed).  Topology unchanged."""
        self._ensure_flat()
        with span("refit.tlas"):
            self._flat = _refit_slots(
                self._flat, *_world_slots(self._obj_slots, self._slot_inst,
                                          self._transforms_tensor()))

    # ---- two-level casts ----------------------------------------------
    def build_two_level(self):
        """Build the frontier two-level tables (``accel/tlas_frontier``):
        memory ~ meshes, not instances."""
        from .tlas_frontier import build_frontier_tlas

        self._two_level = build_frontier_tlas(self)
        return self._two_level

    def cast_rays_two_level_fast(self, rays: Rays, query_mask=ALL_LAYERS,
                                 any_hit: bool = False):
        """Log-time two-level cast: the TLAS frontier descent, per-instance
        object-space rays, the BLAS-forest descent.  Returns (hits, stats,
        occluded, instance_id)."""
        from .tlas_frontier import cast_rays_tlas

        ft = self._two_level
        if ft is None:
            ft = self.build_two_level()
        return cast_rays_tlas(rays, ft, query_mask, any_hit)

    def cast_rays_two_level(self, rays: Rays, query_mask=ALL_LAYERS):
        """Loop over the instances: each moves the rays to object space
        (the direction not renormalized, so t stays world-parameterized),
        casts them through its mesh's ``RayScene`` (kernel B1 on a cluster
        mesh) and brings position and normal back with explicit float32
        multiply-adds; a strictly closer world t wins.  O(instances): the
        validation path.  Returns (hits, instance_id); prim ids in the
        flattened numbering (instance base + mesh-local id)."""
        dev = rays.origin.device
        prim_base, acc = [], 0
        for inst in self.instances:
            prim_base.append(acc)
            acc += self.meshes[inst.blas_id].num_tris
        best = best_inst = None
        for i, inst in enumerate(self.instances):
            blas = self.meshes[inst.blas_id].scene
            inv = torch.as_tensor(inst.inv_transform, device=dev)
            obj_rays = Rays(origin=_apply_rt(inv, rays.origin),
                            direction=_apply_rt(inv, rays.direction,
                                                translate=False),
                            t_min=rays.t_min, t_max=rays.t_max)
            mask = (query_mask if inst.layers == ALL_LAYERS
                    else int(query_mask) & inst.layers)
            h, _ = blas.cast_rays(obj_rays, mask)
            m = torch.as_tensor(inst.transform, device=dev)
            wpos = _apply_rt(m, h.position)
            # the normal through the inverse-transpose basis: n @ R^-1
            n = h.normal
            wn = torch.stack([n[:, 0] * inv[0, a] + n[:, 1] * inv[1, a]
                              + n[:, 2] * inv[2, a] for a in range(3)],
                             dim=-1)
            wn = wn / _norm(wn)
            z3 = torch.zeros_like(wpos)
            hit = h.hit
            h = Hits(t=h.t, position=torch.where(hit[:, None], wpos, z3),
                     normal=torch.where(hit[:, None], wn, z3), u=h.u, v=h.v,
                     prim_id=torch.where(hit, h.prim_id + prim_base[i],
                                         torch.full_like(h.prim_id, NO_HIT)),
                     hit_layers=h.hit_layers)
            if best is None:
                best = h
                best_inst = torch.where(hit, i, -1).to(torch.int32)
                continue
            closer = hit & (h.t < best.t)
            best = Hits(*(torch.where(closer[:, None] if a.dim() == 2
                                      else closer, a, b)
                          for a, b in zip(
                              (h.t, h.position, h.normal, h.u, h.v,
                               h.prim_id, h.hit_layers),
                              (best.t, best.position, best.normal, best.u,
                               best.v, best.prim_id, best.hit_layers))))
            best_inst = torch.where(closer, i, best_inst).to(torch.int32)
        return best, best_inst
