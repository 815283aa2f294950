"""Core SoA types: rays, hits, triangles, stats — as dataclasses of tensors.

PyTorch counterpart of ``messyerraytracer_tpu/core/types.py``: one struct
per *batch* (structure-of-arrays), every field a dense ``(N, ...)`` tensor.

Numerical semantics (bit-equal constants, reference parity):
  * ``t_min`` default 0.001 (shadow-acne offset)
  * safe inverse direction with eps 1e-9 -> +/-1e9 clamp
  * Moller-Trumbore determinant epsilon 1e-8
  * NO_HIT sentinel -1 (int32 bit pattern of UINT32_MAX)
  * strictly-closer hit update ``t < best_t`` => the lowest index wins
    exact ties
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.trace import span

# --- constants (bit-equal to the JAX package) -------------------------------
T_MIN_DEFAULT = 1e-3
T_MAX_DEFAULT = 3.402823466e38  # FLT_MAX
INV_DIR_EPS = 1e-9
MT_DET_EPS = 1e-8
# Barycentric crack tolerance of the ANCHORED cluster intersection only
# (see the JAX package's core/types.py for the derivation); the classic
# Moller-Trumbore paths keep the exact >= 0 test.
MT_BARY_EPS = 4e-6
NO_HIT = -1
ALL_LAYERS = -1
# Builders and generators put their tensors on the card unless the caller
# passes ``device=`` (``"cpu"`` for the plain versions).
DEFAULT_DEVICE = torch.device("cuda")

# --- conventions of the traversal kernels (B1, B4) and their plain versions
KSTACK = 64             # traversal stack floor (scenes size it up from
#                         their build-time worst case, kstack_for)
KCAPS = (64, 128, 256)  # stack capacities the kernels are compiled for
PLAIN_CHUNK = 65536     # rays per plain-version pass (bounds its memory)
# f32 constants shared by the kernels (passed as arguments) and the plain
# versions, so both compare against the same rounded values
KERNEL_F32 = {
    "det_eps": float(np.float32(MT_DET_EPS)),
    "bary_lo": float(np.float32(-MT_BARY_EPS)),
    "bary_hi": float(np.float32(1.0 + MT_BARY_EPS)),
    "inv_eps": float(np.float32(INV_DIR_EPS)),
    "big": float(np.float32(3.0e38)),   # "no hit yet" in the traversal
    "t_miss": float(np.float32(T_MAX_DEFAULT)),
}


def as_int32(mask: int) -> int:
    """A layer mask as a signed 32-bit value (0xFFFFFFFF -> -1)."""
    return ((int(mask) + (1 << 31)) % (1 << 32)) - (1 << 31)


def kstack_for(stack_need: int) -> int:
    """Traversal stack size for a cast: the scene's build-time worst-case
    bound (``_wide_stack_need``) plus slack, floored at KSTACK (the JAX
    package's sizing at one pop per step)."""
    return max(KSTACK, int(stack_need) + 2)


def kernel_stack(stack_need: int, kstack: int | None = None) -> tuple:
    """(kstack, kcap) of a kernel launch: ``kstack`` (default
    ``kstack_for(stack_need)``) and the least compiled capacity of KCAPS
    that holds it; raises ``ValueError`` outside 1..KCAPS[-1]."""
    kstack = kstack_for(stack_need) if kstack is None else int(kstack)
    kcap = next((k for k in KCAPS if k >= kstack), None)
    if kcap is None or kstack < 1:
        raise ValueError(f"kstack {kstack} outside 1..{KCAPS[-1]}")
    return kstack, kcap


@dataclasses.dataclass
class Rays:
    """A batch of N rays in SoA layout.

    origin:    (N, 3) float32
    direction: (N, 3) float32 — should be normalized so t equals distance
    t_min:     (N,)   float32
    t_max:     (N,)   float32
    """

    origin: torch.Tensor
    direction: torch.Tensor
    t_min: torch.Tensor
    t_max: torch.Tensor

    @property
    def count(self) -> int:
        return self.origin.shape[0]

    def to(self, device) -> "Rays":
        return Rays(*(x.to(device) for x in (self.origin, self.direction,
                                             self.t_min, self.t_max)))

    def take(self, idx) -> "Rays":
        """Rays ``idx`` (an index tensor or array) as a new batch."""
        with span("rays.take"):
            return Rays(self.origin[idx], self.direction[idx],
                        self.t_min[idx], self.t_max[idx])


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def make_rays(origin, direction, t_min=None, t_max=None,
              device=None) -> Rays:
    """Build a ``Rays`` batch with reference-default t bounds, on
    ``device``; None means the device of ``origin`` when it is a tensor,
    else ``DEFAULT_DEVICE``."""
    if device is None:
        device = (origin.device if isinstance(origin, torch.Tensor)
                  else DEFAULT_DEVICE)
    origin = _f32(origin, device)
    direction = _f32(direction, device)
    if origin.ndim == 1:
        origin = origin[None, :]
    if direction.ndim == 1:
        direction = direction[None, :]
    origin, direction = torch.broadcast_tensors(origin, direction)
    origin, direction = origin.contiguous(), direction.contiguous()
    n = origin.shape[0]
    if t_min is None:
        t_min = torch.full((n,), T_MIN_DEFAULT, dtype=torch.float32,
                           device=device)
    else:
        t_min = _f32(t_min, device).broadcast_to((n,)).contiguous()
    if t_max is None:
        t_max = torch.full((n,), T_MAX_DEFAULT, dtype=torch.float32,
                           device=device)
    else:
        t_max = _f32(t_max, device).broadcast_to((n,)).contiguous()
    return Rays(origin=origin, direction=direction, t_min=t_min, t_max=t_max)


def safe_inv_direction(direction: torch.Tensor) -> torch.Tensor:
    """Safe 1/direction: near-zero components -> signed 1/eps = ±1e9
    (0 counts as +).  Tensor-by-tensor divisions only: a division by a
    Python scalar runs as a multiply by its reciprocal on CUDA, which
    rounds differently from the kernel's IEEE division."""
    small = direction.abs() < INV_DIR_EPS
    one = torch.ones_like(direction)
    sign = torch.where(direction < 0.0, -one, one)
    return torch.where(small, sign / torch.full_like(direction, INV_DIR_EPS),
                       one / torch.where(small, one, direction))


@dataclasses.dataclass
class Hits:
    """A batch of N intersection results in SoA layout.

      t:          (N,)  float32, FLT_MAX when miss
      position:   (N,3) float32, origin + direction*t
      normal:     (N,3) float32, geometric (face) normal
      u, v:       (N,)  float32 barycentric weights for v1 / v2
      prim_id:    (N,)  int32, NO_HIT (-1) when miss
      hit_layers: (N,)  int32 layer bitmask of the hit triangle (0 on miss)
    """

    t: torch.Tensor
    position: torch.Tensor
    normal: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    prim_id: torch.Tensor
    hit_layers: torch.Tensor

    @property
    def hit(self) -> torch.Tensor:
        """(N,) bool — did the ray hit anything?"""
        return self.prim_id != NO_HIT

    @property
    def count(self) -> int:
        return self.t.shape[0]


def make_miss(n: int, device=DEFAULT_DEVICE) -> Hits:
    """All-miss hit batch."""
    f3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    return Hits(
        t=torch.full((n,), T_MAX_DEFAULT, dtype=torch.float32, device=device),
        position=f3,
        normal=f3.clone(),
        u=torch.zeros((n,), dtype=torch.float32, device=device),
        v=torch.zeros((n,), dtype=torch.float32, device=device),
        prim_id=torch.full((n,), NO_HIT, dtype=torch.int32, device=device),
        hit_layers=torch.zeros((n,), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class Triangles:
    """A batch of T triangles in SoA layout with precomputed edges/normals.

    v0:      (T, 3) float32
    edge1:   (T, 3) float32  v1 - v0
    edge2:   (T, 3) float32  v2 - v0
    normal:  (T, 3) float32  normalize(edge1 x edge2)
    prim_id: (T,)   int32
    layers:  (T,)   int32
    """

    v0: torch.Tensor
    edge1: torch.Tensor
    edge2: torch.Tensor
    normal: torch.Tensor
    prim_id: torch.Tensor
    layers: torch.Tensor

    @property
    def count(self) -> int:
        return self.v0.shape[0]

    @property
    def v1(self) -> torch.Tensor:
        return self.v0 + self.edge1

    @property
    def v2(self) -> torch.Tensor:
        return self.v0 + self.edge2


def triangle_fields_np(v0, v1, v2):
    """(v0, e1, e2, unit normal) in float32 numpy, the JAX package's host
    derivation (same operations, so bit-equal tables)."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(v1, np.float32) - v0
    e2 = np.asarray(v2, np.float32) - v0
    nrm = np.cross(e1, e2)
    nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = (nrm / np.where(nl > 0.0, nl, 1.0)).astype(np.float32)
    return v0, e1, e2, nrm


def make_triangles(v0, v1, v2, prim_id=None, layers=None,
                   device=DEFAULT_DEVICE) -> Triangles:
    """Build a ``Triangles`` batch, precomputing edges and face normals on
    the host and putting the finished arrays on ``device``."""
    v0, e1, e2, nrm = triangle_fields_np(v0, v1, v2)
    t = v0.shape[0]
    prim_id = (np.arange(t, dtype=np.int32) if prim_id is None
               else np.asarray(prim_id, np.int32))
    layers = (np.full((t,), ALL_LAYERS, np.int32) if layers is None
              else np.asarray(layers, np.int32))
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return Triangles(v0=put(v0), edge1=put(e1), edge2=put(e2),
                     normal=put(nrm), prim_id=put(prim_id),
                     layers=put(layers))


@dataclasses.dataclass
class RayStats:
    """Per-cast counters, each a 0-dim int64 tensor on the cast's device.

    stack_drops counts traversal-stack pushes a cast had to drop (stack
    full).  The stack is sized from the build-time worst case
    so this is 0 by construction; a nonzero value means the cast may have
    missed hits and MUST fail any parity gate.
    """

    rays_cast: torch.Tensor
    tri_tests: torch.Tensor
    bvh_nodes_visited: torch.Tensor
    hits: torch.Tensor
    stack_drops: torch.Tensor | int = 0

    def __add__(self, other: "RayStats") -> "RayStats":
        return RayStats(
            rays_cast=self.rays_cast + other.rays_cast,
            tri_tests=self.tri_tests + other.tri_tests,
            bvh_nodes_visited=self.bvh_nodes_visited
            + other.bvh_nodes_visited,
            hits=self.hits + other.hits,
            stack_drops=self.stack_drops + other.stack_drops,
        )

    def _per_ray(self, x) -> float:
        n = int(self.rays_cast)
        return float(x) / n if n > 0 else 0.0

    def avg_tri_tests_per_ray(self) -> float:
        return self._per_ray(self.tri_tests)

    def avg_nodes_per_ray(self) -> float:
        return self._per_ray(self.bvh_nodes_visited)

    def hit_rate(self) -> float:
        return self._per_ray(self.hits)


def zero_stats(device=DEFAULT_DEVICE) -> RayStats:
    """A ``RayStats`` of zeros on ``device``, stack_drops included."""
    return RayStats(*(torch.zeros((), dtype=torch.int64, device=device)
                      for _ in range(5)))
