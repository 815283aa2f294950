"""User-facing service API.

PyTorch counterpart of the JAX package's api/service.py:

  * ``RayQuery`` / ``RayQueryResult`` — the batch request/response: rays +
    layer mask + NEAREST/ANY_HIT mode + ``coherent`` hint +
    ``collect_stats``
  * ``RayTracerService`` — the scene-owning server object: mesh/instance
    registration, scene (re)build, single and batch casts through the
    Morton-sorting ``RayDispatcher``, backend switching, per-cast stats and
    timing, async submit/collect
  * ``RayBatch`` — incremental batch builder for script-style use
  * ``probe_cast`` — a cast from a node transform

Scene state is immutable tensors: a rebuild makes a new set while casts in
flight keep the old one alive, so no lock exists.  Casts are launched
asynchronously on the current CUDA stream; ``submit`` waits for its result
(wall-clock timed), ``submit_async`` records a CUDA event per ticket and
``collect_async`` waits on it.  On CPU tensors the work is done when the
call returns, and both waits are no-ops.

Every request (``submit``, ``submit_async``, and so ``cast_ray``) gets a
request id, unique in the process and increasing, returned as
``RayQueryResult.request_id``; it is also the async ticket.  While a
profiler records, the spans ``service.submit``, ``service.wait`` (the
stream sync of ``submit``) and ``service.collect`` log their intervals
under it (``utils/trace.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

import numpy as np
import torch

from ..accel.tlas import SceneTLAS, _to_mat4
from ..core.types import (ALL_LAYERS, DEFAULT_DEVICE, Hits, Rays, RayStats,
                          make_rays)
from ..dispatch.dispatcher import RayDispatcher
from ..scene.scene import RayScene
from ..utils.trace import request_span, span

MODE_NEAREST = 0
MODE_ANY_HIT = 1

_REQUEST_IDS = itertools.count(1)   # process-wide, so the log's ids differ


@dataclasses.dataclass
class RayQuery:
    """Batch cast request."""

    rays: Rays
    layer_mask: int = ALL_LAYERS
    mode: int = MODE_NEAREST
    coherent: bool = False     # primary rays: skip the Morton sort
    collect_stats: bool = True


@dataclasses.dataclass
class RayQueryResult:
    """Batch cast response."""

    hits: Optional[Hits] = None
    hit_flags: Optional[torch.Tensor] = None   # ANY_HIT mode
    stats: Optional[RayStats] = None
    elapsed_ms: float = 0.0
    request_id: int = 0


def _wait(device: torch.device) -> None:
    """Wait for the work queued on the device's current stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class RayTracerService:
    """The central scene-owning service.  The scene's tables follow the
    backend it is constructed with: ``backend="pallas"`` builds the flat
    twin with kernel B4's 8-wide tables (``build`` and ``refit`` alike)
    and casts on them; every other backend builds kernel B1's cluster
    tables, over which ``set_backend`` walks the chain cluster -> pallas
    -> jnp.

    ``register_mesh`` (or ``tlas.add_mesh`` + ``add_instance``),
    ``build()``, then ``cast_ray`` / ``submit``.  Scene tensors live on
    ``device``; queries must put their rays there too.
    """

    BACKENDS = ("cluster", "pallas", "frontier", "frontier_q", "jnp",
                "brute", "auto")

    def __init__(self, backend: str = "auto", device=DEFAULT_DEVICE):
        self._check_backend(backend)
        self._backend = backend
        self.device = torch.device(device)
        # the tables the scene is built with: B4's for "pallas", else B1's
        self._tables = "pallas" if backend == "pallas" else "cluster"
        self._tlas = SceneTLAS(backend=self._tables, device=self.device)
        self._dispatcher: RayDispatcher | None = None
        self._last_stats: RayStats | None = None
        self._last_elapsed_ms = 0.0
        self._pending: dict[int, tuple] = {}   # request id -> its result

    def _check_backend(self, backend: str) -> None:
        if backend not in self.BACKENDS:
            raise ValueError(f"backend {backend!r} not in {self.BACKENDS}")

    # ---- scene management ---------------------------------------------
    def register_mesh(self, tri_array, transform=None,
                      layers: int = ALL_LAYERS) -> int:
        """Register a mesh and one instance of it; returns the instance id.

        ``tri_array``: (T,3,3) object-space vertices.  ``transform``: 4x4 /
        3x4 world transform (identity if None).  Meshes with identical
        geometry can be registered once and instanced via
        ``add_instance``.
        """
        blas_id = self._tlas.add_mesh(np.asarray(tri_array, np.float32))
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        return self._tlas.add_instance(blas_id, transform, layers)

    def add_instance(self, blas_id: int, transform,
                     layers: int = ALL_LAYERS) -> int:
        return self._tlas.add_instance(blas_id, transform, layers)

    def build(self) -> None:
        """(Re)build the scene: the flattened world-space twin, with the
        tables of the constructed backend, cast through the dispatcher."""
        self._tlas.build_tlas()
        self._dispatcher = RayDispatcher(self._tlas.flat,
                                         backend=self._resolve_backend())

    def set_transform(self, instance_id: int, transform) -> None:
        """Move an instance; casts see it after ``refit()``."""
        self._tlas.set_transform(instance_id, transform)

    def refit(self) -> None:
        """Refit the flat twin to the transforms set since the last build
        or refit, on the device (topology unchanged), then dispatch over
        the refit twin."""
        self._tlas.refit_tlas()
        self._dispatcher = RayDispatcher(self._tlas.flat,
                                         backend=self._resolve_backend())

    def clear_scene(self) -> None:
        self._tlas = SceneTLAS(backend=self._tables, device=self.device)
        self._dispatcher = None

    @property
    def scene(self) -> RayScene | None:
        return self._tlas.flat

    @property
    def tlas(self) -> SceneTLAS:
        return self._tlas

    # ---- backend control ----------------------------------------------
    def set_backend(self, backend: str) -> None:
        """Switch the cast backend.  The chain cluster -> pallas -> jnp
        follows from which tables the scene has (a ``cluster`` request
        on a scene without cluster tables uses the wide tables, and
        without those the binary BVH); every link runs on the scene's
        device.  The tables stay those of the construction (see the
        class): switching never rebuilds them."""
        self._check_backend(backend)
        self._backend = backend
        if self._dispatcher is not None:
            self._dispatcher.backend = self._resolve_backend()

    def get_backend(self) -> str:
        return self._resolve_backend()

    def _resolve_backend(self) -> str:
        b = self._backend
        if b == "auto":
            b = "cluster"
        if b == "cluster" and (
            self._tlas.flat is None or self._tlas.flat.cluster is None
        ):
            b = "pallas"
        if b == "pallas" and (
            self._tlas.flat is None or self._tlas.flat.wide is None
        ):
            b = "jnp"
        return b

    # ---- casts ----------------------------------------------------------
    def cast_ray(self, origin, direction, t_min=1e-3, t_max=None,
                 layer_mask: int = ALL_LAYERS) -> dict:
        """Single-ray convenience; returns {hit, position, normal,
        distance, prim_id, hit_layers, instance_id}."""
        rays = make_rays(origin, direction, t_min=t_min, t_max=t_max,
                         device=self.device)
        res = self.submit(RayQuery(rays=rays, layer_mask=layer_mask))
        h = res.hits
        inst = self._tlas._instance_of_hits(h)
        hit = bool(h.hit[0])
        return {
            "hit": hit,
            "position": h.position[0].cpu().numpy(),
            "normal": h.normal[0].cpu().numpy(),
            "distance": float(h.t[0]) if hit else float("inf"),
            "prim_id": int(h.prim_id[0]),
            "hit_layers": int(h.hit_layers[0]),
            "instance_id": int(inst[0]),
        }

    def _dispatch(self, query: RayQuery):
        if self._dispatcher is None:
            raise RuntimeError("call build() first")
        if query.mode == MODE_ANY_HIT:
            occ = self._dispatcher.any_hit_rays(
                query.rays, query.layer_mask, coherent=query.coherent)
            return None, occ, None
        hits, stats = self._dispatcher.cast_rays(
            query.rays, query.layer_mask, coherent=query.coherent)
        return hits, None, stats

    def submit(self, query: RayQuery) -> RayQueryResult:
        """Batch cast, the preferred entry point; waits for the result and
        times the call on the wall clock."""
        rid = next(_REQUEST_IDS)
        t0 = time.perf_counter()
        with request_span("service.submit", rid):
            hits, occ, stats = self._dispatch(query)
            with request_span("service.wait", rid):
                _wait(query.rays.origin.device)
            with span("service.result"):
                result = RayQueryResult(hits=hits, hit_flags=occ,
                                        request_id=rid)
                if hits is not None and query.collect_stats:
                    result.stats = stats
                    self._last_stats = stats
                result.elapsed_ms = (time.perf_counter() - t0) * 1e3
                self._last_elapsed_ms = result.elapsed_ms
        return result

    def cast_rays_batch(self, rays: Rays, layer_mask: int = ALL_LAYERS,
                        coherent: bool = False) -> tuple[Hits, RayStats]:
        res = self.submit(
            RayQuery(rays=rays, layer_mask=layer_mask, coherent=coherent))
        return res.hits, res.stats

    def any_hit_batch(self, rays: Rays, layer_mask: int = ALL_LAYERS):
        res = self.submit(
            RayQuery(rays=rays, layer_mask=layer_mask, mode=MODE_ANY_HIT))
        return res.hit_flags

    # ---- async ----------------------------------------------------------
    def submit_async(self, query: RayQuery) -> int:
        """Launch a cast without waiting; returns its request id, the
        ticket for ``collect_async``.  On a CUDA device an event recorded
        on the current stream marks the end of the ticket's work."""
        rid = next(_REQUEST_IDS)
        with request_span("service.submit", rid):
            hits, occ, stats = self._dispatch(query)
            dev = query.rays.origin.device
            event = None
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            self._pending[rid] = (hits, occ, stats, event)
        return rid

    def collect_async(self, ticket: int) -> RayQueryResult:
        """Wait until the ticketed cast finishes and return it; a ticket
        is collected once (its result is then let go)."""
        with request_span("service.collect", ticket):
            if ticket not in self._pending:
                raise KeyError(f"ticket {ticket} is not pending: unknown "
                               f"or already collected")
            hits, occ, stats, event = self._pending.pop(ticket)
            if event is not None:
                event.synchronize()
        return RayQueryResult(hits=hits, hit_flags=occ, stats=stats,
                              request_id=ticket)

    # ---- stats ------------------------------------------------------------
    def get_last_stats(self) -> dict:
        if self._last_stats is None:
            return {}
        from ..debug.debug import stats_summary

        d = stats_summary(self._last_stats)
        d["elapsed_ms"] = self._last_elapsed_ms
        d["backend"] = self._resolve_backend()
        return d


class RayBatch:
    """Incremental ray batch builder: ``add_ray`` repeatedly, ``cast()``
    once, then read indexed results."""

    def __init__(self, service: RayTracerService):
        self._svc = service
        self._origins: list = []
        self._dirs: list = []
        self._tmins: list = []
        self._tmaxs: list = []
        self._result: RayQueryResult | None = None

    def add_ray(self, origin, direction) -> int:
        return self.add_ray_ex(origin, direction, 1e-3, 3.4e38)

    def add_ray_ex(self, origin, direction, t_min, t_max) -> int:
        self._origins.append(tuple(origin))
        self._dirs.append(tuple(direction))
        self._tmins.append(float(t_min))
        self._tmaxs.append(float(t_max))
        return len(self._origins) - 1

    @property
    def size(self) -> int:
        return len(self._origins)

    def clear(self) -> None:
        self.__init__(self._svc)

    def cast(self, layer_mask: int = ALL_LAYERS, coherent=False) -> None:
        def f32(x):
            return torch.tensor(np.asarray(x, np.float32),
                                device=self._svc.device)

        rays = Rays(origin=f32(self._origins), direction=f32(self._dirs),
                    t_min=f32(self._tmins), t_max=f32(self._tmaxs))
        self._result = self._svc.submit(
            RayQuery(rays=rays, layer_mask=layer_mask, coherent=coherent))

    def _h(self) -> Hits:
        if self._result is None:
            raise RuntimeError("cast() first")
        return self._result.hits

    def is_hit(self, i: int) -> bool:
        return bool(self._h().hit[i])

    def get_distance(self, i: int) -> float:
        return float(self._h().t[i])

    def get_position(self, i: int) -> np.ndarray:
        return self._h().position[i].cpu().numpy()

    def get_normal(self, i: int) -> np.ndarray:
        return self._h().normal[i].cpu().numpy()

    def get_prim_id(self, i: int) -> int:
        return int(self._h().prim_id[i])

    def get_stats(self) -> dict:
        return self._svc.get_last_stats()


def probe_cast(service: RayTracerService, transform,
               local_direction=(0, 0, -1), max_distance=1000.0,
               layer_mask: int = ALL_LAYERS) -> dict:
    """Cast from a node transform: origin = the transform's translation,
    direction = the local direction through its basis."""
    m = _to_mat4(transform)
    origin = m[:, 3]
    d = m[:, :3] @ np.asarray(local_direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-12)
    return service.cast_ray(origin, d, t_max=max_distance,
                            layer_mask=layer_mask)
