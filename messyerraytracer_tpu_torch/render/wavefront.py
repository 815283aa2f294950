"""Wavefront path tracer.

PyTorch counterpart of the JAX package's render/wavefront.py: four stages
per bounce over device-resident SoA path state,

    Generate -> [ Extend -> Shade -> Connect ] x bounces -> finalize

  * deferred NEE: Shade at bounce b stores the light contribution as
    ``pending_nee``; Connect traces the shadow ray; the next Shade (or the
    finalize pass) adds the pending contribution where Connect found the
    light visible.
  * stochastic single-light NEE: one uniformly picked light per bounce,
    its contribution times the light count.
  * per-pixel PCG32 seeded like the iterative tracer (render/pathtrace.py).
  * Russian roulette from bounce 2; finalize applies tonemap + gamma.

``trace_frame`` runs the stages eagerly on the scene it was given
(``RayScene`` or ``InstancedScene``).  With scene bounds (the BVH root by
default) the frame is the carried-sort frame: the whole path state is
re-sorted once per bounce by the next extend rays' octant-major key and
the waves stay in that order.  The sort covers the whole wave: dead rays
get the maximal key, so they follow the live ones in their input order,
which is the permutation the JAX package's live-prefix buckets compute.

While a profiler records, a frame runs inside the span ``wavefront.frame``
and each stage inside its own: ``wavefront.generate``, ``.extend``,
``.shade``, ``.connect``, ``.sort`` (every coherence sort: a wave's, or the
carried path state's) and ``.finalize``; each wave adds the rays it hands
to a cast to the counter ``wavefront.slots`` and its live rays (active
extend rays, valid shadow rays) to ``wavefront.live`` (``utils/trace.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.types import Rays
from ..dispatch.morton import (
    apply_permutation,
    sort_perm_6d,
    sort_rays_6d,
    unshuffle_flags,
    unshuffle_hits,
)
from ..utils.trace import span
from .pathtrace import (
    PI,  # noqa: F401  (the JAX module's public constant, kept in one place)
    SHADOW_EPS,
    bounce_rays,
    dead_unless,
    pcg32_float,
    pixel_seeds,
    russian_roulette,
    sample_bounce,
)
from ..utils.trace import count, span
from .shade import (
    EnvironmentData,
    Lights,
    Materials,
    cook_torrance_single,
    extract_surface,
    light_sample_picked,
    sky_color,
    to_srgb,
    tonemap,
)


@dataclasses.dataclass(frozen=True)
class WavefrontState:
    """Device-resident path state: throughput/accum + the deferred-NEE
    slot + RNG + current and shadow rays, all (N,...) SoA."""

    throughput: torch.Tensor    # (N, 3)
    accum: torch.Tensor         # (N, 3)
    pending_nee: torch.Tensor   # (N, 3) deferred light contribution
    rng: torch.Tensor           # (N,) int64 PCG32 state (< 2^32)
    active: torch.Tensor        # (N,) bool
    ray: Rays                   # current extension rays
    shadow_ray: Rays            # current connect rays
    shadow_valid: torch.Tensor  # (N,) bool — pending_nee wants visibility
    visibility: torch.Tensor    # (N,) bool — Connect's result

    def replace(self, **kw) -> "WavefrontState":
        return dataclasses.replace(self, **kw)

    def take(self, perm: torch.Tensor) -> "WavefrontState":
        """Every per-path field in ``perm`` order; the consumed shadow rays
        and the extend rays' t range are kept as they are (all rays of a
        wave share them).  Runs inside the profiler range
        ``wavefront.take``."""
        with span("wavefront.take"):
            return WavefrontState(
                throughput=self.throughput[perm],
                accum=self.accum[perm],
                pending_nee=self.pending_nee[perm],
                rng=self.rng[perm],
                active=self.active[perm],
                ray=Rays(self.ray.origin[perm], self.ray.direction[perm],
                         self.ray.t_min, self.ray.t_max),
                shadow_ray=self.shadow_ray,
                shadow_valid=self.shadow_valid[perm],
                visibility=self.visibility[perm],
            )


def _finalize(state: WavefrontState) -> torch.Tensor:
    """Resolve the last bounce's deferred NEE."""
    return state.accum + torch.where(state.visibility[:, None],
                                     state.pending_nee, 0.0)


class WavefrontPathTracer:
    """4-stage wavefront integrator over a scene with cast/any-hit.
    ``bounds`` (lo, hi) is the scene AABB of the bounce-wave coherence
    sort; it defaults to the scene's BVH root when the scene has one."""

    def __init__(self, scene, lights: Lights | None, env: EnvironmentData,
                 materials: Materials, mat_id_of_prim=None,
                 attributes=None, atlas=None, bounds=None):
        self.scene = scene
        self.lights = lights
        self.env = env
        self.materials = materials
        self.mat_id_of_prim = mat_id_of_prim
        self.attributes = attributes
        self.atlas = atlas
        if bounds is None:
            bvh = getattr(scene, "bvh", None)
            if bvh is not None:
                bounds = (bvh.aabb_min[0], bvh.aabb_max[0])
        self.bounds = bounds

    def _mat_ids(self, hits):
        pid = hits.prim_id.clamp_min(0).long()
        if self.mat_id_of_prim is not None:
            return self.mat_id_of_prim[pid]
        return torch.zeros_like(pid)

    # ---- Generate -------------------------------------------------------
    def generate(self, rays: Rays, sample_index: int) -> WavefrontState:
        n = rays.count
        dev = rays.origin.device
        with span("wavefront.generate"):
            z3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
            f = torch.zeros((n,), dtype=torch.bool, device=dev)
            throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
            active = torch.ones((n,), dtype=torch.bool, device=dev)
        return WavefrontState(
            throughput=throughput, accum=z3, pending_nee=z3,
            rng=pixel_seeds(n, sample_index, dev), active=active,
            ray=rays, shadow_ray=rays, shadow_valid=f, visibility=f)

    # ---- Extend ---------------------------------------------------------
    def extend(self, state: WavefrontState, sort: bool = False):
        with span("wavefront.extend"):
            cast = dead_unless(state.ray, state.active)
            if not (sort and self.bounds is not None):
                return self.scene.cast_rays(cast)[0]
            with span("wavefront.sort"):
                sorted_rays, perm = sort_rays_6d(cast, *self.bounds)
            hits, _ = self.scene.cast_rays(sorted_rays, incoherent=True)
            return unshuffle_hits(hits, perm)

    # ---- Connect --------------------------------------------------------
    def connect(self, state: WavefrontState,
                sort: bool = False) -> WavefrontState:
        with span("wavefront.connect"):
            if sort and self.bounds is not None:
                with span("wavefront.sort"):
                    sorted_rays, perm = sort_rays_6d(state.shadow_ray,
                                                     *self.bounds)
                occluded = unshuffle_flags(
                    self.scene.any_hit_rays(sorted_rays, incoherent=True),
                    perm)
            else:
                occluded = self.scene.any_hit_rays(state.shadow_ray)
            with span("connect.visibility"):
                return state.replace(
                    visibility=~occluded & state.shadow_valid)

    # ---- Shade ----------------------------------------------------------
    def shade(self, state: WavefrontState, hits, bounce: int,
              max_bounces: int) -> WavefrontState:
        with span("wavefront.shade"):
            return self._shade(state, hits, bounce, max_bounces)

    def _shade(self, state: WavefrontState, hits, bounce: int,
               max_bounces: int) -> WavefrontState:
        n = state.rng.shape[0]
        dev = state.rng.device
        # 1) resolve the previous bounce's deferred NEE
        with span("shade.resolve"):
            accum = _finalize(state)
            hit = hits.hit & state.active
            pending = torch.zeros((n, 3), dtype=torch.float32, device=dev)
            shadow_valid = torch.zeros((n,), dtype=torch.bool, device=dev)
        with span("shade.sky"):
            sky = sky_color(state.ray.direction, self.env)
        with span("shade.miss"):
            accum = accum + torch.where((state.active & ~hits.hit)[:, None],
                                        state.throughput * sky, 0.0)
        with span("shade.surface"):
            surf = extract_surface(hits, state.ray.direction,
                                   self.materials, self._mat_ids(hits),
                                   attrs=self.attributes, atlas=self.atlas)
        with span("shade.emission"):
            accum = accum + torch.where(hit[:, None],
                                        state.throughput * surf.emission,
                                        0.0)

        # 2) stochastic single-light NEE -> pending, with its shadow ray
        rng = state.rng
        shadow_ray = state.shadow_ray
        if self.lights is not None and self.lights.count > 0:
            count = self.lights.count
            with span("shade.light"):
                rng, u_pick = pcg32_float(rng)
                li_pick = torch.clamp_max(
                    (u_pick * count).to(torch.int64), count - 1)
                ldir, atten, lvalid, dist, lcolor, is_dir = \
                    light_sample_picked(surf.position, self.lights, li_pick)
            with span("shade.brdf"):
                contrib, n_dot_l = cook_torrance_single(
                    surf, ldir, lcolor * atten[:, None])
            with span("shade.pending"):
                lvalid = lvalid & (n_dot_l > 0.0)
                contrib = torch.where(lvalid[:, None], contrib, 0.0)
                # x light count to unbias the uniform pick
                pending = state.throughput * contrib * float(count)
                shadow_valid = hit & lvalid
                tmax = torch.where(is_dir, 1e30, dist - 2.0 * SHADOW_EPS)
            with span("shade.shadow"):
                shadow_ray = Rays(
                    origin=hits.position + surf.normal * SHADOW_EPS,
                    direction=ldir,
                    t_min=torch.full((n,), SHADOW_EPS, dtype=torch.float32,
                                     device=dev),
                    t_max=torch.where(shadow_valid, tmax, -1.0))
                pending = torch.where(shadow_valid[:, None], pending, 0.0)

        # 3) sample the bounce
        with span("shade.bounce"):
            rng, bdir, bweight, bvalid = sample_bounce(surf, rng)
        with span("shade.throughput"):
            active = hit & bvalid
            throughput = torch.where(active[:, None],
                                     state.throughput * bweight,
                                     state.throughput)

        # 4) Russian roulette from bounce 2
        if bounce >= 1:
            with span("shade.roulette"):
                throughput, active, rng = russian_roulette(throughput,
                                                           active, rng)

        with span("shade.rays"):
            return WavefrontState(
                throughput=throughput, accum=accum, pending_nee=pending,
                rng=rng, active=active, ray=bounce_rays(hits, surf, bdir),
                shadow_ray=shadow_ray, shadow_valid=shadow_valid,
                visibility=torch.zeros((n,), dtype=torch.bool, device=dev))

    # ---- frame orchestration ------------------------------------------
    def trace_frame(self, rays: Rays, max_bounces: int = 3,
                    sample_index: int = 0, with_counts: bool = False):
        """One path-traced frame, linear RGB (N,3).

        ``with_counts=True`` also returns the counted number of live wave
        rays traced (active extend rays + valid shadow rays per bounce), a
        0-dim tensor, the denominator for path-tracing Mrays/s."""
        return self._trace_frame_stages(rays, max_bounces, sample_index,
                                        with_counts=with_counts)

    def _trace_frame_stages(self, rays: Rays, max_bounces: int = 3,
                            sample_index: int = 0,
                            with_counts: bool = False,
                            carried: bool | None = None):
        if carried is None:
            carried = self.bounds is not None
        frame = (self._trace_frame_carried if carried
                 else self._trace_frame_waves)
        with span("wavefront.frame"):
            return frame(rays, max_bounces, sample_index, with_counts)

    @staticmethod
    def _wave(wave_rays: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
        """``wave_rays`` plus a wave's live rays (``live``: its mask over
        the wave's slots), both also added to the counters."""
        with span("wavefront.count"):
            k = live.sum()
            count("wavefront.slots", live.shape[0])
            count("wavefront.live", k)
            return wave_rays + k

    def _trace_frame_waves(self, rays: Rays, max_bounces: int,
                           sample_index: int, with_counts: bool):
        """Per-wave-sorted frame: each wave is sorted on its own and
        unshuffled after its cast."""
        state = self.generate(rays, sample_index)
        with span("wavefront.generate"):
            wave_rays = torch.zeros((), dtype=torch.int64,
                                    device=rays.origin.device)
        for bounce in range(max_bounces + 1):
            # bounce-0 primaries are camera-coherent already; later
            # waves get the octant-major coherence sort
            hits = self.extend(state, sort=bounce > 0)
            wave_rays = self._wave(wave_rays, state.active)
            state = self.shade(state, hits, bounce, max_bounces)
            wave_rays = self._wave(wave_rays, state.shadow_valid)
            state = self.connect(state, sort=bounce > 0)
        with span("wavefront.finalize"):
            accum = _finalize(state)
        return (accum, wave_rays) if with_counts else accum

    def _trace_frame_carried(self, rays: Rays, max_bounces: int,
                             sample_index: int, with_counts: bool):
        """Carried-sort frame: one coherence sort of the whole path state
        per bounce, by the next extend rays' octant-major key, with dead
        paths last.  The connect wave of a later bounce gets its own sort
        (shadow-valid first) and is unshuffled; hits are consumed in the
        carried order, and pixel ids ride along for one final scatter.
        Every stage computes the same values in permuted order, so the
        result equals the per-wave-sorted frame up to the order of exact-t
        ties and of float additions."""
        state = self.generate(rays, sample_index)
        with span("wavefront.generate"):
            pix = torch.arange(rays.count, device=rays.origin.device)
            wave_rays = torch.zeros((), dtype=torch.int64,
                                    device=rays.origin.device)
        for bounce in range(max_bounces + 1):
            with span("wavefront.extend"):
                hits, _ = self.scene.cast_rays(
                    dead_unless(state.ray, state.active),
                    incoherent=bounce > 0)
            wave_rays = self._wave(wave_rays, state.active)
            state = self.shade(state, hits, bounce, max_bounces)
            wave_rays = self._wave(wave_rays, state.shadow_valid)
            with span("wavefront.connect"):
                if bounce > 0:
                    with span("wavefront.sort"):
                        sperm = sort_perm_6d(state.shadow_ray, *self.bounds,
                                             live=state.shadow_valid)
                    occ_s = self.scene.any_hit_rays(
                        apply_permutation(state.shadow_ray, sperm),
                        incoherent=True)
                    occluded = unshuffle_flags(occ_s, sperm)
                else:
                    occluded = self.scene.any_hit_rays(state.shadow_ray)
                with span("connect.visibility"):
                    state = state.replace(
                        visibility=~occluded & state.shadow_valid)
            if bounce < max_bounces:
                with span("wavefront.sort"):
                    perm = sort_perm_6d(state.ray, *self.bounds,
                                        live=state.active)
                    state = state.take(perm)
                    with span("wavefront.pixels"):
                        pix = pix[perm]
        with span("wavefront.finalize"):
            accum = _finalize(state)
            out = torch.empty_like(accum)
            out[pix] = accum        # one final scatter back to pixel order
        return (out, wave_rays) if with_counts else out

    def trace_frame_srgb(self, rays: Rays, max_bounces: int = 3,
                         sample_index: int = 0) -> torch.Tensor:
        linear = self.trace_frame(rays, max_bounces, sample_index)
        return to_srgb(tonemap(linear, self.env.tonemap_mode))
