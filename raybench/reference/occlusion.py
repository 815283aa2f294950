"""The comparison of any-hit answers, and the control's any-hit answers.

An any-hit ray is bad when its flag differs from the float64 reference's,
a hit at some t in [t_min, t_max].  A hit within the judge's t tolerance
(``judge.T_RTOL`` * t + ``judge.ANCHOR_ULPS`` float32 ulps of the scene's
largest coordinate) of t_min or t_max may fall on either side in float32,
so there either answer passes: the flag must be true where the reference
hits inside the span shrunk by the tolerance at both ends, and false
where it hits nothing inside the span widened by it.  These rays count
into ``bad_ray_share`` with the nearest rays.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cast as rcast
from . import judge as rjudge


def _tolerance(t: torch.Tensor, atol: float) -> torch.Tensor:
    return rjudge.T_RTOL * t.abs() + atol


def bad_flags(flags, origin, direction, t_min, t_max, tris) -> dict:
    """Judge the program's any-hit ``flags`` (the sampled rays') against
    the float64 reference on the same rays.  Returns counts: rays, bad
    (also as ``bad_flag``), the rays the reference finds surely occluded,
    and those where either answer passes."""
    dev = origin.device
    tris = tris.to(device=dev, dtype=torch.float64)
    atol = rjudge.ANCHOR_ULPS * float(np.finfo(np.float32).eps) * float(
        tris.abs().max())
    lo, hi = t_min.double(), t_max.double()
    tol_lo, tol_hi = _tolerance(lo, atol), _tolerance(hi, atol)
    # the nearest hit in the widened span, then, where it lies within the
    # tolerance of t_min, the nearest beyond that band
    t_near, p_near = rcast.cast(origin, direction, lo - tol_lo, hi + tol_hi,
                                tris)
    possible = p_near >= 0
    band = possible & (t_near < lo + tol_lo)
    t_in = t_near.clone()
    if bool(band.any()):
        sel = band.nonzero()[:, 0]
        t_in[sel], _ = rcast.cast(origin[sel], direction[sel],
                                  (lo + tol_lo)[sel], (hi + tol_hi)[sel],
                                  tris)
    certain = possible & (t_in <= hi - tol_hi)
    flags = flags.to(device=dev, dtype=torch.bool)
    bad = (flags & ~possible) | (~flags & certain)
    return {"rays": int(flags.numel()), "bad": int(bad.sum()),
            "occluded": int(certain.sum()),
            "either": int((possible & ~certain).sum()),
            "bad_flag": int(bad.sum())}


def control_flags(origin, direction, t_min, t_max, tris,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """The reference's any-hit flags computed in ``dtype``: the answers
    the control gives in the program's place."""
    return rcast.cast(origin, direction, t_min, t_max, tris, dtype,
                      any_hit=True)
