"""Kernel M1, the sort keys of dispatch/morton.py in one launch: its
launcher's input checks and the plain path's ``dir_bits`` range on the CPU;
on a card, M1's keys against the plain version's bit for bit, the keyed
sorts' permutations and sorted rays, no host sync, and M1's launch count,
span and counter under the profiler.  (The plain keys are held against the
JAX package's in tests/test_torch_dispatch.py.)"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import np_of, rand_rays_np

from messyerraytracer_tpu_torch.core.types import make_rays
from messyerraytracer_tpu_torch.dispatch import morton as pm
from messyerraytracer_tpu_torch.kernels import morton_keys as km

LO = np.float32([-5.0, -1.0, -4.0])
HI = np.float32([6.0, 4.5, 5.0])
FLAT_HI = np.float32([6.0, -1.0, 5.0])      # hi == lo on the y axis


def rays_with_specials(n: int, seed: int):
    """(origin, direction) float32 numpy: random rays in and around the
    box, with rows of +-0 and +-1 direction components, origins on ``lo``
    and ``hi`` and outside the box, and NaN and +-inf origins and
    directions."""
    o, d = rand_rays_np(n, seed=seed, extent=8.0)
    rng = np.random.default_rng(seed + 1)
    special = np.float32([0.0, -0.0, 1.0, -1.0, np.nan, np.inf, -np.inf])
    edges = np.concatenate([special, LO, HI, LO - 1.0, HI + 1.0])
    rows = rng.random(n)
    pick = rows < 0.1
    d[pick] = rng.choice(special[:4], (int(pick.sum()), 3))
    pick = (rows >= 0.1) & (rows < 0.2)
    o[pick] = rng.choice(edges, (int(pick.sum()), 3))
    pick = (rows >= 0.2) & (rows < 0.25)
    d[pick] = rng.choice(special, (int(pick.sum()), 3))
    o[n // 2:n // 2 + 1] = LO
    o[n - 1:] = HI
    return o, d


def live_flags(mode: str, n: int, seed: int):
    if mode == "absent":
        return None
    if mode == "mixed":
        return torch.from_numpy(np.random.default_rng(seed).random(n) < 0.6)
    return torch.full((n,), mode == "all live", dtype=torch.bool)


# the key variants: (kind, dir_bits); octant-major at every dir_bits
VARIANTS = ([(km.OCTANT_MAJOR, b) for b in range(1, km.MAX_DIR_BITS + 1)]
            + [(km.ORIGIN_MAJOR, 1), (km.DIRECTION, 1)])


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits, so that NaNs compare equal."""
    return t.view(torch.int32)


def plain_keys(rays, lo, hi, kind, dir_bits, live):
    """The plain version's int32 keys on the rays' own device."""
    if kind == km.DIRECTION:
        keys = pm._ray_direction_morton(rays.direction)
    else:
        keys = pm._keys_6d(rays, lo, hi, kind == km.OCTANT_MAJOR, dir_bits)
    if live is not None:
        keys = torch.where(live.to(keys.device), keys,
                           torch.full_like(keys, pm.DEAD_KEY))
    return keys.to(torch.int32)


# ---- CPU ----------------------------------------------------------------

def _bad_inputs(fault: str):
    o, d = (torch.from_numpy(a) for a in rand_rays_np(64, seed=1))
    lo, hi = torch.from_numpy(LO), torch.from_numpy(HI)
    args = dict(origin=o, direction=d, lo=lo, hi=hi, kind=km.OCTANT_MAJOR)
    if fault == "dtype":
        args["direction"] = d.double()
    elif fault == "live dtype":
        args["live"] = torch.ones(64, dtype=torch.uint8)
    elif fault == "box dtype":
        args["lo"] = lo.double()
    elif fault == "non-contiguous":
        args["origin"] = o.t().contiguous().t()
    elif fault == "shape":
        args["origin"] = o[:32]
    elif fault == "kind":
        args["kind"] = 3
    elif fault == "dir_bits 0":
        args["dir_bits"] = 0
    elif fault == "dir_bits 10":
        args["dir_bits"] = 10
    return args


@pytest.mark.parametrize("fault,match", [
    ("cpu", "CUDA"), ("dtype", "dtype"), ("live dtype", "dtype"),
    ("box dtype", "dtype"), ("non-contiguous", "not contiguous"),
    ("shape", "shape"), ("kind", "kind"), ("dir_bits 0", "dir_bits"),
    ("dir_bits 10", "dir_bits")])
def test_m1_launcher_refuses_bad_input(fault, match):
    """M1's launcher refuses CPU tensors, another dtype, a non-contiguous
    or misshapen input, an unknown key kind and ``dir_bits`` outside 1..9
    with ``ValueError``, before it asks for its library."""
    launches = km.cuda_library.launches
    with pytest.raises(ValueError, match=match):
        km.morton_keys_cuda(**_bad_inputs(fault))
    assert km.cuda_library.launches == launches


@pytest.mark.parametrize("dir_bits", [0, 10])
def test_dir_bits_out_of_range_raise_on_the_plain_path(dir_bits):
    o, d = rand_rays_np(300, seed=2)
    rays = make_rays(o, d, device="cpu")
    with pytest.raises(ValueError, match="dir_bits"):
        pm._keys_6d(rays, LO, HI, dir_bits=dir_bits)
    with pytest.raises(ValueError, match="dir_bits"):
        pm.sort_perm_6d(rays, LO, HI, dir_bits=dir_bits)


def test_cpu_keys_never_build_or_load_the_kernel(monkeypatch):
    """CPU rays take the plain versions: the keyed sorts and key functions
    neither build nor load M1's library and count no launch; their keys
    are int32."""
    from messyerraytracer_tpu_torch import native

    def refuse(*a, **k):
        raise AssertionError("M1's library was asked for")

    launches, lib = km.cuda_library.launches, km.cuda_library.lib
    monkeypatch.setattr(km, "cuda_library", refuse)
    monkeypatch.setattr(native, "build_shared_library", refuse)
    o, d = rand_rays_np(512, seed=3)
    rays = make_rays(o, d, device="cpu")
    live = live_flags("mixed", 512, 4)
    pm.sort_perm_6d(rays, LO, HI, live=live)
    pm.sort_rays_6d(rays, LO, HI, octant_major=False)
    pm.sort_rays_by_direction(rays)
    for keys in (pm.sort_keys_6d(rays, LO, HI, live=live),
                 pm.ray_6d_morton(rays.origin, rays.direction, LO, HI),
                 pm.ray_direction_morton(rays.direction)):
        assert keys.dtype == torch.int32
    monkeypatch.undo()
    assert km.cuda_library.launches == launches
    assert km.cuda_library.lib is lib   # None unless a card test loaded it


# ---- the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dir_bits", VARIANTS)
def test_card_keys_and_sorts_equal_the_plain_path(kind, dir_bits):
    """M1's keys equal the plain version's bit for bit, on the card and on
    the CPU, for N of 1, 255, 256 and 524,289, live flags absent, all
    live, mixed and all dead, random rays with +-0, +-1, NaN and +-inf
    components, origins on, in and outside the box, and a box with an
    axis of zero extent; the keyed sorts give the plain path's permutation
    and sorted rays."""
    dev = _card()
    for n in (1, 255, 256, 524_289):
        o, d = rays_with_specials(n, seed=n)
        cpu = make_rays(o, d, device="cpu")
        card = cpu.to(dev)
        for lo, hi in ((LO, HI), (LO, FLAT_HI)):
            box = (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))
            for mode in ("absent", "all live", "mixed", "all dead"):
                live = live_flags(mode, n, n + 7)
                live_d = None if live is None else live.to(dev)
                got = km.morton_keys_cuda(card.origin, card.direction, *box,
                                          kind, dir_bits, live_d)
                assert got.dtype == torch.int32
                want = plain_keys(card, *box, kind, dir_bits, live_d)
                assert torch.equal(got, want), (n, mode, lo, hi)
                assert torch.equal(got.cpu(), plain_keys(
                    cpu, lo, hi, kind, dir_bits, live)), (n, mode, lo, hi)
                perm = torch.sort(want, stable=True).indices
                if kind == km.DIRECTION:
                    if live is not None or hi is FLAT_HI:
                        continue
                    srt, p = pm.sort_rays_by_direction(card)
                else:
                    kw = dict(octant_major=kind == km.OCTANT_MAJOR,
                              dir_bits=dir_bits)
                    assert torch.equal(
                        pm.sort_perm_6d(card, *box, live=live_d, **kw), perm)
                    if live is not None:
                        continue
                    srt, p = pm.sort_rays_6d(card, *box, **kw)
                assert torch.equal(p, perm)
                ref = card.take(perm)
                for f in ("origin", "direction", "t_min", "t_max"):
                    assert torch.equal(bits(getattr(srt, f)),
                                       bits(getattr(ref, f))), f


def run_isolated(check: str) -> None:
    """Run this module's function ``check`` in a fresh interpreter, from
    the repository root.  Profiler sessions and the sync debug mode are
    the process's: run in the test process, a check would share them with
    every other card test there.  Fails with the child's output unless it
    exits 0."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.path.join(root, "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import test_torch_morton_kernel as t; t.{check}()"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]


def check_no_host_sync():
    """Keying rays whose box is on the card waits for nothing on the host:
    no sync, no host to device copy."""
    dev = torch.device("cuda")
    o, d = rand_rays_np(4096, seed=5)
    rays = make_rays(o, d, device=dev)
    box = (torch.from_numpy(LO).to(dev), torch.from_numpy(HI).to(dev))
    live = live_flags("mixed", 4096, 6).to(dev)
    km.cuda_library()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pm.sort_keys_6d(rays, *box, live=live)
        pm.sort_keys_6d(rays, *box, octant_major=False)
        pm.ray_6d_morton(rays.origin, rays.direction, *box)
        pm.ray_direction_morton(rays.direction)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def check_keyed_sort_spans():
    """Each keyed sort on the card launches M1 once.  Under the profiler
    the launch is linked to ``key.launch`` inside ``morton.key``, no range
    beneath ``morton.key`` starts with ``morton.`` (``dispatch_ms`` sums
    those ranges' device time, a parent's included), none of the plain
    version's stages opens, and ``key.kernel_rays`` reads the rays
    keyed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from messyerraytracer_tpu_torch.utils import trace

    dev = torch.device("cuda")
    n = 65_536
    o, d = rand_rays_np(n, seed=8)
    rays = make_rays(o, d, device=dev)
    box = (torch.from_numpy(LO).to(dev), torch.from_numpy(HI).to(dev))
    live = live_flags("mixed", n, 9).to(dev)
    sorts = (lambda: pm.sort_perm_6d(rays, *box, live=live),
             lambda: pm.sort_rays_6d(rays, *box),
             lambda: pm.sort_rays_6d(rays, *box, octant_major=False),
             lambda: pm.sort_rays_by_direction(rays))
    for sort in sorts:
        launches = km.cuda_library.launches
        sort()
        assert km.cuda_library.launches == launches + 1
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for sort in sorts:
            sort()
        torch.cuda.synchronize()
    assert trace.counters().get("key.kernel_rays") == len(sorts) * n
    events = prof.events()
    m1 = [e for e in events if e.device_type == DeviceType.CUDA
          and "morton_keys" in e.name]
    launch = [e for e in events if e.name == "key.launch"]
    assert len(m1) == len(launch) == len(sorts)
    assert all(len(e.kernels) == 1 and "morton_keys" in e.kernels[0].name
               for e in launch)
    for e in launch:
        up = e.cpu_parent
        while up is not None and up.name != "morton.key":
            up = up.cpu_parent
        assert up is not None, "key.launch outside morton.key"

    def beneath(e):
        for c in e.cpu_children:
            yield c
            yield from beneath(c)

    keys = [e for e in events if e.name == "morton.key"]
    assert len(keys) == len(sorts)
    for e in keys:
        assert not [c.name for c in beneath(e)
                    if c.name.startswith("morton.")]
    names = {e.name for e in events}
    assert not {"key.quantize", "key.spread", "key.merge"} & names


@pytest.mark.gpu
def test_card_keys_make_no_host_sync():
    """``check_no_host_sync`` in a process of its own (the sync debug mode
    is the process's)."""
    _card()
    run_isolated("check_no_host_sync")


@pytest.mark.gpu
def test_card_keyed_sort_is_one_launch_linked_to_its_span():
    """``check_keyed_sort_spans`` in a process of its own, as its first
    profiler session."""
    _card()
    run_isolated("check_keyed_sort_spans")


def test_keys_fit_below_dead_key():
    """Every kind's largest key lies below ``DEAD_KEY``, so dead rays sort
    last: octant-major keys below 2^28 at every dir_bits, origin-major and
    direction keys below 2^30 (the plain version at the box's far
    corner and the all-ones direction)."""
    o = np.float32([HI, LO, HI])
    d = np.float32([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
                    [-0.5, -0.5, -0.5]])
    rays = make_rays(o, d, device="cpu")
    for b in range(1, km.MAX_DIR_BITS + 1):
        keys = pm.sort_keys_6d(rays, LO, HI, dir_bits=b)
        assert int(keys.max()) == (1 << 28) - 1, b
    assert int(pm.ray_6d_morton(rays.origin, rays.direction, LO,
                                HI).max()) == (1 << 30) - 1
    assert int(pm.ray_direction_morton(rays.direction).max()) == (
        (1 << 30) - 1)
    assert pm.DEAD_KEY > (1 << 30) - 1
    assert np_of(pm.sort_perm_6d(rays, LO, HI, live=torch.tensor(
        [False, True, True]))).tolist()[-1] == 0
