"""One run of one cell: set-up, the measured window, the traced slice,
the check against the plain reference, and the result line.

Everything that belongs to a cell is found by name: the configuration in
``configs/<config>.json`` (its ``recipe`` in ``scenes/<recipe>.py``), the
traffic mix in ``traffic/<traffic>.json`` (its ``kind`` in
``kinds/<kind>.py``), and each metric's reader in ``metrics/<name>.py``
(or that of the name before its first dot).

With ``--trace 1`` the profiler first starts a third into the window; the
units before it run as in an untraced window (``ctx.phase`` is
"window"), those from then on are "traced".
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
import types

import numpy as np
import torch

from raybench.reference.judge import LIMITS

HERE = os.path.dirname(os.path.abspath(__file__))
TRACE_AFTER = 1.0 / 3.0     # the traced slice starts a third into the window
TRACE_SECONDS = 2.0         # and lasts this long (at least TRACE_MIN units)
TRACE_MIN = 3


def say(msg: str) -> None:
    print(f"[raybench] {msg}", file=sys.stderr, flush=True)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    """Import the module at ``path`` under ``name`` (file names may hold
    dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, or else that of
    the name before its first dot, so that one quantity read in cells
    that report different end-to-end metrics (``epilogue_ms``,
    ``epilogue_ms.submit``) has one reader."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    if not os.path.exists(path):
        metric = metric.split(".")[0]
        path = os.path.join(HERE, "metrics", metric + ".py")
    return load_file(path, "raybench_metric_" + metric.replace(".", "_"))


def merged(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def seed_int(seed: int) -> int:
    """A nonnegative 63-bit seed for numpy and torch generators."""
    return int(seed) % (1 << 63)


class Reservoir:
    """Which units of the window to keep for the check: ``k`` units drawn
    uniformly from all of them, from the seed (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed_int(seed), 0x5A])

    def slot(self, i: int):
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cell_spec(spec: dict, workload: str):
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({', '.join(cells)})")
    return cells[workload]


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's metrics: end-to-end without trace, per-layer with."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float, overrides: dict | None = None,
             control: bool = False) -> tuple[dict, dict]:
    """Run the cell; returns (the result object, extras: the check's
    details and, with ``control``, the control's numbers judged the same
    way).  ``overrides`` ({"config": {...}, "traffic": {...}}) cut the
    sizes for rehearsals on the CPU."""
    cell = cell_spec(spec, workload)
    over = overrides or {}
    cfg = merged(load_json(HERE, "configs", cell["config"] + ".json"),
                 over.get("config"))
    traffic = merged(load_json(HERE, "traffic", cell["traffic"] + ".json"),
                     over.get("traffic"))
    device = torch.device(device)
    recipe = importlib.import_module(f"raybench.scenes.{cfg['recipe']}")
    kind = importlib.import_module(f"raybench.kinds.{traffic['kind']}")
    inputs = recipe.make(cfg["scene"])
    ctx = types.SimpleNamespace(cfg=cfg, traffic=traffic, seed=int(seed),
                                device=device, inputs=inputs, trace=trace,
                                phase="set-up")
    t_in = time.perf_counter() - t0
    work = kind.Work(ctx)
    t_built = time.perf_counter() - t0
    k = int(traffic["sample_units"])
    for j in range(k + 1):          # warm-up; holds k units like the window
        work.unit(j, j if j < k else None)
    sync(device)
    work.kept.clear()
    setup_s = time.perf_counter() - t0
    say(f"{workload}: set-up {setup_s} s (imports and inputs {t_in} s, "
        f"the cell built {t_built} s, of which the scene {work.build_s} "
        f"s; warm-up {k + 1} units)")

    keep = Reservoir(k, seed)
    lat, rays = [], []
    prof = traced = None    # traced: (profiler, wall s, units) once closed
    slice_t0 = slice_units = 0  # a trace run goes on until its slice is whole
    gc.collect()
    gc.disable()
    ctx.phase = "window"    # "traced" from the profiler's first start on
    start = time.perf_counter()
    i = 0
    try:
        while True:
            now = time.perf_counter()
            if now - start >= seconds and (traced is not None or not trace):
                break
            if trace and prof is None and traced is None \
                    and now - start >= seconds * TRACE_AFTER:
                ctx.phase = "traced"
                _profiler_start_up(work, i, device)
                prof = _profiler(device)
                prof.start()
                slice_t0, slice_units = time.perf_counter(), 0
            u0 = time.perf_counter()
            n = work.unit(i, keep.slot(i))
            sync(device)
            lat.append(time.perf_counter() - u0)
            rays.append(n)
            i += 1
            if prof is not None:
                slice_units += 1
                if (time.perf_counter() - slice_t0 >= TRACE_SECONDS
                        and slice_units >= TRACE_MIN):
                    wall = time.perf_counter() - slice_t0
                    prof.stop()
                    traced, prof = (prof, wall, slice_units), None
        window_s = time.perf_counter() - start
    finally:
        gc.enable()
        ctx.phase = "check"
    rays = [int(r) for r in rays]
    say(f"{workload}: {i} units in {window_s} s, {sum(rays)} rays")

    dev_info = device_info(device)
    digest = None
    if traced is not None:
        from raybench.trace import Digest

        digest = Digest(traced[0].events(), traced[1], traced[2])
        traced = None
        dev_info.update(busy_s=digest.busy_s, window_s=digest.wall_s)
        say(f"{workload}: traced {digest.units} units in {digest.wall_s} s, "
            f"device busy {digest.busy_s} s, B1 launches "
            f"{len(digest.b1_us)} ({digest.b1_ms} ms, linked to a range: "
            f"{digest.b1_linked_us / 1e3} ms); ranges "
            f"{json.dumps(named_ranges(digest))}")
    work.release()
    r0 = time.perf_counter()
    numbers, details = work.judge(control=False)
    extras = {"details": details, "reference_s": time.perf_counter() - r0}
    say(f"{workload}: reference check {extras['reference_s']} s")
    if control:
        extras["control"], extras["control_details"] = work.judge(
            control=True)
    limits = {n: LIMITS[n] for n in numbers}
    correct = all(numbers[n] <= limits[n] for n in numbers)

    mctx = types.SimpleNamespace(
        cell=workload, seconds=window_s, units=i, rays=sum(rays),
        latencies=lat, setup_s=setup_s, build_s=work.build_s,
        stats=work.stats(), trace=digest, here=os.path.join(HERE, "metrics"),
        device=dev_info)
    metrics = {}
    for m in metrics_for(spec, workload, trace):
        v = reader(m["name"]).read(mctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": i, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if digest is not None:
        result["breakdown"] = {"device_ops": digest.device_ops,
                               "idle_gaps": digest.idle_gaps}
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]}
                        for n in numbers}
    return result, extras


def named_ranges(digest) -> dict:
    """The harness's and the port's own ranges of a trace (no ops)."""
    return {n: r for n, r in digest.ranges.items()
            if "::" not in n and not n.startswith("cuda")}


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _profiler_start_up(work, i: int, device) -> None:
    """The profiler's own start-up, once, around one unit of work that is
    not the window's, so that the traced slice holds none of it."""
    prof = _profiler(device)
    prof.start()
    work.unit(i, None)
    sync(device)
    prof.stop()


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": card_power_limit()}


def card_power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
