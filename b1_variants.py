"""Kernel B1's design variants, timed in one process on one CUDA card.

    git show <commit>:messyerraytracer_tpu_torch/kernels/csrc/cluster_cast.cu \\
        > scratch_checkout/cluster_cast_old.cu
    python3 b1_variants.py --old-src scratch_checkout/cluster_cast_old.cu

Builds every variant with its own nvcc, all started together, from copies
written under the package's build directory (``_build/variants``):

  * ``old``: the one-thread-per-ray kernel that intersects each cluster at
    the pop that finds it (--old-src: kernels/csrc/cluster_cast.cu as it
    was before the postponed design, whose C entry has no warp_stats);
  * ``old+count``: the same source with two atomics before its cluster
    visit that add the visit and the lanes of the warp active at it
    (``__activemask``): its lane occupancy, and its time with the atomics;
  * ``postponed``: today's source with the cooperative mode compiled out;
  * ``shipped``: the package's own build;
  * ``r=x``: today's source with the switch point's r set to x, for each
    x of --r.

Then, on the headline scene and block-swizzled 1080p frame of
messyerraytracer_tpu_torch/bench.py, for the instanced T=64 tables, the
flat T=64 tables and flat tables cut at T=32: every variant's outputs
equal the old kernel's bit for bit (hits, per-ray counters, pops,
stack_drops); kernel ms by CUDA events, the
variants in turn for --rounds rounds (order reversed every other round),
median and quartiles; lane occupancy of the cluster phase (wanting lanes
/ (32 x passes)) and cooperative pairs per ray from a counting launch; the
bound as chip_smoke.py computes it.  Prints one line per frame and
variant, then one JSON object with every number (also written to --out).
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

# (line of the source, what it becomes), each line found exactly once
OLD_VISIT = "          intersect_cluster<INST>(s, code[c] >> 1,"
OLD_COUNT = (
    "          { const unsigned am = __activemask();\n"
    "            if ((int)(threadIdx.x & 31) == __ffs(am) - 1) {\n"
    "              atomicAdd(&counters[2], 1ull);\n"
    "              atomicAdd(&counters[3], (unsigned long long)__popc(am));"
    "\n            } }\n" + OLD_VISIT)
COOP = "const bool coop = (float)nwant * coop_cost < (float)s.tcap;"
NO_COOP = "const bool coop = false;"
COOP_R = "constexpr float kCoopR = 4.f;"


def patched(src: str, line: str, new: str, path: str) -> str:
    """Write ``src`` with its one ``line`` replaced by ``new`` to ``path``."""
    if src.count(line) != 1:
        raise SystemExit(f"no single line {line!r} to patch for {path}")
    with open(path, "w") as f:
        f.write(src.replace(line, new))
    return path


def build_variants(old_src: str, rs: list[float], out_dir: str):
    """{name: (library, is_old)}, one nvcc each, started together."""
    from messyerraytracer_tpu_torch.kernels import cluster_v2
    from messyerraytracer_tpu_torch.native import (NVCC_FLAGS,
                                                   build_shared_library,
                                                   nvcc)

    os.makedirs(out_dir, exist_ok=True)
    with open(old_src) as f:
        old = f.read()
    with open(cluster_v2.cuda_library.source) as f:
        new = f.read()
    out = lambda name: os.path.join(out_dir, name)        # noqa: E731
    jobs = [("old", old_src, True),
            ("old+count", patched(old, OLD_VISIT, OLD_COUNT,
                                  out("old_counted.cu")), True),
            ("postponed", patched(new, COOP, NO_COOP, out("postponed.cu")),
             False)]
    jobs += [(f"r={r}", patched(new, COOP_R, f"constexpr float kCoopR = "
                                f"{r}f;", out(f"r{r}.cu")), False)
             for r in rs]
    paths, errors = {}, []

    def build(name, source):
        try:
            if name == "shipped":
                cluster_v2.cuda_library()
            else:
                paths[name] = build_shared_library(
                    [nvcc()] + NVCC_FLAGS, [source],
                    os.path.join("variants",
                                 os.path.basename(source)[:-3] + ".so"))
        except Exception as e:     # re-raised below, in the main thread
            errors.append(e)

    jobs.append(("shipped", None, False))
    t0 = time.time()
    threads = [threading.Thread(target=build, args=(name, source))
               for name, source, _ in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"built {len(jobs)} variants in {time.time() - t0} s", flush=True)
    libs = {}
    for name, _, is_old in [jobs[-1]] + jobs[:-1]:
        lib = (cluster_v2.cuda_library() if name == "shipped"
               else cluster_v2.cuda_library.load(paths[name]))
        if is_old:                 # the earlier C entry has no warp_stats
            at = list(lib.mrt_cluster_cast.argtypes)
            del at[-2]
            lib.mrt_cluster_cast.argtypes = at
        libs[name] = (lib, is_old)
    return libs


def launch(name, lib, is_old, args, rays, stats=None):
    """One launch; returns (fout, iout, counters[:2]) and adds to ``stats``
    [passes, wanting lanes, cooperative pairs]."""
    import torch

    dev, n = rays.origin.device, rays.count
    fout = torch.empty((6, n), dtype=torch.float32, device=dev)
    iout = torch.empty((5, n), dtype=torch.int32, device=dev)
    counters = torch.zeros(4 if is_old else 2, dtype=torch.int64, device=dev)
    tail = [fout.data_ptr(), iout.data_ptr(), counters.data_ptr()]
    if not is_old:
        tail.append(None if stats is None else stats.data_ptr())
    err = lib.mrt_cluster_cast(*args, *tail,
                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
    if is_old and stats is not None:
        stats[:2] += counters[2:]
    return fout, iout, counters[:2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--r", type=float, nargs="*",
                    default=[-0.9, 1.0, 2.0, 3.0, 6.0, 8.0],
                    help="switch-point r values to build besides the "
                         "shipped one (-0.9: always cooperative)")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--out", help="also write the JSON object here")
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("b1_variants.py needs a CUDA card")
    import chip_smoke as smoke
    from messyerraytracer_tpu_torch import bench
    from messyerraytracer_tpu_torch.kernels import cluster_v2
    from messyerraytracer_tpu_torch.kernels.cluster import (
        build_cluster_scene)
    from messyerraytracer_tpu_torch.native import BUILD_DIR
    from messyerraytracer_tpu_torch.scene.scene import (
        build_scene_from_tri_array)

    card = bench.card_name_and_power()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    libs = build_variants(a.old_src, a.r, os.path.join(BUILD_DIR, "variants"))
    tlas, _ = bench.headline_tlas(dev)
    flat = build_scene_from_tri_array(tlas._world_tris_np(), device=dev)
    frames = [("instanced T=64", tlas._ctlas), ("flat T=64", flat.cluster),
              ("flat T=32", build_cluster_scene(flat.bvh, flat.tris,
                                                tcap=32))]
    rays = bench.block_swizzled_frame_rays(*bench.FRAME,
                                           bench.headline_camera(), dev)
    n = rays.count
    result = {"card": card, "rays": n, "frames": {}}
    for fname, cs in frames:
        args = cluster_v2._kernel_args(rays.origin, rays.direction,
                                       rays.t_min, rays.t_max, cs)
        ref = launch("old", *libs["old"], args, rays)
        bms, by = smoke.cluster_bound(cs, rays, *ref)
        rows = {}
        for name, (lib, is_old) in libs.items():
            st = torch.zeros(3, dtype=torch.int64, device=dev)
            out = launch(name, lib, is_old, args, rays, st)
            torch.cuda.synchronize()
            for x, y, what in zip(out, ref, ("fout", "iout", "counters")):
                smoke.check(torch.equal(x, y),
                            f"{fname} {name}: {what} == old kernel's")
            st = [int(x) for x in st.tolist()]
            rows[name] = {"ms": [], "passes": st[0], "wanting": st[1],
                          "coop_pairs": st[2],
                          "occupancy": smoke.occupancy(st),
                          "coop_pairs_per_ray": st[2] / n}
        for rnd in range(a.rounds):
            order = list(libs.items())
            for name, (lib, is_old) in (order if rnd % 2 == 0
                                        else order[::-1]):
                rows[name]["ms"].append(smoke.cuda_ms(
                    lambda: launch(name, lib, is_old, args, rays), 5))
        for name, row in rows.items():
            q25, med, q75 = np.percentile(row["ms"], [25, 50, 75])
            row.update(median_ms=float(med), q25_ms=float(q25),
                       q75_ms=float(q75))
            print(f"[{card}] {fname} {name}: kernel {med} ms [{q25}, {q75}]"
                  f", lane occupancy {row['occupancy']}, cooperative "
                  f"pairs/ray {row['coop_pairs_per_ray']}, bound {bms} ms "
                  f"({by})", flush=True)
        result["frames"][fname] = {"bound_ms": bms, "bound_by": by,
                                   "tcap": cs.tcap, "variants": rows}
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
