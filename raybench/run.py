"""Command line of the benchmark:

    python3 -m raybench --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on one CUDA card and prints the result
as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
also printed as the last lines of standard error.  Exits non-zero, with
no result, without a CUDA card (or with fewer cards than the cell asks
for), without the program, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM = "messyerraytracer_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "messyerraytracer_tpu")


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m raybench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def fail(msg: str, code: int = 2) -> int:
    print(f"[raybench] error: {msg}", file=sys.stderr, flush=True)
    return code


def main(t0: float | None = None, argv=None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    spec_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(os.path.join(ROOT, PROGRAM, "__init__.py")):
        return fail(f"the program ({PROGRAM}/) is not in {ROOT}")
    with open(spec_path) as f:
        spec = json.load(f)
    import torch

    from raybench import harness

    try:
        cell = harness.cell_spec(spec, args.workload)
    except KeyError as e:
        return fail(str(e))
    if not torch.cuda.is_available():
        return fail("no CUDA card (torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"the cell needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} visible")
    torch.set_num_threads(4)
    result, extras = harness.run_cell(spec, args.workload, args.seed,
                                      args.seconds, bool(args.trace),
                                      torch.device("cuda", 0), t0)
    found = banned_modules()
    if found:
        return fail(f"JAX or the JAX package was loaded: {found}", 3)
    harness.say(f"check details: {json.dumps(extras['details'])}")
    for name, c in result["checks"].items():
        print(f"[raybench] check {name} = {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
