"""Readings that the limits of ``reference/limits.json`` are set from:

    python3 -m raybench.tools.controls --workload <cell> --seeds 1 2 3 \\
        [--seconds 3] [--out chiprun_out/controls.jsonl]

For each seed, one run of the cell as the benchmark makes it (set-up, a
short window at the cell's own load, the check), then the control: the
plain reference put in the program's place in bfloat16, judged the same
way on the same kept units.  Writes one JSON line per seed: the program's
numbers and the control's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def main(argv=None) -> int:
    from raybench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default="chiprun_out/controls.jsonl")
    a = p.parse_args(argv)
    with open(os.path.join(os.path.dirname(harness.HERE),
                           "BENCHMARK.json")) as f:
        spec = json.load(f)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    for seed in a.seeds:
        t0 = time.perf_counter()
        res, ex = harness.run_cell(spec, a.workload, seed, a.seconds, False,
                                   torch.device("cuda", 0), t0, control=True)
        line = {"workload": a.workload, "seed": seed,
                "program": {n: c["value"] for n, c in res["checks"].items()},
                "control": ex["control"], "details": ex["details"],
                "control_details": ex["control_details"],
                "reference_s": ex.get("reference_s"),
                "metrics": res["metrics"]}
        print(json.dumps(line), flush=True)
        with open(a.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
