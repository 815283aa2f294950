"""On the card: one short run of a cell from the command line reads
correct.  Marked ``gpu``; it skips where there is no card (decided inside
the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT, SEED


@pytest.mark.gpu
def test_primary_frames_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "raybench", "--workload",
         "instanced_1m.primary_1080p", "--seed", str(SEED), "--seconds",
         "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
