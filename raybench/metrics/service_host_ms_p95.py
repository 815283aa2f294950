"""95th percentile of the host ms per batch inside the service, outside
its stream sync, over the traced slice's requests (as
``service_host_ms.py`` reads them)."""

import os

import numpy as np

from raybench.harness import load_file

_HOST = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "service_host_ms.py"),
                  "raybench_metric_service_host_ms")


def read(ctx):
    ms = _HOST.intervals(ctx)
    return None if ms is None else float(np.percentile(ms, 95))
