"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy time (the union of its kernel and copy
intervals), device time per ``record_function`` range, kernel B1's
launches, the device operations that took most time, and the idle gaps by
what the host was doing.

The arithmetic is that of the repo's ``chip_smoke.py::device_split``.  B1
is launched through ctypes, so the profiler may not link its launches to
the range they ran in: every B1 launch of the port runs inside its
``cast`` range, so B1's time is read by kernel name and counted apart
from each range's linked time.
"""

from __future__ import annotations

import bisect
import collections

B1_KERNEL = "cluster_cast_kernel"
HARNESS_PREFIX = "raybench."
TOP = 10


def _linked(e, cache):
    """(non-B1 us, B1 us) of the kernels launched under event ``e``."""
    key = id(e)
    if key not in cache:
        nb = b1 = 0.0
        for k in e.kernels:
            if B1_KERNEL in k.name:
                b1 += k.duration
            else:
                nb += k.duration
        for c in e.cpu_children:
            cn, cb = _linked(c, cache)
            nb, b1 = nb + cn, b1 + cb
        cache[key] = (nb, b1)
    return cache[key]


class Digest:
    """What one traced slice of the window holds.

    ``ranges[name]``: {"count", "device_us" (linked, B1 left out),
    "host_us"}; ``b1_us``: the duration of each B1 launch; ``busy_us``;
    ``wall_s`` (host clock around the slice) and ``units`` (units of work
    in it)."""

    def __init__(self, events, wall_s: float, units: int):
        from torch.autograd import DeviceType

        self.wall_s, self.units = wall_s, units
        host = [e for e in events if e.device_type == DeviceType.CPU]
        ranges = {e.name for e in host}     # a range's device-side twin
        dev = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and e.name not in ranges)
        self.b1_us = [b - a for a, b, n in dev if B1_KERNEL in n]
        busy, reach, gaps = 0.0, float("-inf"), []
        for a, b, _ in dev:
            if a > reach and reach != float("-inf"):
                gaps.append((reach, a))
            if b > reach:
                busy += b - max(a, reach)
                reach = b
        self.busy_us = busy
        cache = {}
        self.ranges = collections.defaultdict(
            lambda: {"count": 0, "device_us": 0.0, "host_us": 0.0})
        for e in host:
            r = self.ranges[e.name]
            r["count"] += 1
            r["device_us"] += _linked(e, cache)[0]
            r["host_us"] += e.time_range.end - e.time_range.start
        self.ranges = dict(self.ranges)
        self.b1_linked_us = sum(_linked(e, cache)[1] for e in host
                                if e.cpu_parent is None)
        by_op = collections.Counter()
        for a, b, n in dev:
            by_op[n] += (b - a) / 1e6
        self.device_ops = [[n, s] for n, s in by_op.most_common(TOP)]
        self.idle_gaps = self._label_gaps(gaps, host)

    @staticmethod
    def _label_gaps(gaps, host):
        """Idle seconds summed by what the host was doing when each gap
        began: the harness range open then, and the innermost event."""
        host = sorted(host, key=lambda e: e.time_range.start)
        starts = [e.time_range.start for e in host]
        outer = [e for e in host if e.name.startswith(HARNESS_PREFIX)]
        ostarts = [e.time_range.start for e in outer]
        by = collections.Counter()
        for a, b in gaps:
            i = bisect.bisect_right(ostarts, a) - 1
            top = (outer[i].name if i >= 0 and outer[i].time_range.end >= a
                   else "between units")
            j = bisect.bisect_right(starts, a) - 1
            inner = "python"
            for e in host[max(j - 64, 0):j + 1][::-1]:
                if e.time_range.end >= a and e.name != top:
                    inner = e.name
                    break
            by[f"{top}/{inner}"] += (b - a) / 1e6
        return [[n, s] for n, s in by.most_common(TOP)]

    def device_ms(self, name: str) -> float | None:
        """Linked device ms of the range ``name`` (B1 left out), or None
        when the slice holds no such range."""
        r = self.ranges.get(name)
        return None if r is None else r["device_us"] / 1e3

    def device_ms_prefix(self, prefix: str) -> float | None:
        hits = [r["device_us"] for n, r in self.ranges.items()
                if n.startswith(prefix)]
        return sum(hits) / 1e3 if hits else None

    def count(self, name: str) -> int:
        return self.ranges.get(name, {"count": 0})["count"]

    @property
    def b1_ms(self) -> float:
        return sum(self.b1_us) / 1e3

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6
