"""Spans, counters and a request log of the port, recorded only while a
``torch.profiler`` is recording.

The upstream times each phase of a frame on the host and logs stalls
(``src/modules/graphics/ray_renderer.cpp:244-278``) and keeps per-cast
counters that merge by addition (``RayStats``, ``src/core/stats.h:20-55``).
The port's counterparts, with one switch for all three, whether a
profiler records (``torch.autograd._profiler_enabled()``):

  * ``span(name)``: a named profiler range while the profiler records,
    else one shared no-op context.  Names are fixed strings, never an id,
    so that a trace's ranges add up by name.  The range is an operator's
    (``_RecordFunctionFast``, the range PyTorch's own Triton launcher
    opens around each launch), not a ``record_function`` one, for two
    reasons: the profiler links a kernel to the innermost operator that
    launched it, and a ``record_function`` range is no operator (its scope
    is the user's), so a kernel launched through ctypes directly inside
    one (kernels B1 and B4) is linked to no range, whatever runtime
    launched it; and it costs a seventh of the host time under the profiler
    (2.2 against 15-16 us a range on the host of an H100 machine);
  * ``count(name, value)``: adds a Python int to a named counter, or
    holds a 0-d tensor for it as it is (no sync and no device work while
    counting: the held tensors are summed when read); ``counters()``
    reads them all as Python numbers (one sync a device), ``reset()``
    clears them and the request log;
  * ``request_span(name, request_id)``: a span that also appends
    ``(request_id, name, start_ns, end_ns)`` to the request log, on
    ``time.time_ns()``, the clock of the profiler's own event times;
    ``requests()`` returns the log, which keeps the newest
    ``REQUEST_LOG_MAX`` entries.

The state is the process's, as the profiler's is.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

REQUEST_LOG_MAX = 65536
HELD_MAX = 4096     # held tensors of one counter and device before a sum

_RANGE = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_COUNTERS: dict = {}    # name -> Python number
_HELD: dict = {}        # (name, device) -> 0-d tensors not yet summed
_LOG: collections.deque = collections.deque(maxlen=REQUEST_LOG_MAX)


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A profiler range ``name``, which the kernels launched directly
    inside it are linked to, while the profiler records; else a shared
    no-op context."""
    return _RANGE(name) if recording() else _OFF


class _RequestSpan:
    """The range ``name``, with its interval logged under ``request_id``
    (taken inside the range, so its own enter and exit are left out)."""

    __slots__ = ("name", "request_id", "range", "start_ns")

    def __init__(self, name: str, request_id: int):
        self.name, self.request_id = name, request_id
        self.range = _RANGE(name)

    def __enter__(self):
        self.range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self.range.__exit__(*exc)
        _LOG.append((self.request_id, self.name, self.start_ns, end_ns))
        return False


def request_span(name: str, request_id: int):
    """``span(name)`` that also logs its interval under ``request_id``."""
    return _RequestSpan(name, request_id) if recording() else _OFF


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d tensor, held and summed when read)
    to the counter ``name`` while the profiler records."""
    if not recording():
        return
    with _LOCK:
        if not isinstance(value, torch.Tensor):
            _COUNTERS[name] = _COUNTERS.get(name, 0) + value
            return
        held = _HELD.setdefault((name, value.device), [])
        held.append(value)
        if len(held) >= HELD_MAX:
            held[:] = [torch.stack([v.reshape(()) for v in held]).sum()]


def counters() -> dict:
    """Every counter as a Python number; held tensors are read in one
    transfer a device."""
    by_dev = collections.defaultdict(list)
    with _LOCK:
        out = dict(_COUNTERS)
        for (name, dev), vs in _HELD.items():
            by_dev[dev] += [(name, v) for v in vs]
    for pairs in by_dev.values():
        vals = torch.stack([v.reshape(()) for _, v in pairs]).tolist()
        for (name, _), v in zip(pairs, vals):
            out[name] = out.get(name, 0) + v
    return out


def requests() -> list:
    """The request log, oldest first: (request_id, name, start_ns,
    end_ns)."""
    return list(_LOG)


def reset() -> None:
    """Clear the counters and the request log."""
    with _LOCK:
        _COUNTERS.clear()
        _HELD.clear()
        _LOG.clear()
