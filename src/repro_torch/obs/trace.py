"""span() tracing: Chrome trace-event JSON out of the serving hot paths.

The port's copy of the JAX package's `repro.obs.trace`.  Spans are
recorded as "X" (complete) events: one dict per span with a microsecond
start timestamp and duration, keyed by (pid, tid).  Perfetto /
chrome://tracing reconstruct nesting per thread from ts/dur containment,
so concurrent threads (the front door's dispatcher and its callers) land
on separate tracks.  `instant()` records zero-duration "i" events; the
faultinject observer routes every crash-point crossing here.

The buffer is a bounded deque (64k events, oldest dropped).  Export with
`export_trace(path)`: the file is the standard `{"traceEvents": []}` JSON
object, loadable in https://ui.perfetto.dev.

Spans time the host: a CUDA kernel launched inside a span may still run
after it closes, unless the span's work ends in a copy to the host (every
index query does).

This module always records when called; the REPRO_OBS=0 gating lives in
`repro_torch.obs.__init__`, which rebinds the public `span`/`instant`
names to no-op closures so disabled call sites never reach here.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

TRACE_CAPACITY = 1 << 16

_events: deque = deque(maxlen=TRACE_CAPACITY)
# one origin per process: Chrome trace ts is relative anyway, and
# perf_counter deltas from a fixed origin keep spans from different
# threads on one consistent clock
_T0 = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("name", "args", "_ts")

    def __init__(self, name: str, args: dict | None):
        self.name = name
        self.args = args

    def __enter__(self):
        self._ts = _now_us()
        return self

    def __exit__(self, *exc):
        ev = {
            "name": self.name, "ph": "X", "ts": self._ts,
            "dur": _now_us() - self._ts,
            "pid": os.getpid(), "tid": threading.get_ident(),
        }
        if self.args:
            ev["args"] = self.args
        _events.append(ev)
        return False


def span(name: str, **args) -> _Span:
    """Trace the `with` block as a named span (extra kwargs become the
    event's `args`, visible in the Perfetto detail pane)."""
    return _Span(name, args or None)


def instant(name: str, **args) -> None:
    """Record a zero-duration instant event (thread scope)."""
    ev = {
        "name": name, "ph": "i", "s": "t", "ts": _now_us(),
        "pid": os.getpid(), "tid": threading.get_ident(),
    }
    if args:
        ev["args"] = args
    _events.append(ev)


def export_trace(path: str) -> int:
    """Write the buffered events as Chrome trace-event JSON; returns the
    number of events written.  The buffer is NOT cleared — export is a
    read, `clear_trace()` is the reset."""
    evs = list(_events)
    with open(path, "w") as f:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, f)
    return len(evs)


def clear_trace() -> None:
    _events.clear()


def trace_events() -> list[dict]:
    """The buffered events (a copy) — for tests and in-process tooling."""
    return list(_events)
