"""Bounded two-class admission queue with explicit backpressure.

The port's copy of the JAX package's `repro.serve.admission`.  The front
door admits requests into per-class bounded queues ("interactive" and
"bulk") instead of letting callers pile work onto the engine.  Overload
surfaces as a typed `RejectedError` at the door, with a retry-after hint
derived from the observed drain rate, rather than as unbounded queueing.

Shedding policy (bulk before interactive):
  * interactive is admitted while its own queue has room;
  * bulk is admitted only while its own queue has room AND interactive
    occupancy is below `bulk_headroom * interactive_limit`.

Dispatch order mirrors the policy: `take_group` always prefers an
interactive leader.  Every admit/reject decision is counted
(`frontdoor_admitted_total`, `frontdoor_rejected_total` with a `reason`
label), and queue depths are live gauges.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from repro_torch.obs.registry import NULL_REGISTRY

CLASS_INTERACTIVE = "interactive"
CLASS_BULK = "bulk"
CLASSES = (CLASS_INTERACTIVE, CLASS_BULK)

# sliding window (seconds) over which the drain rate is measured for
# retry-after hints; short enough to track load shifts, long enough to
# smooth over individual flushes
_DRAIN_WINDOW_S = 5.0
_RETRY_AFTER_MIN_S = 0.01
_RETRY_AFTER_MAX_S = 5.0
# hint when nothing has drained yet (cold start / stalled engine)
_RETRY_AFTER_DEFAULT_S = 0.1


class RejectedError(RuntimeError):
    """Backpressure: the request was NOT admitted and will never be
    answered.  `retry_after_s` is the door's estimate of when capacity
    will exist, derived from current depth over the observed drain
    rate; `reason` is "full" (the class queue is at its limit), "shed"
    (bulk turned away to protect interactive headroom), or "closed"."""

    def __init__(self, cls: str, reason: str, retry_after_s: float):
        self.cls = cls
        self.reason = reason
        self.retry_after_s = retry_after_s
        super().__init__(
            f"{cls} request rejected ({reason}); "
            f"retry after {retry_after_s:.3f}s")


class AdmissionQueue:
    """Bounded FIFO per class, one condition variable for the
    dispatcher.  All state transitions happen under a single lock; the
    lock is never held across engine work."""

    def __init__(self, *, interactive_limit: int = 256,
                 bulk_limit: int = 256, bulk_headroom: float = 0.5,
                 registry=None):
        if interactive_limit < 1 or bulk_limit < 0:
            raise ValueError("queue limits must be positive")
        if not 0.0 < bulk_headroom <= 1.0:
            raise ValueError("bulk_headroom must be in (0, 1]")
        self.limits = {CLASS_INTERACTIVE: int(interactive_limit),
                       CLASS_BULK: int(bulk_limit)}
        # interactive occupancy at/above which bulk is shed outright
        self._shed_bar = max(1, int(bulk_headroom * interactive_limit))
        self.cond = threading.Condition()
        self._q: dict[str, list] = {c: [] for c in CLASSES}
        self._closed = False
        self._drained: deque = deque()  # (t_monotonic, n) drain events

        reg = NULL_REGISTRY if registry is None else registry
        self._c_admit = {c: reg.counter("frontdoor_admitted_total", cls=c)
                         for c in CLASSES}
        self._c_reject = {
            (c, why): reg.counter("frontdoor_rejected_total",
                                  cls=c, reason=why)
            for c in CLASSES for why in ("full", "shed", "closed")}
        for c in CLASSES:
            reg.gauge_fn("frontdoor_queue_depth",
                         lambda c=c: float(len(self._q[c])), cls=c)
        reg.gauge_fn("frontdoor_drain_rate", self.drain_rate)

    # ---- caller side -------------------------------------------------
    def offer(self, req) -> None:
        """Admit `req` or raise `RejectedError`.  Never blocks."""
        cls = req.cls
        with self.cond:
            if self._closed:
                self._reject(cls, "closed", 0.0)
            depth_i = len(self._q[CLASS_INTERACTIVE])
            if cls == CLASS_INTERACTIVE:
                if depth_i >= self.limits[cls]:
                    self._reject(cls, "full", self._retry_after(depth_i))
            else:
                depth_b = len(self._q[CLASS_BULK])
                if depth_b >= self.limits[cls]:
                    self._reject(cls, "full", self._retry_after(depth_b))
                if depth_i >= self._shed_bar:
                    # shed bulk before interactive: interactive pressure
                    # has eaten bulk's headroom
                    self._reject(cls, "shed", self._retry_after(depth_i))
            self._q[cls].append(req)
            self._c_admit[cls].inc()
            self.cond.notify_all()

    def _reject(self, cls: str, reason: str, retry_after_s: float):
        self._c_reject[(cls, reason)].inc()
        raise RejectedError(cls, reason, retry_after_s)

    # ---- dispatcher side ---------------------------------------------
    def take_group(self, max_rows: int):
        """Block until work exists (or the queue is closed AND empty —
        then None).  Pops an interactive-preferred leader plus every
        queued request sharing its coalesce key, up to `max_rows` total
        query rows, preserving per-class FIFO order."""
        with self.cond:
            while not (self._q[CLASS_INTERACTIVE] or self._q[CLASS_BULK]):
                if self._closed:
                    return None
                self.cond.wait(0.05)
            if self._q[CLASS_INTERACTIVE]:
                lead = self._q[CLASS_INTERACTIVE].pop(0)
            else:
                lead = self._q[CLASS_BULK].pop(0)
            group = [lead]
            self._collect_locked(group, lead.key, max_rows)
            return group

    def collect_matching(self, group: list, key, max_rows: int) -> int:
        """Non-blocking top-up of an in-flight group with newly arrived
        requests sharing `key`.  Returns how many were added."""
        with self.cond:
            return self._collect_locked(group, key, max_rows)

    def _collect_locked(self, group: list, key, max_rows: int) -> int:
        added = 0
        rows = sum(r.rows for r in group)
        for cls in CLASSES:  # interactive first
            keep = []
            for r in self._q[cls]:
                if r.key == key and rows + r.rows <= max_rows:
                    group.append(r)
                    rows += r.rows
                    added += 1
                else:
                    keep.append(r)
            self._q[cls] = keep
        return added

    def wait_for_arrival(self, timeout_s: float) -> None:
        with self.cond:
            if not (self._q[CLASS_INTERACTIVE] or self._q[CLASS_BULK]):
                self.cond.wait(max(0.0, timeout_s))

    def note_drained(self, n: int, now: float | None = None) -> None:
        """Record that `n` requests left the queue and were answered —
        feeds the drain rate behind retry-after hints."""
        t = time.monotonic() if now is None else now
        with self.cond:
            self._drained.append((t, n))
            cutoff = t - _DRAIN_WINDOW_S
            while self._drained and self._drained[0][0] < cutoff:
                self._drained.popleft()

    def drain_rate(self) -> float:
        """Observed drain rate, requests/second over the recent window."""
        t = time.monotonic()
        with self.cond:
            cutoff = t - _DRAIN_WINDOW_S
            total = sum(n for ts, n in self._drained if ts >= cutoff)
        return total / _DRAIN_WINDOW_S

    def _retry_after(self, depth: int) -> float:
        rate = self.drain_rate()
        if rate <= 0.0:
            return _RETRY_AFTER_DEFAULT_S
        return min(_RETRY_AFTER_MAX_S,
                   max(_RETRY_AFTER_MIN_S, (depth + 1) / rate))

    # ---- lifecycle ---------------------------------------------------
    def depth(self, cls: str | None = None) -> int:
        with self.cond:
            if cls is not None:
                return len(self._q[cls])
            return sum(len(q) for q in self._q.values())

    def close(self) -> None:
        """Stop admitting; already-admitted requests stay queued for the
        dispatcher to drain (no acked request is dropped at shutdown)."""
        with self.cond:
            self._closed = True
            self.cond.notify_all()
