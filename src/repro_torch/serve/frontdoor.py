"""Overload-tolerant serving front door for the sketch index.

The port's copy of the JAX package's `repro.serve.frontdoor`.  `FrontDoor`
wraps a live `repro_torch.index.QueryEngine` and serves concurrent bursty
traffic:

  * Coalescing: concurrent `topk`/`radius`/`assign` requests are grouped
    by (op, parameter, input layout) and flushed as ONE engine call.
    `assign` is served as top-1 and coalesces with `topk(k=1)`.
  * Deadline-aware flush: a partly filled batch flushes when it fills,
    when the oldest member has waited `max_wait_ms`, or at
    `oldest_deadline - service_estimate` (EWMA per op), whichever comes
    first.
  * Admission control / backpressure: a bounded two-class queue
    (interactive vs bulk) rejects excess load at the door with
    `RejectedError` carrying a retry-after derived from the observed
    drain rate; bulk is shed before interactive (serve.admission).
  * Graceful degradation: a request's deadline propagates into the banded
    top-k walk (`QueryEngine.topk_budgeted`): an over-deadline request gets
    back the best candidates found in budget with `partial=True` and the
    residual certificate gap.  `partial=False` answers are bit-identical
    to the synchronous engine's.
  * Fault tolerance: enqueue/flush/publish are faultinject crash points;
    flush-side failures retry with bounded exponential backoff, and a
    set-once result latch per request guarantees every admitted request is
    answered exactly once.

Threading model: callers admit from any thread; ONE dispatcher thread owns
the engine's query path (the engine itself stays single-threaded; the
front door is the serialization point) and drives it on the engine's
device: queries are moved to `engine.device` at submit, so a coalesced
batch is one tensor there.  Engine mutations keep the single-writer
discipline; interleave them through quiesced windows, not concurrently
with serving.  `close()` drains the admitted requests and joins the
dispatcher.

Every decision (admit, reject, shed, timeout, retry, partial) is recorded
under `frontdoor_*` instruments in the engine's registry; the invariant
counters (`answered`, `double_answers`) are also plain fields, live under
REPRO_OBS=0.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import on_device
from repro_torch.runtime import faultinject
from repro_torch.serve.admission import (CLASS_BULK, CLASS_INTERACTIVE,
                                         CLASSES, AdmissionQueue,
                                         RejectedError)
from repro_torch.serve.deadline import Deadline, ServiceEstimator

__all__ = ["FrontDoor", "ServeResult", "Request", "RejectedError",
           "FrontDoorClosed", "Deadline",
           "CLASS_INTERACTIVE", "CLASS_BULK"]

_CP_ENQUEUE = faultinject.declare("frontdoor.enqueue")
_CP_FLUSH = faultinject.declare("frontdoor.flush")
_CP_PUBLISH = faultinject.declare("frontdoor.publish")

_OPS = ("topk", "radius", "assign")


class FrontDoorClosed(RuntimeError):
    """submit() after close(): the door no longer accepts work."""


@dataclass
class ServeResult:
    """One request's answer.

    topk: `ids` (rows, k') / `dists` (rows, k'); a partial answer can
    leave slots unfilled (id -1, dist inf).  assign: `ids`/`dists` are
    (rows,).  radius: `hits` is a list of per-query id arrays.

    `partial=True` means the deadline stopped the band walk before its
    exactness certificate closed; `cert_gap` is the residual gap (0.0 on
    exact answers, inf when the budget ran out before k candidates were
    even seen).  `timed_out` marks answers degraded by
    an expired deadline (admission-time expiry or radius-at-flush);
    `error` carries the terminal exception when retries were exhausted.
    """

    ids: np.ndarray | None = None
    dists: np.ndarray | None = None
    hits: list | None = None
    partial: bool = False
    cert_gap: float = 0.0
    timed_out: bool = False
    error: BaseException | None = None
    queued_ms: float = 0.0
    service_ms: float = 0.0
    latency_ms: float = 0.0

    @property
    def ok(self) -> bool:
        return self.error is None


class Request:
    """Handle for one admitted request: a set-once result latch.

    `resolve` is idempotent by construction (first caller wins, later
    calls are counted, not applied) — the exactly-once answer guarantee
    under retries hangs on this.
    """

    __slots__ = ("op", "cls", "queries", "fmt", "rows", "param", "deadline",
                 "t_submit", "t_flush", "_event", "_result", "_lock")

    def __init__(self, op, cls, queries, fmt, rows, param, deadline):
        self.op = op
        self.cls = cls
        self.queries = queries
        self.fmt = fmt
        self.rows = rows
        self.param = param
        self.deadline = deadline
        self.t_submit = time.monotonic()
        self.t_flush = None
        self._event = threading.Event()
        self._result: ServeResult | None = None
        self._lock = threading.Lock()

    @property
    def key(self):
        """Coalescing key: requests sharing it can flush as one engine
        call.  assign rides the topk(k=1) bucket."""
        op = "topk" if self.op == "assign" else self.op
        return (op, self.param, self.fmt)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def resolve(self, result: ServeResult) -> bool:
        """Latch `result` if unanswered; False (and no effect) if a
        result was already published."""
        with self._lock:
            if self._result is not None:
                return False
            result.latency_ms = (time.monotonic() - self.t_submit) * 1e3
            if self.t_flush is not None:
                result.queued_ms = (self.t_flush - self.t_submit) * 1e3
            self._result = result
        self._event.set()
        return True

    def result(self, timeout: float | None = None) -> ServeResult:
        """Block until the answer is published.  Admitted requests are
        always answered (worst case: an error result after retries or at
        close); `timeout` is the caller's own patience, raising
        TimeoutError without consuming the eventual answer."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"{self.op} request not answered "
                               f"within {timeout}s")
        return self._result


@dataclass
class _Group:
    """One coalesced flush in the making."""

    key: tuple
    members: list = field(default_factory=list)

    @property
    def rows(self) -> int:
        return sum(m.rows for m in self.members)


class FrontDoor:
    """Thread-safe serving facade over a `QueryEngine` (see module doc).

    Parameters
    ----------
    engine : repro_torch.index.QueryEngine
        The wrapped engine.  The front door becomes the only caller of
        its query path, on the engine's device (`engine.device`).
    interactive_limit / bulk_limit / bulk_headroom :
        Admission bounds (serve.admission.AdmissionQueue).
    max_batch_rows : flush when a coalesced group reaches this many
        query rows.
    max_wait_ms : max time the oldest member of a group waits for
        coalescing company before flushing anyway.
    default_service_ms / safety : service-estimate prior and the margin
        factor applied when comparing a deadline against the estimate.
    max_retries / backoff_ms : bounded exponential-backoff retry for
        flush-side failures (attempt i sleeps backoff_ms * 2**i).
    """

    def __init__(self, engine, *, interactive_limit: int = 256,
                 bulk_limit: int = 256, bulk_headroom: float = 0.5,
                 max_batch_rows: int = 64, max_wait_ms: float = 2.0,
                 default_service_ms: float = 20.0, safety: float = 1.25,
                 max_retries: int = 3, backoff_ms: float = 1.0,
                 registry=None):
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        self.engine = engine
        self.device = engine.device
        self.obs = engine.obs if registry is None else registry
        self.queue = AdmissionQueue(
            interactive_limit=interactive_limit, bulk_limit=bulk_limit,
            bulk_headroom=bulk_headroom, registry=self.obs)
        self.estimator = ServiceEstimator(default_ms=default_service_ms)
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_s = max_wait_ms / 1e3
        self.safety = float(safety)
        self.max_retries = int(max_retries)
        self.backoff_s = backoff_ms / 1e3
        # invariant counters: plain fields (live under REPRO_OBS=0) that
        # the chaos/soak assertions read; obs counters mirror them
        self.answered = 0
        self.double_answers = 0
        self._n_lock = threading.Lock()

        reg = self.obs
        self._c_answered = {c: reg.counter("frontdoor_answered_total", cls=c)
                            for c in CLASSES}
        self._c_timeout = {c: reg.counter("frontdoor_timeouts_total", cls=c)
                           for c in CLASSES}
        self._c_partial = {c: reg.counter("frontdoor_partials_total", cls=c)
                           for c in CLASSES}
        self._c_retries = reg.counter("frontdoor_retries_total")
        self._c_faults = reg.counter("frontdoor_faults_total")
        self._c_double = reg.counter("frontdoor_double_answers_total")
        self._c_flushes = reg.counter("frontdoor_flushes_total")
        self._h_rows = reg.histogram("frontdoor_flush_rows")
        self._h_wait = reg.histogram("frontdoor_queue_wait_ms")
        self._h_service = {op: reg.histogram("frontdoor_service_ms", op=op)
                           for op in ("topk", "radius")}
        self._h_e2e = {c: reg.histogram("frontdoor_latency_ms", cls=c)
                       for c in CLASSES}

        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="frontdoor-dispatch")
        self._thread.start()

    # -- caller side ---------------------------------------------------------

    def submit(self, op: str, queries, *, k: int | None = None,
               r: float | None = None, cls: str = CLASS_INTERACTIVE,
               timeout_ms: float | None = None, deadline=None) -> Request:
        """Admit a request; returns its `Request` handle immediately.

        Raises `RejectedError` (backpressure — NOT admitted, safe to
        retry after `retry_after_s`) or `FrontDoorClosed`.  `timeout_ms`
        builds a `Deadline` relative to now; pass `deadline` directly
        for an absolute one.  A deadline already expired at admission is
        answered on the spot with an empty partial result — it is never
        enqueued (zero-timeout contract: `timeout_ms=0` is an explicit
        "only if free" probe)."""
        if not self._running:
            raise FrontDoorClosed("front door is closed")
        if op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}, got {op!r}")
        if cls not in CLASSES:
            raise ValueError(f"cls must be one of {CLASSES}, got {cls!r}")
        queries, fmt, rows = self._normalize(queries)
        if op == "radius":
            if r is None:
                raise ValueError("radius requires r")
            param: object = float(r)
        else:
            param = 1 if op == "assign" else int(k if k is not None else 10)
            if param < 0:
                raise ValueError(f"k must be >= 0, got {param}")
        if deadline is None and timeout_ms is not None:
            deadline = Deadline(timeout_ms)
        req = Request(op, cls, queries, fmt, rows, param, deadline)
        if rows == 0:
            # empty batch: answer inline (trivially exact), nothing to
            # coalesce — mirrors the engine's own empty fast path
            self._publish(req, self._empty_result(req, partial=False))
            return req
        if deadline is not None and deadline.expired:
            self._c_timeout[cls].inc()
            self._publish(req, self._empty_result(req, partial=True,
                                                  timed_out=True))
            return req
        faultinject.crash_point(_CP_ENQUEUE)
        self.queue.offer(req)  # RejectedError propagates to the caller
        return req

    def topk(self, queries, k: int = 10, **kw) -> ServeResult:
        return self.submit("topk", queries, k=k, **kw).result()

    def radius(self, queries, r: float, **kw) -> ServeResult:
        return self.submit("radius", queries, r=r, **kw).result()

    def assign(self, queries, **kw) -> ServeResult:
        """Nearest stored id per query (top-1), coalesced with topk(1)."""
        return self.submit("assign", queries, **kw).result()

    # -- request plumbing ----------------------------------------------------

    def _normalize(self, queries):
        """-> (queries, fmt, rows).  Dense rows become a (rows, n_dims)
        tensor, COO pairs an (indices, values) pair of tensors, on the
        engine's device (numpy or torch in).  Shape errors surface here,
        at submit, not on the dispatcher thread."""
        if isinstance(queries, (tuple, list)):
            idx, val = queries
            idx = on_device(idx, self.device)
            val = on_device(val, self.device)
            if idx.ndim != 2 or idx.shape != val.shape:
                raise ValueError("COO input needs matching (rows, m) "
                                 "indices/values")
            return (idx, val), "coo", idx.shape[0]
        x = on_device(queries, self.device)
        if x.ndim != 2:
            raise ValueError(
                f"expected dense (rows, n_dims), got {tuple(x.shape)}")
        return x, "dense", x.shape[0]

    def _empty_result(self, req: Request, *, partial: bool,
                      timed_out: bool = False,
                      error: BaseException | None = None) -> ServeResult:
        gap = float("inf") if partial else 0.0
        if req.op == "radius":
            return ServeResult(hits=[np.zeros(0, np.int64)] * req.rows,
                               partial=partial, cert_gap=gap,
                               timed_out=timed_out, error=error)
        if req.op == "assign":
            return ServeResult(ids=np.full(req.rows, -1, np.int64),
                               dists=np.full(req.rows, np.inf, np.float32),
                               partial=partial, cert_gap=gap,
                               timed_out=timed_out, error=error)
        return ServeResult(ids=np.zeros((req.rows, 0), np.int64),
                           dists=np.zeros((req.rows, 0), np.float32),
                           partial=partial, cert_gap=gap,
                           timed_out=timed_out, error=error)

    def _publish(self, req: Request, res: ServeResult) -> None:
        if req.resolve(res):
            with self._n_lock:
                self.answered += 1
            self._c_answered[req.cls].inc()
            self._h_e2e[req.cls].observe(res.latency_ms)
            if res.partial:
                self._c_partial[req.cls].inc()
        else:
            with self._n_lock:
                self.double_answers += 1
            self._c_double.inc()

    # -- dispatcher ----------------------------------------------------------

    def _loop(self) -> None:
        while True:
            members = self.queue.take_group(self.max_batch_rows)
            if members is None:
                return  # closed and drained
            group = _Group(members[0].key, members)
            try:
                self._fill_window(group)
                self._flush(group)
            except BaseException as e:  # includes InjectedCrash leaks
                # the dispatcher must survive anything: answer the
                # still-unanswered members with an error result rather
                # than orphaning them (only this thread resolves admitted
                # requests, so `done` cannot flip under us here)
                for m in group.members:
                    if not m.done:
                        self._publish(m, self._empty_result(
                            m, partial=True, error=e))
            self.queue.note_drained(len(group.members))

    def _flush_due(self, group: _Group, now: float) -> float:
        """Earliest of: oldest arrival + max_wait, any member's
        deadline minus the (safety-scaled) service estimate."""
        due = min(m.t_submit for m in group.members) + self.max_wait_s
        op = group.key[0]
        est_s = self.estimator.estimate_ms(op) / 1e3 * self.safety
        for m in group.members:
            d = m.deadline
            if d is None:
                continue
            rem = (d.remaining_s() if hasattr(d, "remaining_s")
                   else (0.0 if d.expired else None))
            if rem is not None:
                due = min(due, now + rem - est_s)
        return due

    def _fill_window(self, group: _Group) -> None:
        """Hold a non-full group briefly so arrivals can coalesce —
        bounded by batch-fill, max_wait, and member deadlines."""
        while group.rows < self.max_batch_rows:
            now = time.monotonic()
            due = self._flush_due(group, now)
            if now >= due:
                return
            self.queue.wait_for_arrival(min(due - now, 0.005))
            self.queue.collect_matching(group.members, group.key,
                                        self.max_batch_rows)

    def _flush(self, group: _Group) -> None:
        """Partition by deadline pressure, run, publish.

        Members whose remaining budget clears the service estimate run
        as one EXACT batch (bit-identical to the synchronous engine);
        the rest share a budgeted call under the tightest deadline, so a
        straggler degrades to a certified-partial answer instead of
        dragging exact traffic past its own deadlines."""
        t_flush = time.monotonic()
        for m in group.members:
            m.t_flush = t_flush
            self._h_wait.observe((t_flush - m.t_submit) * 1e3)
        self._c_flushes.inc()
        self._h_rows.observe(group.rows)
        op = group.key[0]
        est_s = self.estimator.estimate_ms(op) / 1e3 * self.safety
        exact, budgeted = [], []
        for m in group.members:
            d = m.deadline
            if d is None:
                exact.append(m)
            else:
                rem = (d.remaining_s() if hasattr(d, "remaining_s")
                       else (0.0 if d.expired else est_s + 1.0))
                (exact if rem > est_s else budgeted).append(m)
        if exact:
            self._run_members(group.key, exact, deadline=None)
        if budgeted:
            if op == "radius":
                # radius has no budgeted walk: run members still inside
                # their deadline exactly, time out the already-expired
                live = [m for m in budgeted if not m.deadline.expired]
                for m in budgeted:
                    if m not in live:
                        self._c_timeout[m.cls].inc()
                        self._publish(m, self._empty_result(
                            m, partial=True, timed_out=True))
                if live:
                    self._run_members(group.key, live, deadline=None)
            else:
                tightest = min(budgeted, key=self._remaining).deadline
                self._run_members(group.key, budgeted, deadline=tightest)

    @staticmethod
    def _remaining(m: Request) -> float:
        d = m.deadline
        return (d.remaining_s() if hasattr(d, "remaining_s")
                else (0.0 if d.expired else float("inf")))

    def _run_members(self, key, members: list, deadline) -> None:
        """One engine call for `members`, with crash points, bounded
        retry, and exactly-once publication."""
        op, param, fmt = key
        queries = self._concat([m.queries for m in members], fmt)
        attempt = 0
        out = None
        err: BaseException | None = None
        while True:
            try:
                with obs.span("frontdoor.flush", op=op,
                              rows=sum(m.rows for m in members)):
                    faultinject.crash_point(_CP_FLUSH)
                    t0 = time.perf_counter()
                    out = self._call_engine(op, param, queries, deadline)
                    service_ms = (time.perf_counter() - t0) * 1e3
                    faultinject.crash_point(_CP_PUBLISH)
                err = None
                break
            except (Exception, faultinject.InjectedCrash) as e:
                self._c_faults.inc()
                err = e
                if attempt >= self.max_retries:
                    break
                # a member may have expired during the failed attempt;
                # budgeted members re-run under the same deadline object,
                # so the retry sees the truth, not a stale snapshot
                self._c_retries.inc()
                time.sleep(self.backoff_s * (2 ** attempt))
                attempt += 1
        if err is not None:
            for m in members:
                self._publish(m, self._empty_result(m, partial=True,
                                                    error=err))
            return
        self.estimator.observe("topk" if op == "assign" else op, service_ms)
        self._h_service["topk" if op == "assign" else op].observe(service_ms)
        self._distribute(op, members, out)

    def _concat(self, parts: list, fmt: str):
        if len(parts) == 1:
            return parts[0]
        if fmt == "dense":
            return torch.cat(parts, dim=0)
        width = max(p[0].shape[1] for p in parts)

        def padw(a):  # value 0 pads: those slots sketch to nothing
            return torch.nn.functional.pad(a, (0, width - a.shape[1]))

        return (torch.cat([padw(p[0]) for p in parts], dim=0),
                torch.cat([padw(p[1]) for p in parts], dim=0))

    def _call_engine(self, op: str, param, queries, deadline):
        if op == "radius":
            return self.engine.radius(queries, param), None
        if deadline is None:
            ids, dists = self.engine.topk(queries, param)
            return (ids, dists), {"partial": False, "cert_gap": 0.0}
        ids, dists, info = self.engine.topk_budgeted(queries, param,
                                                     deadline=deadline)
        return (ids, dists), info

    def _distribute(self, op: str, members: list, out) -> None:
        payload, info = out
        partial = bool(info["partial"]) if info is not None else False
        gap = float(info["cert_gap"]) if info is not None else 0.0
        lo = 0
        for m in members:
            hi = lo + m.rows
            if op == "radius":
                res = ServeResult(hits=payload[lo:hi])
            else:
                ids, dists = payload[0][lo:hi], payload[1][lo:hi]
                if m.op == "assign":
                    if ids.shape[1] == 0:  # empty store: nothing to assign
                        ids = np.full(m.rows, -1, np.int64)
                        dists = np.full(m.rows, np.inf, np.float32)
                    else:
                        ids, dists = ids[:, 0].copy(), dists[:, 0].copy()
                res = ServeResult(ids=ids, dists=dists, partial=partial,
                                  cert_gap=gap)
            if partial:
                res.timed_out = m.deadline is not None and m.deadline.expired
            self._publish(m, res)
            lo = hi

    # -- lifecycle -----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "queue_depth": {c: self.queue.depth(c) for c in CLASSES},
            "drain_rate": self.queue.drain_rate(),
            "service_estimate_ms": self.estimator.snapshot(),
            "answered": self.answered,
            "double_answers": self.double_answers,
        }

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, drain already-admitted requests, stop the
        dispatcher.  Idempotent."""
        self._running = False
        self.queue.close()
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
