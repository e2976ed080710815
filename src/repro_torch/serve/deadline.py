"""Deadlines and service-time estimation for the serving front door.

The port's copy of the JAX package's `repro.serve.deadline`.  A
`Deadline` is a point on the monotonic clock; everything downstream
(admission, flush planning, the budgeted band walk in
`core.allpairs.topk_rows_banded`) only ever asks two questions of it,
`expired` and `remaining_s()`, so tests can substitute any object with
those attributes to script knife-edge timings (e.g. "expires after the
second band round") without sleeping.

`ServiceEstimator` keeps a per-op EWMA of observed flush service times.
The front door uses it to answer "if I flush now, when will the result
land?": the flush trigger is `oldest_deadline - estimate`, so the
estimate must exist before the first flush (a configurable prior) and
must keep working under REPRO_OBS=0, where the obs histograms are null.
"""

from __future__ import annotations

import threading
import time


class Deadline:
    """A monotonic-clock deadline.

    Construct with a relative budget (`Deadline(timeout_ms=5.0)`) or an
    absolute instant on the same clock (`Deadline(at=t)`).  `clock` is
    injectable for tests; it must be monotonic and in seconds.
    """

    __slots__ = ("t", "clock")

    def __init__(self, timeout_ms: float | None = None, *,
                 at: float | None = None, clock=time.monotonic):
        if (timeout_ms is None) == (at is None):
            raise ValueError("pass exactly one of timeout_ms / at")
        self.clock = clock
        self.t = float(at) if at is not None else clock() + timeout_ms / 1e3

    @property
    def expired(self) -> bool:
        return self.clock() >= self.t

    def remaining_s(self) -> float:
        """Seconds until expiry; negative once past it."""
        return self.t - self.clock()

    def remaining_ms(self) -> float:
        return self.remaining_s() * 1e3

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Deadline(remaining_ms={self.remaining_ms():.3f})"


class ServiceEstimator:
    """Per-op EWMA of flush service time, in milliseconds.

    Starts from a conservative prior (`default_ms`) so the very first
    flush decision is already deadline-aware; `alpha` trades tracking
    speed against noise (per-flush service time is lumpy because batch
    sizes vary).  Thread-safe: observed from the dispatcher thread, read
    from caller threads for retry-after hints.
    """

    def __init__(self, default_ms: float = 20.0, alpha: float = 0.25):
        if default_ms <= 0:
            raise ValueError("default_ms must be positive")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.default_ms = float(default_ms)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._ewma: dict[str, float] = {}

    def observe(self, op: str, service_ms: float) -> None:
        if service_ms < 0:
            return
        with self._lock:
            prev = self._ewma.get(op)
            if prev is None:
                self._ewma[op] = float(service_ms)
            else:
                self._ewma[op] = prev + self.alpha * (service_ms - prev)

    def estimate_ms(self, op: str) -> float:
        with self._lock:
            return self._ewma.get(op, self.default_ms)

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._ewma)
