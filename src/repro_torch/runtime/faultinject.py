"""Fault injection: named crash points that turn "recovers from a crash
anywhere" into an enumerable property.  The port's copy of the JAX
package's `repro.runtime.faultinject`, with the same API, environment
variables and point names.

Every durability- or delivery-critical code path gets a NAMED crash point::

    _CP_COMPACT = faultinject.declare("store.compact")
    ...
    faultinject.crash_point(_CP_COMPACT)

`declare` runs at import time, so the set of points is enumerable
(`registered_points()`) without executing any path.  The port declares
the points of the modules it has: ``store.compact`` (index/store.py) and
``frontdoor.enqueue`` / ``frontdoor.flush`` / ``frontdoor.publish``
(serve/frontdoor.py).

Two trigger mechanisms:

  * programmatic: `arm(name)` / the `armed(name)` context manager make the
    next hit of that point raise `InjectedCrash` (a BaseException subclass,
    so no library `except Exception` can swallow it).  The point disarms on
    fire: one arm, one crash.
  * environment: set REPRO_CRASH_POINT=<name> (and optionally
    REPRO_CRASH_MODE=exit) before starting a subprocess: the first hit of
    that point calls os._exit(EXIT_CODE), an un-catchable process death
    with no atexit/finally cleanup.  Only a child process should be armed
    this way; a test process armed in "exit" mode dies with it.

When nothing is armed, `crash_point` is a single global-is-None check.
Triggers are process-wide module state rather than contextvars because
crash points fire from helper threads too (the front door's dispatcher),
and contextvars do not propagate into `threading.Thread` targets.
"""

from __future__ import annotations

import contextlib
import os
import threading

EXIT_CODE = 17  # distinguishes an injected kill from any real failure

_ENV_POINT = "REPRO_CRASH_POINT"
_ENV_MODE = "REPRO_CRASH_MODE"

_registry: set[str] = set()
_armed: str | None = None
_armed_mode: str = "raise"
# serializes the disarm-and-fire transition: with the front door's real
# threads, several callers can cross the same armed point concurrently,
# and "one arm, one crash" must mean exactly one of them dies
_fire_lock = threading.Lock()
_record = False  # hit recording is test-only: a server must not grow a log
_hits: list[str] = []  # points crossed while recording was on, in order
_observer = None  # repro_torch.obs hook: every crossing becomes an instant


class InjectedCrash(BaseException):
    """Raised (not Exception: nothing may swallow it) at an armed point."""

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


def declare(name: str) -> str:
    """Register a crash-point name (idempotent) and return it."""
    _registry.add(name)
    return name


def registered_points() -> tuple[str, ...]:
    """All declared crash points, sorted."""
    return tuple(sorted(_registry))


def arm(name: str, mode: str = "raise") -> None:
    """Arm `name`: its next `crash_point` hit fires once, then disarms.
    mode "raise" raises InjectedCrash; mode "exit" calls os._exit."""
    global _armed, _armed_mode
    if name not in _registry:
        raise ValueError(f"unknown crash point {name!r}; "
                         f"registered: {registered_points()}")
    if mode not in ("raise", "exit"):
        raise ValueError(f"mode must be 'raise' or 'exit', got {mode!r}")
    with _fire_lock:
        _armed, _armed_mode = name, mode


def disarm() -> None:
    global _armed
    with _fire_lock:
        _armed = None


@contextlib.contextmanager
def armed(name: str, mode: str = "raise"):
    """Context manager form of arm(); always disarms on exit."""
    arm(name, mode)
    try:
        yield
    finally:
        disarm()


def record_hits(enabled: bool = True) -> None:
    """Toggle hit recording (off by default)."""
    global _record
    _record = enabled


def hits() -> tuple[str, ...]:
    """Crash points crossed while recording was enabled, in order."""
    return tuple(_hits)


def clear_hits() -> None:
    del _hits[:]


def set_observer(fn) -> None:
    """Install `fn(name)` to run at every crash-point crossing (None to
    remove).  The observer runs BEFORE any armed crash fires."""
    global _observer
    _observer = fn


def crash_point(name: str) -> None:
    """Die here iff `name` is armed (programmatically or via env)."""
    global _armed
    if _record:
        _hits.append(name)
    if _observer is not None:
        _observer(name)
    if _armed is not None and name == _armed:
        with _fire_lock:
            if _armed != name:
                return  # another thread won the race and already fired
            _armed = None  # one arm, one crash
            mode = _armed_mode
        if mode == "exit":
            os._exit(EXIT_CODE)
        raise InjectedCrash(name)


# env trigger, picked up once at import: a subprocess test sets
# REPRO_CRASH_POINT before exec'ing the child
if os.environ.get(_ENV_POINT):
    _armed = os.environ[_ENV_POINT]
    _armed_mode = os.environ.get(_ENV_MODE, "exit")
