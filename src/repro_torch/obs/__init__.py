"""repro_torch.obs: the port's flight recorder, a copy of the JAX
package's `repro.obs` with the same metric and span names.

Three pieces, all mergeable and all removable:

  * `MetricsRegistry` (obs/registry.py): counters, gauges, pow2-bucketed
    latency histograms with p50/p95/p99 extraction; registries merge
    (per-bucket integer addition).
  * `span` / `instant` tracing (obs/trace.py): Chrome trace-event JSON via
    `export_trace(path)`, loadable in Perfetto; `runtime.faultinject`
    crash-point crossings appear as instant events.
  * exporters: `snapshot()`, `render_prom()` (Prometheus text format), and
    the `QueryEngine.stats()` facade built on them.

The on/off contract: REPRO_OBS=0 (or "false"/"off") in the environment
disables the whole layer at import.  Disabled, `new_registry()` returns
the shared `NULL_REGISTRY` (all instruments are constant no-ops) and
`span`/`instant` are rebound to no-op closures: instrumented code answers
bit-identically and pays one attribute lookup plus an empty call per
site.  `configure(enabled)` flips the switch at runtime for tests; call
sites must access `obs.span` through the module attribute for the rebind
to take effect.
"""

from __future__ import annotations

import os

from repro_torch.obs import trace as _trace_mod
from repro_torch.obs.registry import (Counter, Gauge,  # noqa: F401
                                      Histogram, MetricsRegistry,
                                      NULL_REGISTRY, NullRegistry)
from repro_torch.obs.trace import (TRACE_CAPACITY,  # noqa: F401
                                   clear_trace, export_trace, trace_events)
from repro_torch.runtime import faultinject as _faultinject

__all__ = [
    "MetricsRegistry", "NullRegistry", "NULL_REGISTRY",
    "Counter", "Gauge", "Histogram",
    "span", "instant", "export_trace", "clear_trace", "trace_events",
    "enabled", "configure", "new_registry", "get_registry", "render_prom",
    "snapshot", "TRACE_CAPACITY",
]


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _noop_span(name, **args):
    return _NULL_SPAN


def _noop_instant(name, **args):
    return None


_enabled = os.environ.get("REPRO_OBS", "1").strip().lower() not in (
    "0", "false", "off")
_default_registry: MetricsRegistry | None = None

# rebound by configure(); import-time defaults set at the bottom
span = _noop_span
instant = _noop_instant


def enabled() -> bool:
    return _enabled


def configure(on: bool) -> None:
    """Flip the module switch at runtime (tests; production uses the
    REPRO_OBS env var read at import).  Registries already handed out keep
    their mode: only objects created AFTER the flip see it."""
    global _enabled, span, instant
    _enabled = bool(on)
    if _enabled:
        span = _trace_mod.span
        instant = _trace_mod.instant
        _faultinject.set_observer(_crash_point_instant)
    else:
        span = _noop_span
        instant = _noop_instant
        _faultinject.set_observer(None)


def _crash_point_instant(point: str) -> None:
    """faultinject observer: each crash-point crossing becomes an instant
    event, so delivery boundaries are visible inside the spans around
    them in the exported trace."""
    _trace_mod.instant("crash_point", point=point)


def new_registry() -> MetricsRegistry | NullRegistry:
    """A fresh registry under the current switch: what QueryEngine builds
    its per-engine registry from (NULL_REGISTRY when disabled)."""
    return MetricsRegistry() if _enabled else NULL_REGISTRY


def get_registry() -> MetricsRegistry | NullRegistry:
    """The process-default registry (created on first use), for module
    code with no engine to hang metrics on.  Engines keep their own
    registries; merge them into this one for a process-wide view."""
    global _default_registry
    if not _enabled:
        return NULL_REGISTRY
    if _default_registry is None:
        _default_registry = MetricsRegistry()
    return _default_registry


def render_prom(registry=None) -> str:
    """Prometheus text format of `registry` (default: the process-default
    registry)."""
    return (registry if registry is not None else get_registry()
            ).render_prom()


def snapshot(registry=None) -> dict:
    """Plain-dict snapshot of `registry` (default: the process-default)."""
    return (registry if registry is not None else get_registry()).snapshot()


configure(_enabled)
