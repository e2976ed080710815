"""MetricsRegistry: counters, gauges, and log-bucketed latency histograms.

The port's copy of the JAX package's `repro.obs.registry`.  Every
instrument is MERGEABLE.  A histogram is a map exponent -> count over
power-of-two buckets (value v lands in the bucket (2^(e-1), 2^e]: frexp,
no log calls on the hot path), so merging two histograms is integer
addition per bucket, as OR-merging two sketches is.  Quantiles walk the
cumulative bucket counts and interpolate inside the crossing bucket, so
p50/p95/p99 are exact to within one power-of-two bucket.

Three instrument kinds:

  * Counter: monotone float/int, `inc(n)`.  Merge: sum.
  * Gauge: last-set value, or a CALLBACK evaluated at snapshot/render time
    (`MetricsRegistry.gauge_fn`), so structural gauges (tier row counts,
    LRU size) always read the live state.  Merge: sum.
  * Histogram: pow2 buckets + count/sum/min/max, `observe(v)`,
    `quantile(p)`, `time()` context manager.  Merge: per-bucket sum.

Instruments are identified by (name, sorted label items); labels render
into Prometheus text format (`render_prom`) and nest under the name in
`snapshot()`.  All mutation goes through per-instrument locks: the front
door's dispatcher thread observes while callers read, and a lost
increment would break the exact hit/miss counters.

The null twins at the bottom (`NullRegistry` etc.) are the REPRO_OBS=0
path: every method is a constant-returning no-op on shared singletons, so
disabled instrumentation costs an attribute lookup and an empty call.
"""

from __future__ import annotations

import math
import threading
import time


def _bucket_exp(v: float) -> int:
    """Bucket exponent e such that v lands in (2^(e-1), 2^e] — exact powers
    of two land on their own boundary.  Non-positive values collapse into a
    single underflow bucket below every real one."""
    if v <= 0.0:
        return -1075  # below the smallest positive float's exponent
    m, e = math.frexp(v)  # v = m * 2^e, m in [0.5, 1)
    return e - 1 if m == 0.5 else e


def _quantile(buckets: dict, count: int, mn: float, mx: float,
              p: float) -> float:
    """Quantile over an already-copied histogram state (see
    Histogram.state) — lock-free, so exporters can compute p50/p95/p99
    from one consistent copy instead of re-locking per quantile."""
    if count == 0:
        return math.nan
    target = max(1.0, (p / 100.0) * count)
    cum = 0
    for e in sorted(buckets):
        n = buckets[e]
        lo, hi = 2.0 ** (e - 1), 2.0 ** e
        if cum + n >= target:
            frac = (target - cum) / n
            est = lo + frac * (hi - lo)
            return min(max(est, mn), mx)
        cum += n
    return mx


class Counter:
    """Monotone counter.  `value` is a float (Prometheus convention); inc
    with ints to keep it exact for accounting counters."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-set value (or live callback — see MetricsRegistry.gauge_fn)."""

    __slots__ = ("_value", "_fn")

    def __init__(self, fn=None):
        self._value = 0.0
        self._fn = fn

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        if self._fn is not None:
            return self._fn()
        return self._value


class Histogram:
    """Power-of-two log-bucketed histogram with exact count/sum/min/max.

    Buckets are keyed by exponent: value v counts toward bucket e with
    upper edge 2^e, where 2^(e-1) < v <= 2^e.  `quantile(p)` (p in [0,100])
    walks the cumulative counts to the crossing bucket and linearly
    interpolates inside it — within one bucket of the true order statistic
    by construction.
    """

    __slots__ = ("buckets", "count", "sum", "min", "max", "_lock")

    def __init__(self):
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        e = _bucket_exp(v)
        with self._lock:
            self.buckets[e] = self.buckets.get(e, 0) + 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def time(self) -> "_HistTimer":
        """Context manager observing the block's wall time in MILLISECONDS
        — the unit every latency histogram in the repo uses."""
        return _HistTimer(self)

    def quantile(self, p: float) -> float:
        """p-th percentile (p in [0, 100]), exact to within one pow2 bucket
        (linear interpolation inside the crossing bucket, clamped to the
        observed min/max so degenerate histograms stay sensible).  NaN when
        empty."""
        buckets, count, _, mn, mx = self.state()
        return _quantile(buckets, count, mn, mx, p)

    def state(self) -> tuple:
        """Consistent copy of (buckets, count, sum, min, max) taken under
        the lock — the one safe way to READ a histogram that other threads
        are concurrently observing into.  Iterating `.buckets` directly can
        see the dict resize mid-iteration (RuntimeError) or pair a bucket
        sum with a count from a different instant; every reader in this
        module (`quantile`, `snapshot`, `render_prom`, `merge_from`) goes
        through here."""
        with self._lock:
            return (dict(self.buckets), self.count, self.sum,
                    self.min, self.max)

    def merge_from(self, other: "Histogram") -> None:
        # copy other's state under ITS lock first, then fold under ours —
        # sequential lock holds, never nested, so merging a registry into
        # itself or cross-merging two registries cannot deadlock
        buckets, count, total, mn, mx = other.state()
        with self._lock:
            for e, n in buckets.items():
                self.buckets[e] = self.buckets.get(e, 0) + n
            self.count += count
            self.sum += total
            self.min = min(self.min, mn)
            self.max = max(self.max, mx)


class _HistTimer:
    __slots__ = ("_h", "_t0")

    def __init__(self, h: Histogram):
        self._h = h

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._h.observe((time.perf_counter() - self._t0) * 1e3)
        return False


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


class MetricsRegistry:
    """A namespace of instruments, mergeable with other registries.

    `counter`/`gauge`/`histogram` are get-or-create by (name, labels) —
    hot paths cache the returned instrument once and hit only its own
    method afterwards.  One name must keep one kind (ValueError otherwise:
    a name that is a counter on one shard and a gauge on another could not
    merge or render).
    """

    is_null = False

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}
        self._kinds: dict[str, type] = {}

    def _get(self, cls, name: str, labels: dict, factory):
        key = _key(name, labels)
        with self._lock:
            got = self._metrics.get(key)
            if got is None:
                kind = self._kinds.setdefault(name, cls)
                if kind is not cls:
                    raise ValueError(
                        f"metric {name!r} is already a {kind.__name__}, "
                        f"not a {cls.__name__}")
                got = self._metrics[key] = factory()
            elif type(got) is not cls:
                raise ValueError(
                    f"metric {name!r} is already a {type(got).__name__}, "
                    f"not a {cls.__name__}")
            return got

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels, Gauge)

    def gauge_fn(self, name: str, fn, **labels) -> Gauge:
        """A gauge whose value is `fn()` evaluated at read time — the live
        window onto structural state (tier depths, cache sizes, migration
        progress).  Re-registering the same (name, labels) swaps the
        callback: the engine re-registers across store swaps/restores."""
        g = self._get(Gauge, name, labels, lambda: Gauge(fn))
        g._fn = fn
        return g

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels, Histogram)

    # -- merge (the merge-tree discipline) ----------------------------------

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold `other`'s instruments into this registry: counters and
        gauges sum, histograms add per-bucket — associative and
        commutative, so a log-depth merge tree of per-worker registries
        yields the same totals as any sequential order.  Callback gauges
        merge by their value AT MERGE TIME (the callback itself stays with
        its own registry — a shipped registry is a snapshot)."""
        if getattr(other, "is_null", False):
            return
        with other._lock:
            items = list(other._metrics.items())
        for (name, labels), m in items:
            if isinstance(m, Counter):
                self.counter(name, **dict(labels)).inc(m.value)
            elif isinstance(m, Histogram):
                self.histogram(name, **dict(labels)).merge_from(m)
            else:
                g = self.gauge(name, **dict(labels))
                g._fn = None
                g._value = g._value + m.value

    # -- exporters ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Nested plain-python dict: name -> {label_str -> value} for
        counters/gauges, name -> {label_str -> {count, sum, min, max, p50,
        p95, p99}} for histograms.  Unlabeled instruments collapse the
        inner level to the value itself."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {}
        for (name, labels), m in items:
            if isinstance(m, Counter):
                val: object = m.value
            elif isinstance(m, Gauge):
                val = m.value
            else:
                buckets, count, total, mn, mx = m.state()
                val = {
                    "count": count, "sum": total,
                    "min": None if count == 0 else mn,
                    "max": None if count == 0 else mx,
                    "p50": _quantile(buckets, count, mn, mx, 50),
                    "p95": _quantile(buckets, count, mn, mx, 95),
                    "p99": _quantile(buckets, count, mn, mx, 99),
                }
            if not labels:
                out[name] = val
            else:
                lab = ",".join(f"{k}={v}" for k, v in labels)
                out.setdefault(name, {})[lab] = val
        return out

    def render_prom(self) -> str:
        """Prometheus text exposition format.  Histograms render cumulative
        `_bucket{le=...}` series over their occupied pow2 bucket edges plus
        `_sum`/`_count`; counters get the `_total`-less raw name with
        `# TYPE` headers (names here already carry `_total` suffixes where
        conventional)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: list[str] = []
        typed: set[str] = set()

        def labstr(labels: tuple, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in labels]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        for (name, labels), m in items:
            if isinstance(m, Counter):
                if name not in typed:
                    lines.append(f"# TYPE {name} counter")
                    typed.add(name)
                lines.append(f"{name}{labstr(labels)} {m.value}")
            elif isinstance(m, Gauge):
                if name not in typed:
                    lines.append(f"# TYPE {name} gauge")
                    typed.add(name)
                lines.append(f"{name}{labstr(labels)} {m.value}")
            else:
                if name not in typed:
                    lines.append(f"# TYPE {name} histogram")
                    typed.add(name)
                buckets, count, total, _, _ = m.state()
                cum = 0
                for e in sorted(buckets):
                    cum += buckets[e]
                    edge = f'le="{2.0 ** e:g}"'
                    lines.append(
                        f"{name}_bucket{labstr(labels, edge)} {cum}")
                inf_edge = labstr(labels, 'le="+Inf"')
                lines.append(f"{name}_bucket{inf_edge} {count}")
                lines.append(f"{name}_sum{labstr(labels)} {total:g}")
                lines.append(f"{name}_count{labstr(labels)} {count}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# the REPRO_OBS=0 no-op twins — shared singletons, every method constant
# ---------------------------------------------------------------------------


class _NullTimer:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TIMER = _NullTimer()


class _NullCounter:
    __slots__ = ()
    value = 0

    def inc(self, n=1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = 0.0

    def set(self, v) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    count = 0
    sum = 0.0

    def observe(self, v) -> None:
        pass

    def time(self):
        return _NULL_TIMER

    def quantile(self, p):
        return math.nan

    def state(self):
        return {}, 0, 0.0, math.inf, -math.inf


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class NullRegistry:
    """The disabled path: hands out shared no-op instruments, ignores
    merges, exports empty.  Callers keep IDENTICAL code for both modes —
    they cache instruments at construction and call their methods; with
    this registry those are empty host calls that touch no tensor, so the
    disabled engine launches exactly the kernels the instrumented one
    does."""

    is_null = True

    def counter(self, name, **labels):
        return _NULL_COUNTER

    def gauge(self, name, **labels):
        return _NULL_GAUGE

    def gauge_fn(self, name, fn, **labels):
        return _NULL_GAUGE

    def histogram(self, name, **labels):
        return _NULL_HISTOGRAM

    def merge(self, other) -> None:
        pass

    def snapshot(self) -> dict:
        return {}

    def render_prom(self) -> str:
        return ""


NULL_REGISTRY = NullRegistry()
