"""Labeled metrics registry: counters, gauges, histograms — host-side only.

A copy of ``repro.obs.metrics`` (pure Python), with the reference's metric
names (``repro_*``) kept, so a Prometheus scrape reads the same series from
either package.  Every metric lives in one process-global ``Registry``
(``repro_torch.obs.REGISTRY``); instrumented code holds the metric object
and bumps it with plain Python arithmetic at HOST boundaries — never inside
device work, so instrumentation cannot change a result.

Naming convention: ``repro_<layer>_<noun>_<unit|total>`` with lowercase
snake-case label names — ``repro_stream_chunks_total{entry}``,
``repro_serve_query_latency_seconds{server}``.  Counters end in ``_total``,
gauges in a unit, histograms in a unit (seconds unless stated).

Disabled mode: ``REGISTRY.enabled = False`` turns every ``inc``/``set``/
``observe`` into an early return (one attribute load + branch).  Values are
frozen, reads still work, and — because no metric ever feeds back into
computation — outputs are bitwise identical either way.

Export: ``Registry.snapshot()`` (JSON-friendly dict) and
``Registry.prometheus_text()`` (the Prometheus text exposition format,
scrapable / pushable verbatim).
"""
from __future__ import annotations

import math
import threading

# Default histogram buckets: latency-oriented, log-spaced from 50us to 100s.
# Upper bounds in seconds; +Inf is implicit (every histogram carries it).
DEFAULT_BUCKETS = (
    5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0)


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers bare, floats via repr."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c == "_" for c in name) \
            or name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r} "
                         "(want snake_case, e.g. repro_serve_queries_total)")
    return name


class Metric:
    """One named metric family; label VALUES key child time series.

    ``labels(**kv)`` returns (creating on first use) the child for one label
    combination; a label-less family is its own single child.  Children are
    the hot-path handles: hold them, don't re-resolve per event.
    """

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: tuple,
                 registry: "Registry"):
        self.name = _validate_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._registry = registry
        self._children: dict[tuple, Metric] = {}
        self._labelvalues: tuple = ()

    def labels(self, **kv):
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: got labels {sorted(kv)}, "
                f"declared {sorted(self.labelnames)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = type(self)(
                self.name, self.help, (), self._registry, **self._child_kw())
            child._labelvalues = key
        return child

    def _child_kw(self) -> dict:
        return {}

    def _series(self):
        """(labelvalues, child) pairs — the family itself when label-less."""
        if self.labelnames:
            return sorted(self._children.items())
        return [((), self)]

    def _check_leaf(self):
        if self.labelnames:
            raise ValueError(f"{self.name} takes labels "
                             f"{self.labelnames}; call .labels() first")


class Counter(Metric):
    """Monotonically increasing count (``_total`` suffix by convention)."""

    kind = "counter"

    def __init__(self, name, help, labelnames, registry):
        super().__init__(name, help, labelnames, registry)
        self._value = 0

    def inc(self, amount: int | float = 1) -> None:
        if not self._registry.enabled:
            return
        self._check_leaf()
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        self._value += amount

    def value(self, **kv):
        return (self.labels(**kv) if kv else self)._value

    def _reset(self):
        self._value = 0


class Gauge(Metric):
    """A value that goes both ways (table age, cache size, RSS)."""

    kind = "gauge"

    def __init__(self, name, help, labelnames, registry):
        super().__init__(name, help, labelnames, registry)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        self._check_leaf()
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        self._check_leaf()
        self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def value(self, **kv):
        return (self.labels(**kv) if kv else self)._value

    def _reset(self):
        self._value = 0.0


class Histogram(Metric):
    """Cumulative-bucket histogram with exact count/sum and min/max.

    ``observe(v)`` is O(len(buckets)) linear scan — buckets are ~20 and
    observations are host-boundary events (a query, a chunk), so this stays
    off every device hot path by construction.  ``percentile(q)`` estimates
    by linear interpolation inside the bucket that crosses rank ``q``,
    clamped to the observed [min, max] — exact at the extremes, bucket-
    resolution in between (the standard Prometheus ``histogram_quantile``
    semantics, sharpened by the tracked extremes).
    """

    kind = "histogram"

    def __init__(self, name, help, labelnames, registry, *,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, registry)
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(set(b)) or not b:
            raise ValueError(f"{name}: buckets must be sorted and unique")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)      # last = +Inf
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _child_kw(self):
        return {"buckets": self.buckets}

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        self._check_leaf()
        v = float(value)
        i = 0
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                break
        else:
            i = len(self.buckets)
        self._counts[i] += 1
        self._count += 1
        self._sum += v
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _cum_counts(self) -> list[int]:
        """Cumulative per-bucket counts (the Prometheus ``_bucket`` series:
        each bucket counts observations <= its upper bound)."""
        out, cum = [], 0
        for c in self._counts:
            cum += c
            out.append(cum)
        return out

    def percentile(self, q: float, **kv) -> float:
        """q in [0, 100]; NaN on an empty histogram.  Assumes nonnegative
        observations (durations) — the bucket floor is 0."""
        h = self.labels(**kv) if kv else self
        h._check_leaf()
        if h._count == 0:
            return math.nan
        rank = q / 100.0 * h._count
        cum, lo = 0, 0.0
        for i, ub in enumerate(h.buckets + (math.inf,)):
            c = h._counts[i]
            if c and cum + c >= rank:
                lo_eff = max(lo, h._min)        # sharpen by the extremes
                ub_eff = min(ub, h._max)
                if ub_eff < lo_eff:
                    return ub_eff
                frac = min(max((rank - cum) / c, 0.0), 1.0)
                return lo_eff + (ub_eff - lo_eff) * frac
            cum += c
            lo = ub
        return h._max

    def summary(self) -> dict:
        """count / sum / mean / p50 / p99 / min / max — the serve-layer
        report block."""
        n = self._count
        return {"count": n, "sum": self._sum,
                "mean": self._sum / n if n else math.nan,
                "p50": self.percentile(50.0), "p99": self.percentile(99.0),
                "min": self._min if n else math.nan,
                "max": self._max if n else math.nan}

    def _reset(self):
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf


class Registry:
    """All metric families of one process, creation-idempotent by name.

    ``counter``/``gauge``/``histogram`` get-or-create (a second declaration
    with a different kind or label set is a bug and raises); ``snapshot``
    and ``prometheus_text`` export every series.  ``reset()`` zeroes values
    but keeps the families and children, so held handles stay live —
    the per-test / per-bench isolation primitive.
    """

    def __init__(self):
        self.enabled = True
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind} "
                        f"with labels {m.labelnames}")
                return m
            m = self._metrics[name] = cls(name, help, tuple(labelnames),
                                          self, **kw)
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> Metric | None:
        return self._metrics.get(name)

    def value(self, name: str, **labels):
        """Convenience read: counter/gauge value or histogram summary; 0 for
        a counter/gauge series that never fired (absent child)."""
        m = self._metrics.get(name)
        if m is None:
            raise KeyError(f"no metric {name!r}")
        if labels:
            key = tuple(str(labels[n]) for n in m.labelnames)
            if key not in m._children:
                return 0
            m = m.labels(**labels)
        return m.summary() if isinstance(m, Histogram) else m._value

    def snapshot(self) -> dict:
        """JSON-friendly export: {name: {kind, help, series: [{labels,
        value|histogram fields}]}}."""
        out = {}
        for name, m in sorted(self._metrics.items()):
            series = []
            for lv, child in m._series():
                s = {"labels": dict(zip(m.labelnames, lv))}
                if isinstance(child, Histogram):
                    s.update(count=child._count, sum=child._sum,
                             buckets={_fmt(ub): c for ub, c in zip(
                                 m_buckets(child), child._cum_counts())})
                else:
                    s["value"] = child._value
                series.append(s)
            out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (one family per HELP/TYPE
        block, histogram ``_bucket``/``_sum``/``_count`` expansion)."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for lv, child in m._series():
                base = _label_str(m.labelnames, lv)
                if isinstance(child, Histogram):
                    for ub, c in zip(m_buckets(child), child._cum_counts()):
                        le = _label_str(m.labelnames + ("le",),
                                        lv + (_fmt(ub),))
                        lines.append(f"{name}_bucket{le} {c}")
                    lines.append(f"{name}_sum{base} {_fmt(child._sum)}")
                    lines.append(f"{name}_count{base} {child._count}")
                else:
                    lines.append(f"{name}{base} {_fmt(child._value)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            for m in self._metrics.values():
                if not m.labelnames:
                    m._reset()
                for child in m._children.values():
                    child._reset()


def m_buckets(h: Histogram) -> tuple:
    return h.buckets + (math.inf,)


def _label_str(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


# ---------------------------------------------------------------- the global

REGISTRY = Registry()
