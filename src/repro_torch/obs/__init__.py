"""Fleet observability: metrics registry + span tracing (the counterpart of
``repro.obs``).

One process-global ``REGISTRY`` of counters/gauges/histograms and a span
tracer emitting Chrome trace-event JSON, threaded through the streaming
chunk scans, the FleetServer serving paths, checkpointing and the launch
driver.

Instrumentation lives strictly at host boundaries — a counter bumps when
Python runs (a chunk boundary, a query), a span wraps a host call — never
inside device work, so enabling or disabling observability leaves every
output bit for bit as it was, and disabled mode costs one branch per event.
The reference's compile counters (``repro_compile_*``) have no counterpart:
the port compiles no chunk programs.

    from repro_torch import obs
    obs.REGISTRY.counter("repro_my_events_total").inc()
    with obs.span("layer.section") as sp:
        ...
    print(obs.REGISTRY.prometheus_text())

``obs.disable()`` / ``obs.enable()`` flip the metrics registry;
``obs.start_tracing()`` / ``obs.stop_tracing()`` scope a trace recording.
"""
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, REGISTRY, Counter,
                                     Gauge, Histogram, Metric, Registry)
from repro_torch.obs.tracing import (Span, active, chrome_trace, span,
                                     span_if_active, start_tracing,
                                     stop_tracing, trace_events,
                                     write_chrome_trace)


def enable() -> None:
    REGISTRY.enabled = True


def disable() -> None:
    """Freeze every metric (reads still work, events become one branch).
    Tracing is separately scoped by ``start_tracing``/``stop_tracing``."""
    REGISTRY.enabled = False


def enabled() -> bool:
    return REGISTRY.enabled


def peak_rss_mb() -> float:
    """This process's true peak resident set in MB.

    Reads ``VmHWM`` from ``/proc/self/status`` rather than
    ``getrusage().ru_maxrss``: on Linux the rusage high-water mark is
    carried ACROSS ``execve``, so a subprocess forked from a fat parent
    (a mid-suite pytest at several GB) reports the parent's peak, not its
    own — every RSS-budget child here was silently measuring its parent.
    ``VmHWM`` lives in the fresh post-exec ``mm`` and only counts this
    process.  Falls back to ru_maxrss where /proc is unavailable."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


__all__ = [
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "Metric",
    "REGISTRY", "Registry", "Span", "active", "chrome_trace", "disable",
    "enable", "enabled", "peak_rss_mb", "span", "span_if_active",
    "start_tracing", "stop_tracing", "trace_events", "write_chrome_trace",
]
