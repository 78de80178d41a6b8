"""Host-side span tracing, exported as Chrome trace-event JSON (Perfetto).

The counterpart of ``repro.obs.tracing``.  Spans are plain context managers
around host code: ``perf_counter`` at entry and exit, an optional
``torch.cuda.synchronize`` at close for the CUDA devices of the bound
tensors (so a device-bound span measures compute, not the enqueue), and an
optional ``Histogram`` the duration is observed into.  Collection into the
trace buffer happens only while a trace is being recorded
(``start_tracing``/``stop_tracing``); outside a recording, a span is two
clock reads and a branch.

Because a span only reads clocks and waits for work already queued,
enabling tracing cannot change any computed value.

    from repro_torch.obs import span, start_tracing, write_chrome_trace
    start_tracing()
    with span("serve.ingest", n=256) as sp:
        out = server.ingest()
        sp.bind(out)                 # wait for it at span close
    write_chrome_trace("trace.json")

The emitted file is the Chrome trace-event format: a JSON object with a
``traceEvents`` list of complete ("ph": "X") events in microseconds —
loadable as-is in Perfetto / chrome://tracing.
"""
from __future__ import annotations

import json
import os
import threading
import time

import torch

_lock = threading.Lock()
_active = False
_events: list[dict] = []
_t_epoch = time.perf_counter()      # trace timestamps are relative to import


def active() -> bool:
    """True while a trace is being recorded — hot loops may guard optional
    per-iteration spans on this to skip even the clock reads."""
    return _active


def start_tracing() -> None:
    """Begin recording span events (clears any previous buffer)."""
    global _active
    with _lock:
        _events.clear()
        _active = True


def stop_tracing() -> list[dict]:
    """Stop recording; returns (and keeps) the collected events."""
    global _active
    with _lock:
        _active = False
        return list(_events)


def trace_events() -> list[dict]:
    return list(_events)


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of the tensors in ``value``: a tensor, or a tuple,
    list or dict of them (nested); anything else has none."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    return out


class Span:
    """One timed section.  ``bind(value)`` registers tensors (a tensor, or a
    tuple, list or dict of them) whose CUDA devices are synchronized at exit
    (CPU tensors and numpy need nothing); ``set(**kv)`` attaches trace args;
    ``duration_s`` is readable after exit (the stats the launch/bench
    drivers report — one code path for timings and traces)."""

    __slots__ = ("name", "args", "hist", "_bound", "_t0", "duration_s")

    def __init__(self, name: str, hist=None, **args):
        self.name = name
        self.args = args
        self.hist = hist
        self._bound = None
        self._t0 = 0.0
        self.duration_s = 0.0

    def bind(self, value) -> "Span":
        self._bound = value
        return self

    def set(self, **kv) -> "Span":
        self.args.update(kv)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._bound is not None:
            for dev in _cuda_devices(self._bound, set()):
                torch.cuda.synchronize(dev)
            self._bound = None
        t1 = time.perf_counter()
        self.duration_s = t1 - self._t0
        if self.hist is not None:
            self.hist.observe(self.duration_s)
        if _active:
            with _lock:
                _events.append({
                    "name": self.name, "ph": "X", "cat": "repro",
                    "pid": os.getpid(), "tid": threading.get_ident() & 0xffff,
                    "ts": (self._t0 - _t_epoch) * 1e6,
                    "dur": self.duration_s * 1e6,
                    "args": self.args})


def span(name: str, hist=None, **args) -> Span:
    """The canonical entry point: ``with span("layer.what", key=...) as sp``."""
    return Span(name, hist=hist, **args)


def chrome_trace() -> dict:
    """The Chrome trace-event JSON object for the collected events."""
    return {"traceEvents": trace_events(), "displayTimeUnit": "ms"}


def write_chrome_trace(path) -> str:
    """Write the collected events as Chrome trace-event JSON; returns the
    path (str) for log lines."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return str(path)
