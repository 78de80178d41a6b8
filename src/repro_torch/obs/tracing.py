"""Host-side span tracing, exported as Chrome trace-event JSON (Perfetto).

The counterpart of ``repro.obs.tracing``.  Spans are plain context managers
around host code: the wall clock at entry and exit, an optional
``torch.cuda.synchronize`` at close for the CUDA devices of the bound
tensors (so a device-bound span measures compute, not the enqueue), and an
optional ``Histogram`` the duration is observed into.  Collection into the
trace buffer happens only while a trace is being recorded
(``start_tracing``/``stop_tracing``); outside a recording, a span is two
clock reads and a branch, and a ``span_if_active`` section one branch.

While a trace is recorded, each span also opens a
``torch.profiler.record_function`` range of its own name, so a running
``torch.profiler`` holds every program span on its own timeline, and each
recorded event carries an ``id`` and the ``parent`` id of the span open
around it on the same thread (None at the root).  A span opened inside one
whose args hold a ``chunk`` carries the same ``chunk``.  Timestamps are
CLOCK_REALTIME (``time.time_ns``), the clock torch's profiler stamps its
host events with, so a span and its range start within microseconds.

Because a span only reads clocks and waits for work already queued,
enabling tracing cannot change any computed value.

    from repro_torch.obs import span, start_tracing, write_chrome_trace
    start_tracing()
    with span("serve.ingest", n=256) as sp:
        out = server.ingest()
        sp.bind(out)                 # wait for it at span close
    write_chrome_trace("trace.json")

The emitted file is the Chrome trace-event format: a JSON object with a
``traceEvents`` list of complete ("ph": "X") events in microseconds since
the epoch — loadable as-is in Perfetto / chrome://tracing.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time

import torch

_lock = threading.Lock()
_active = False
_events: list[dict] = []
_ids = itertools.count(1)
_local = threading.local()          # .open: this thread's recorded spans


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


def _open_spans() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


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

    __slots__ = ("name", "args", "hist", "_bound", "_t0", "duration_s",
                 "id", "parent", "_range")

    def __init__(self, name: str, hist=None, **args):
        self.name = name
        self.args = args
        self.hist = hist
        self._bound = None
        self._t0 = 0
        self.duration_s = 0.0
        self.id = self.parent = self._range = None

    def bind(self, value) -> "Span":
        self._bound = value
        return self

    def set(self, **kv) -> "Span":
        self.args.update(kv)
        return self

    def __enter__(self) -> "Span":
        if _active:
            open_ = _open_spans()
            self.id = next(_ids)
            if open_:
                up = open_[-1]
                self.parent = up.id
                if "chunk" in up.args:
                    self.args.setdefault("chunk", up.args["chunk"])
            open_.append(self)
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._bound is not None:
            for dev in _cuda_devices(self._bound, set()):
                torch.cuda.synchronize(dev)
            self._bound = None
        t1 = time.time_ns()
        self.duration_s = (t1 - self._t0) / 1e9
        if self.hist is not None:
            self.hist.observe(self.duration_s)
        if self._range is None:
            return
        self._range.__exit__(exc_type, exc, tb)
        self._range = None
        _open_spans().pop()
        if _active:
            with _lock:
                _events.append({
                    "name": self.name, "ph": "X", "cat": "repro",
                    "pid": os.getpid(), "tid": threading.get_ident() & 0xffff,
                    "ts": self._t0 / 1e3, "dur": (t1 - self._t0) / 1e3,
                    "id": self.id, "parent": self.parent,
                    "args": self.args})


class _Off:
    """A section traced only while recording, outside a recording: enters,
    binds and sets nothing."""
    __slots__ = ()
    id = None

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def bind(self, value) -> "_Off":
        return self

    def set(self, **kv) -> "_Off":
        return self


_OFF = _Off()


def span(name: str, hist=None, **args) -> Span:
    """The canonical entry point: ``with span("layer.what", key=...) as sp``."""
    return Span(name, hist=hist, **args)


def span_if_active(name: str, **args):
    """A ``span`` while a trace is recorded, else a shared no-op: the hot
    path's sections (the streaming stages, the sweep's walks) cost one
    branch outside a recording and time nothing."""
    return Span(name, **args) if _active else _OFF


def chrome_trace() -> dict:
    """The Chrome trace-event JSON object for the collected events."""
    return {"traceEvents": trace_events(), "displayTimeUnit": "ms"}


def write_chrome_trace(path) -> str:
    """Write the collected events as Chrome trace-event JSON; returns the
    path (str) for log lines."""
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return str(path)
