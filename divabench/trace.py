"""Reduction of a ``torch.profiler`` trace of the measured window.

The profiler records the host's operations and, through CUPTI, every
kernel, copy and fill on the card.  ``summarize`` keeps what the per-layer
readers need: the window on the profiler's clock (the ``WINDOW`` range the
harness opens around it), the device's busy time (the union of its
intervals inside the window), kernel launches and device time by symbol,
and the idle gaps between device work, each named by the innermost host
operation running at the gap's middle.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

WINDOW = "divabench.window"
_COPIES = ("Memcpy", "Memset")
# host ranges that span the whole recording rather than one operation
_NOT_OPS = ("cuda", "PyTorch Profiler", "ProfilerStep",
            "Activity Buffer Request")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_launches: int
    by_symbol: dict = field(default_factory=dict)   # name -> [count, seconds]
    idle_gaps: dict = field(default_factory=dict)   # host op -> seconds

    def symbol(self, prefix: str) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose symbol contains
        ``prefix``."""
        n, s = 0, 0.0
        for name, (c, sec) in self.by_symbol.items():
            if prefix in name:
                n, s = n + c, s + sec
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_symbol.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], s] for n, (_, s) in ops],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of the (start, end) pairs, sorted by start."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, len(s) - 1]
    return s[first], e[last]


def summarize(prof) -> Trace:
    """The window's trace from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    host, dev = [], []
    w0 = w1 = None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            # a host range (the window's) is mirrored on the device's
            # timeline as an annotation: it is not device work
            if not e.is_user_annotation() and e.name() != WINDOW:
                dev.append((e.start_ns(), e.end_ns(), e.name()))
        else:
            name = e.name()
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.end_ns()
            elif not name.startswith(_NOT_OPS):
                host.append((e.start_ns(), e.end_ns(), name))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    by_symbol: dict = {}
    kernels = 0
    inside = [d for d in dev if d[1] > w0 and d[0] < w1]
    for s, e, name in inside:
        rec = by_symbol.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) / 1e9
        kernels += not name.startswith(_COPIES)
    busy, gaps = 0.0, {}
    if inside:
        st = np.clip(np.asarray([d[0] for d in inside], np.int64), w0, w1)
        en = np.clip(np.asarray([d[1] for d in inside], np.int64), w0, w1)
        ms, me = _union(st, en)
        busy = float((me - ms).sum()) / 1e9
        gaps = _name_gaps(np.r_[w0, me], np.r_[ms, w1], host)
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy,
                 kernel_launches=kernels, by_symbol=by_symbol,
                 idle_gaps=gaps)


def _name_gaps(g0: np.ndarray, g1: np.ndarray, host: list) -> dict:
    """Seconds of idle device time by the innermost host operation that
    encloses each gap's middle ("host: between operations" where none
    does)."""
    keep = g1 > g0
    g0, g1 = g0[keep], g1[keep]
    out: dict = {}
    if not len(g0):
        return out
    host.sort()
    hs = np.asarray([h[0] for h in host], np.int64)
    he = np.asarray([h[1] for h in host], np.int64)
    reach = np.maximum.accumulate(he) if len(he) else he
    mids = (g0 + g1) // 2
    idx = np.searchsorted(hs, mids, side="right") - 1
    for i, m, dur in zip(idx, mids, (g1 - g0) / 1e9):
        name = "host: between operations"
        if i >= 0 and reach[i] >= m:
            # the latest-starting operation that is still running at m is
            # the innermost one; walk back over siblings that ended before
            for j in range(i, max(i - 256, -1), -1):
                if he[j] >= m:
                    name = host[j][2]
                    break
        out[name] = out.get(name, 0.0) + float(dur)
    return out
