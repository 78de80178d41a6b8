"""FR-FCFS memory-system walk (Fig 19): plain version and CUDA kernel.

``memsim_walk`` replaces the Pallas TPU kernel
``repro/kernels/bank_sched.py::bank_sched`` (``:138``, ``pl.pallas_call`` at
``:172``) together with the ``lax.scan`` that calls it once per serviced
request (``repro/memsim/sim.py::_scan_sim``, ``:344``) and the two vmaps over
(timing table x workload) around that (``_memsim_grid``, ``:504``).  It walks
every (table, trace) pair through the bounded-queue scheduler and returns
each request's latency and row hit, in service order.

One step, per walk: ``candidate_times`` scores the (Q,) queued requests
against the (B,) bank state — row-hit first among arrived requests, then
oldest by (arrive, trace index) — and projects each one's ACTIVATE, column
and data times under its bank's own timing row; the winner updates bank, bus,
last-ACT and the sorted four-entry tFAW ring, and its slot refills with the
next trace request.  All arithmetic is int32, as in the reference.

The TPU form gathers ``table[idx]`` through one-hot reductions because
Mosaic avoids dynamic indexing; a plain gather is exact on numpy, torch and
the card, so the port gathers.  ``candidate_times`` is written once for
numpy and torch (``memsim/reference.py`` calls it with numpy arrays) and
takes either the reference's unbatched shapes or a leading walk axis.

Dispatch is by the tensors' device alone: CPU tensors go to the plain walk
``memsim_walk_ref`` (a Python loop over the steps, the walks as a batch
axis), CUDA tensors to a kernel in ``csrc/bank_sched.cu`` (a warp, or half
of one, walks one trace, the whole loop inside the kernel); anything else
raises.  Two
hand-written kernels share the work, chosen by ``walk_route`` from the
inputs: the fast one (bank state in registers, one reduction a step) where
banks, ranks and channels are at most 32, arrivals never decrease along a
trace and n < 2^25 — every trace ``memsim`` builds — and the general one
otherwise.  ``memsim_walk.launches`` counts kernel launches, and
``memsim_walk.route_launches`` each route's.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

#: output names, in order, of ``candidate_times``
OUTPUTS = ("key", "hit", "t_act", "t_col", "done", "new_pre", "latency")
#: the kernel keeps one queue slot per lane of a warp
MAX_QUEUE = 32
#: shared-memory bank state of one walk: 11 ints a bank, 1 a channel, 5 a rank
MAX_BANKS, MAX_RANKS, MAX_CHANNELS = 512, 64, 64
#: the fast kernel keeps a bank, rank and channel per lane, and packs a trace
#: index into 25 bits
FAST_MAX_UNITS, FAST_MAX_N = 32, 2 ** 25
ROUTES = ("fast", "general")

_BIG = 2 ** 30
_NEG = -(10 ** 6)


def _take(table, idx):
    """``table[..., idx]`` along the last axis; ``idx`` has ``table``'s
    leading axes (int64 when a tensor)."""
    if isinstance(table, torch.Tensor):
        return torch.gather(table, -1, idx.long())
    return np.take_along_axis(table, idx, axis=-1)


def _take_rows(tc, idx):
    """``tc[..., idx, :]``: the (..., Q, 6) cycle rows of the queued banks."""
    if isinstance(tc, torch.Tensor):
        return torch.gather(tc, -2, idx[..., None].expand(*idx.shape, 6))
    return np.take_along_axis(tc, idx[..., None], axis=-2)


def _i32(x):
    return x.to(torch.int32) if isinstance(x, torch.Tensor) else x.astype(np.int32)


def candidate_times(q_bank, q_row, q_write, q_arrive, q_valid,
                    open_row, ready, pre_ready, bus_ready, last_act, faw_old,
                    t_now, tc, bank_rank, bank_chan, *,
                    tbl: int, trrd: int, tfaw: int,
                    use_bus: bool, use_act: bool):
    """Per-candidate FR-FCFS scoring and service projection; all int32, on
    numpy arrays or torch tensors alike.

    Queue slabs are (Q,) or (N, Q); bank state (B,) or (N, B); ``tc``
    (B, 6) or (N, B, 6) per-bank cycles in [tRCD, tRAS, tRP, tWR, tCL, tCWL]
    order; ``bus_ready`` per channel and ``last_act``/``faw_old`` per rank
    (most recent ACT / oldest of the last four), with the same leading axes;
    ``bank_rank``/``bank_chan`` (B,) maps shared by every walk; ``t_now`` a
    scalar or (N, 1).  Returns ``OUTPUTS``-ordered arrays of the queue's
    shape (see the reference's ``candidate_times`` for each one's meaning).
    """
    xp = torch if isinstance(q_bank, torch.Tensor) else np
    qb = q_bank.long() if xp is torch else q_bank
    g = lambda table: _take(table, qb)

    orow, rdy, prer = g(open_row), g(ready), g(pre_ready)
    rows = _take_rows(tc, qb)
    trcd, tras, trp, twr, tcl, tcwl = (rows[..., k] for k in range(6))

    start = xp.maximum(q_arrive, rdy)
    hit = orow == q_row
    pre_ok = xp.maximum(start, prer)
    t_act = pre_ok + trp
    if use_act:
        rank = bank_rank[qb]
        la = _take(last_act, rank)
        fo = _take(faw_old, rank)
        t_act = xp.maximum(t_act, xp.maximum(la + trrd, fo + tfaw))
    t_col = xp.where(hit, start, t_act + trcd)
    is_wr = q_write == 1
    data_av = t_col + xp.where(is_wr, tcwl, tcl)
    if use_bus:
        chan = bank_chan[qb]
        done = xp.maximum(data_av, _take(bus_ready, chan)) + tbl
    else:
        done = data_av
    latency = done - q_arrive
    base_pre = xp.where(hit, prer, t_act + tras)
    new_pre = xp.where(is_wr, xp.maximum(base_pre, done + twr), base_pre)

    validi = _i32(q_valid)
    elig = _i32(q_arrive <= t_now)
    hiti = _i32(hit & q_valid)
    key = validi * (1 + elig * (1 + hiti))
    return key, _i32(hit), t_act, t_col, done, new_pre, latency


def bank_maps(banks: int, ranks: int, channels: int):
    """(B,) rank and channel of each bank: bank b lives on channel
    ``b % channels`` and rank ``(b // channels) % ranks``."""
    b = np.arange(banks)
    return (((b // channels) % ranks).astype(np.int32),
            (b % channels).astype(np.int32))


def memsim_walk_ref(traces, tc, *, queue: int, ranks: int, channels: int,
                    tbl: int, trrd: int, tfaw: int, use_bus: bool,
                    use_act: bool):
    """Plain PyTorch version of the kernel: the reference's ``_scan_sim`` as a
    Python loop over the ``n`` steps, every (table, trace) walk at once on a
    leading axis (walk ``t * W + w`` takes table ``t`` and trace ``w``)."""
    W, n, _ = traces.shape
    T, B, _ = tc.shape
    dev = traces.device
    N, Q = T * W, min(queue, n)
    i32 = dict(dtype=torch.int32, device=dev)
    rank_np, chan_np = bank_maps(B, ranks, channels)
    bank_rank = torch.as_tensor(rank_np, dtype=torch.int64, device=dev)
    bank_chan = torch.as_tensor(chan_np, dtype=torch.int64, device=dev)
    tcb = tc.repeat_interleave(W, dim=0)                     # (N, B, 6)
    trn = traces.repeat(T, 1, 1)                             # (N, n, 4)

    q = trn[:, :Q].clone()                                   # (N, Q, 4) slots
    q_bank, q_row, q_write, q_arrive = (q[..., k] for k in range(4))
    q_idx = torch.arange(Q, **i32).repeat(N, 1)
    q_valid = torch.ones((N, Q), dtype=torch.bool, device=dev)
    open_row = torch.full((N, B), -1, **i32)
    ready = torch.zeros((N, B), **i32)
    pre_ready = torch.full((N, B), _NEG, **i32)
    bus_ready = torch.zeros((N, channels), **i32)
    last_act = torch.full((N, ranks), _NEG, **i32)
    faw = torch.full((N, ranks, 4), _NEG, **i32)
    t_now = torch.zeros((N, 1), **i32)
    out = torch.empty((N, n, 2), **i32)                      # (latency, hit)
    kw = dict(tbl=tbl, trrd=trrd, tfaw=tfaw, use_bus=use_bus, use_act=use_act)

    for step in range(n):
        res = candidate_times(
            q_bank, q_row, q_write, q_arrive, q_valid, open_row, ready,
            pre_ready, bus_ready, last_act, faw[..., 0], t_now, tcb,
            bank_rank, bank_chan, **kw)
        key = res[0]
        # lexicographic winner: max key, then min arrive, then min trace idx
        c1 = key == key.amax(dim=1, keepdim=True)
        arr_m = torch.where(c1, q_arrive, _BIG)
        c2 = c1 & (q_arrive == arr_m.amin(dim=1, keepdim=True))
        w = torch.where(c2, q_idx, _BIG).argmin(dim=1, keepdim=True)  # (N, 1)
        # the winner's (hit, t_act, t_col, done, new_pre, latency, bank, row)
        won = torch.stack(res[1:] + (q_bank, q_row), dim=2) \
            .gather(1, w[..., None].expand(N, 1, 8))[:, 0]
        whit, wact, wcol, wdone, wpre, wlat, wb, wrow = won.split(1, dim=1)
        wb = wb.long()
        out[:, step, 0:1] = wlat
        out[:, step, 1:2] = whit
        open_row.scatter_(1, wb, wrow)
        ready.scatter_(1, wb, wdone)
        pre_ready.scatter_(1, wb, wpre)
        if use_bus:
            bus_ready.scatter_(1, bank_chan[wb], wdone)
        if use_act:
            wmiss, wr = whit == 0, bank_rank[wb]
            la = last_act.gather(1, wr)
            last_act.scatter_(1, wr, torch.where(wmiss, torch.maximum(la, wact),
                                                 la))
            wr4 = wr[..., None].expand(N, 1, 4)
            ring = faw.gather(1, wr4)                        # (N, 1, 4)
            pushed = torch.sort(torch.cat([ring[..., 1:], wact[..., None]], 2),
                                dim=2).values
            faw.scatter_(1, wr4, torch.where(wmiss[..., None], pushed, ring))
        t_now = torch.maximum(t_now, wcol)
        # refill the winner's slot with the next trace request
        nxt = Q + step
        q.scatter_(1, w[..., None].expand(N, 1, 4),
                   trn[:, min(nxt, n - 1), None])
        q_idx.scatter_(1, w, nxt)
        q_valid.scatter_(1, w, nxt < n)
    out = out.view(T, W, n, 2)
    return out[..., 0], out[..., 1]


def walk_route(traces, banks: int, ranks: int, channels: int) -> str:
    """The kernel that walks ``traces`` (W, n, 4): "fast" where banks, ranks
    and channels are at most 32, n < 2^25 and the arrivals (the last field)
    never decrease along a trace — then the lexicographic winner is the
    queued request of max key and then min trace index — else "general".
    Reads the arrivals only when the sizes allow the fast kernel."""
    if max(banks, ranks, channels) > FAST_MAX_UNITS or traces.shape[1] >= FAST_MAX_N:
        return "general"
    arrive = traces[..., 3]
    return "fast" if bool((arrive[:, 1:] >= arrive[:, :-1]).all()) else "general"


def _launch(traces, tc, Q, *, route, ranks, channels, tbl, trrd, tfaw, use_bus,
            use_act):
    """Launch the ``route`` kernel ("fast" or "general"; ``walk_route``
    chooses) on CUDA tensors; returns (latency, hit), counted in
    ``memsim_walk.launches`` and its route's count."""
    from repro_torch.kernels.build import LaunchError, load
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if not (traces.is_contiguous() and tc.is_contiguous()):
        raise ValueError("bank_sched: traces and timing rows must be "
                         "contiguous")
    W, n, _ = traces.shape
    T, B, _ = tc.shape
    lat = torch.empty((T, W, n), dtype=torch.int32, device=traces.device)
    hit = torch.empty_like(lat)
    if lat.numel():
        fast = route == "fast"
        fn = getattr(load("bank_sched"), "bank_sched_fast_launch" if fast
                     else "bank_sched_walk_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        with torch.cuda.device(traces.device):
            stream = torch.cuda.current_stream(traces.device).cuda_stream
            err = fn(traces.data_ptr(), tc.data_ptr(), lat.data_ptr(),
                     hit.data_ptr(), T, W, n, Q, B, ranks, channels, tbl,
                     trrd, tfaw, int(use_bus), int(use_act), stream)
        if err != 0:
            raise LaunchError(f"bank_sched ({route}) failed: CUDA error {err}")
        memsim_walk.launches += 1
        memsim_walk.route_launches[route] += 1
    return lat, hit


def memsim_walk(traces, tc, *, queue: int, ranks: int, channels: int,
                tbl: int, trrd: int, tfaw: int, use_bus: bool, use_act: bool):
    """traces: (W, n, 4) int32 requests [bank, row, write, arrive]; tc:
    (T, B, 6) int32 per-bank cycle rows -> (latency, hit), each (T, W, n)
    int32 in service order, for every (table, trace) walk under a
    ``queue``-deep FR-FCFS queue (``use_bus``: tBL per channel;
    ``use_act``: tRRD/tFAW per rank)."""
    for name, x, width in (("traces", traces, 4), ("tc", tc, 6)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"memsim_walk takes torch tensors, got "
                            f"{type(x).__name__} for {name}")
        if x.dim() != 3 or x.shape[2] != width:
            raise ValueError(f"{name} must be (., ., {width}), got "
                             f"{tuple(x.shape)}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    if traces.device != tc.device:
        raise ValueError(f"traces on {traces.device} but timing rows on "
                         f"{tc.device}")
    if traces.device.type not in ("cpu", "cuda"):
        raise ValueError(f"memsim_walk runs on cpu or cuda tensors, not "
                         f"{traces.device.type}")
    if not 1 <= queue <= MAX_QUEUE:
        raise ValueError(f"queue must be in 1..{MAX_QUEUE}, got {queue}")
    B = tc.shape[1]
    if not (1 <= B <= MAX_BANKS and 1 <= ranks <= MAX_RANKS
            and 1 <= channels <= MAX_CHANNELS):
        raise ValueError(f"banks/ranks/channels {B}/{ranks}/{channels} "
                         f"outside 1..{MAX_BANKS}/{MAX_RANKS}/{MAX_CHANNELS}")
    if traces.numel():
        bank = traces[..., 0]
        if int(bank.min()) < 0 or int(bank.max()) >= B:
            raise ValueError(f"trace banks must lie in [0, {B})")
    kw = dict(ranks=ranks, channels=channels, tbl=tbl, trrd=trrd, tfaw=tfaw,
              use_bus=use_bus, use_act=use_act)
    if traces.device.type == "cpu":
        return memsim_walk_ref(traces, tc, queue=queue, **kw)
    return _launch(traces, tc, min(queue, traces.shape[1]),
                   route=walk_route(traces, B, ranks, channels), **kw)


memsim_walk.launches = 0
memsim_walk.route_launches = dict.fromkeys(ROUTES, 0)
