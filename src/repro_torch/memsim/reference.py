"""Per-request numpy walkers: the references of the memsim grid.

A copy of ``repro.memsim.reference``.  ``simulate_trace_loop`` walks one
trace through the FR-FCFS scheduler one serviced request per Python step,
calling the SAME ``candidate_times`` formula (``kernels/bank_sched.py``) on
numpy arrays; all-int32 arithmetic plus the shared ``_reduce_metrics`` make it
equal to ``sim.simulate`` bit for bit.  ``system_speedup_loop`` is the
per-DIMM evaluation of ``system_speedup_population``, scored through the same
``_score`` from its integer totals.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.timing import STANDARD, TimingParams
from repro_torch.kernels.bank_sched import candidate_times
from repro_torch.memsim.sim import (WORKLOADS, MemSimConfig, _bank_maps,
                                    _reduce_metrics, _resolve_tables,
                                    _scheduler_config, _speedups, make_trace,
                                    timing_cycles_banks)

_BIG = 2 ** 30
_NEG = np.int32(-(10 ** 6))


def _walk(trace, tc_banks, cfg: MemSimConfig):
    """The per-request scheduler walk; returns (latency, hit) int32 arrays in
    service order."""
    n = len(trace["bank"])
    Q = min(cfg.queue, n)
    bank_rank, bank_chan = _bank_maps(cfg)
    tr = {k: np.asarray(v, np.int32) for k, v in trace.items()}
    q = {k: tr[k][:Q].copy() for k in ("bank", "row", "write", "arrive")}
    q_idx = np.arange(Q, dtype=np.int32)
    q_valid = np.ones(Q, bool)
    open_row = np.full(cfg.banks, -1, np.int32)
    ready = np.zeros(cfg.banks, np.int32)
    pre_ready = np.full(cfg.banks, _NEG, np.int32)
    bus_ready = np.zeros(cfg.channels, np.int32)
    last_act = np.full(cfg.ranks, _NEG, np.int32)
    faw = np.full((cfg.ranks, 4), _NEG, np.int32)
    t_now = np.int32(0)
    nxt = Q
    out_lat = np.empty(n, np.int32)
    out_hit = np.empty(n, np.int32)
    kkw = dict(tbl=cfg.tbl, trrd=cfg.trrd, tfaw=cfg.tfaw,
               use_bus=cfg.bus, use_act=cfg.act_window)

    for step in range(n):
        key, hit, t_act, t_col, done, new_pre, lat = candidate_times(
            q["bank"], q["row"], q["write"], q["arrive"], q_valid,
            open_row, ready, pre_ready, bus_ready, last_act, faw[:, 0],
            t_now, tc_banks, bank_rank, bank_chan, **kkw)
        c1 = key == key.max()
        arr_m = np.where(c1, q["arrive"], _BIG)
        c2 = c1 & (q["arrive"] == arr_m.min())
        w = int(np.argmin(np.where(c2, q_idx, _BIG)))
        wb = int(q["bank"][w])
        out_lat[step], out_hit[step] = lat[w], hit[w]
        open_row[wb] = q["row"][w]
        ready[wb] = done[w]
        pre_ready[wb] = new_pre[w]
        if cfg.bus:
            bus_ready[bank_chan[wb]] = done[w]
        if cfg.act_window and hit[w] == 0:
            r = bank_rank[wb]
            last_act[r] = max(int(last_act[r]), int(t_act[w]))
            faw[r] = np.sort(np.concatenate([faw[r, 1:], t_act[w:w + 1]]))
        t_now = np.maximum(t_now, t_col[w])
        src = min(nxt, n - 1)
        for k in q:
            q[k][w] = tr[k][src]
        q_idx[w] = nxt
        q_valid[w] = nxt < n
        nxt += 1
    return out_lat, out_hit


def _metrics(lat, hit) -> dict:
    return _reduce_metrics(torch.from_numpy(lat), torch.from_numpy(hit))


def simulate_trace_loop(trace, timing, *,
                        config: MemSimConfig | None = None) -> dict:
    """numpy reference of ``sim.simulate``: same metrics dict, bit for bit."""
    cfg = MemSimConfig() if config is None else config
    lat, hit = _walk(trace, timing_cycles_banks(timing, cfg.banks), cfg)
    return {k: (float(v) if v.dtype != torch.int32 else int(v))
            for k, v in _metrics(lat, hit).items()}


def system_speedup_loop(timings, t_base: TimingParams = STANDARD, *,
                        n_requests: int = 20000, banks: int = 16,
                        seed: int = 0, scheduler: str = "inorder",
                        config: MemSimConfig | None = None) -> dict:
    """Per-DIMM Python loop reference of ``sim.system_speedup_population``:
    every (DIMM table, workload) pair walked per request on the host; the
    integer totals are scored by the same ``_score``."""
    cfg = config if config is not None else _scheduler_config(scheduler, banks)
    tables = [t_base] + _resolve_tables(timings)
    traces = [make_trace(w, n_requests, cfg.banks, seed + i)
              for i, w in enumerate(WORKLOADS)]

    def totals_row(table):
        tc = timing_cycles_banks(table, cfg.banks)
        return np.asarray([int(_metrics(*_walk(tr, tc, cfg))
                               ["total_latency_cycles"]) for tr in traces],
                          np.int32)

    return _speedups(np.stack([totals_row(t) for t in tables]), n_requests)
