"""Memory-system simulator on PyTorch: FR-FCFS over channel -> rank -> bank
and the IPC model of Fig 19 (Sec 6.3).

The counterpart of ``repro.memsim.sim``.  Workloads are synthetic (MPKI,
row-hit-rate, write-fraction) tuples; every per-request draw comes from the
``trace_uniform`` counter hash keyed by (seed, request index), so traces are
built on the host in numpy and are the reference's bit for bit.

The FR-FCFS grid — a bounded request queue arbitrated row-hit-first /
oldest-first, tBL data-bus contention per channel and tRRD/tFAW activation
windows per rank, every request charged its own bank's timing row — runs as
ONE ``memsim_walk`` call over all (timing table x workload) walks: the
hand-written CUDA kernel on the card (``kernels/csrc/bank_sched.cu``), the
plain PyTorch walk on the CPU.  ``inorder_config`` (a 1-deep queue with the
bus/activation constraints off) is the reference's retained in-order walker
request for request; ``simulate_trace`` and the ``config=None`` default of
``evaluate_system_grid`` run it through the same walk.

Metrics reduce on the walk's device (int32 totals, one float32 multiply by a
host reciprocal, a nearest-rank p99).  The IPC model scores the exact
integer totals on the host in numpy float32, in one fixed operation order,
so the card and the CPU give the same speedups from the same totals.

Entry points take ``device=None`` (the current CUDA device; raises without
one) or an explicit device; ``system_speedup_population`` also takes
``mesh=``, which shards its DIMM tables over the mesh's devices.  Not
ported: the ``N_TRACES`` retrace counter (eager PyTorch never retraces).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hashing import mix_uniform, trace_uniform
from repro_torch.core.substrate import _dispatch
from repro_torch.core.timing import (CYCLE_NS, PARAMS, STANDARD, TBL_CYCLES,
                                     TCL_NS, TCWL_NS, TFAW_CYCLES, TRRD_CYCLES,
                                     TimingParams)
from repro_torch.device import resolve_device
from repro_torch.kernels.bank_sched import bank_maps, memsim_walk
from repro_torch.sharding import DimmMesh, mesh_device

CPU_GHZ = 3.2  # Table 1


@dataclass(frozen=True)
class Workload:
    name: str
    mpki: float           # misses (DRAM requests) per kilo-instruction
    row_hit_rate: float   # fraction of accesses hitting the open row
    write_frac: float = 0.3
    ipc_peak: float = 2.0  # IPC with a perfect memory system


# A 2-wide-ish OoO core: memory stalls partially overlap (MLP factor).
MLP_OVERLAP = 0.55

WORKLOADS = [
    Workload("stream-copy", 28.0, 0.85, 0.45),
    Workload("stream-triad", 25.0, 0.80, 0.35),
    Workload("gups", 32.0, 0.05, 0.50, ipc_peak=1.4),
    Workload("mcf-like", 18.0, 0.30, 0.15, ipc_peak=1.2),
    Workload("lbm-like", 14.0, 0.65, 0.40),
    Workload("libquantum-like", 22.0, 0.75, 0.10),
    Workload("omnetpp-like", 8.0, 0.40, 0.25, ipc_peak=1.6),
    Workload("tpcc-like", 10.0, 0.35, 0.30, ipc_peak=1.5),
    Workload("tpch-like", 12.0, 0.55, 0.20),
    Workload("soplex-like", 16.0, 0.45, 0.25, ipc_peak=1.4),
    Workload("milc-like", 11.0, 0.60, 0.35),
    Workload("low-mem", 1.5, 0.50, 0.30, ipc_peak=2.4),
]


@dataclass(frozen=True)
class MemSimConfig:
    """Memory-system shape and scheduler knobs.

    Bank b lives on channel ``b % channels`` and rank ``(b // channels) %
    ranks``.  ``bus`` enables tBL data-bus serialization per channel;
    ``act_window`` enables the tRRD/tFAW activation constraints per rank.
    ``queue`` is at most 32 (one queue slot per lane of the kernel's warp).
    """
    banks: int = 16
    ranks: int = 2
    channels: int = 2
    queue: int = 8
    bus: bool = True
    act_window: bool = True
    tbl: int = TBL_CYCLES
    trrd: int = TRRD_CYCLES
    tfaw: int = TFAW_CYCLES


def inorder_config(banks: int = 16) -> MemSimConfig:
    """The compat mode: a 1-deep queue with bus/activation constraints off
    degenerates FR-FCFS to the retained in-order walker, request for
    request."""
    return MemSimConfig(banks=banks, ranks=1, channels=1, queue=1,
                        bus=False, act_window=False)


def _bank_maps(cfg: MemSimConfig):
    """(rank, channel) of every bank under ``cfg``."""
    return bank_maps(cfg.banks, cfg.ranks, cfg.channels)


def _walk_kw(cfg: MemSimConfig) -> dict:
    return dict(queue=cfg.queue, ranks=cfg.ranks, channels=cfg.channels,
                tbl=cfg.tbl, trrd=cfg.trrd, tfaw=cfg.tfaw, use_bus=cfg.bus,
                use_act=cfg.act_window)


# ------------------------------------------------------------------ traces

#: the fields of a request, in the order of the packed (n, 4) trace rows
TRACE_KEYS = ("bank", "row", "write", "arrive")


def _rows_from_loop(bank: np.ndarray, hit: np.ndarray,
                    banks: int) -> np.ndarray:
    """Per-bank Python loop (the retained reference): row id = running miss
    count within the bank — a miss opens a fresh row, a hit reuses the id of
    the bank's last miss; the first touch of a bank is always a miss."""
    row = np.zeros(len(bank), np.int32)
    for b in range(banks):
        idx = np.flatnonzero(bank == b)
        if idx.size == 0:
            continue
        h = hit[idx].copy()
        h[0] = False
        row[idx] = np.cumsum(~h)
    return row


def _rows_from(bank: np.ndarray, hit: np.ndarray) -> np.ndarray:
    """Grouped-cumsum vectorization of ``_rows_from_loop``: stable-sort by
    bank, force each group's first element to a miss, inclusive-cumsum the
    misses, subtract each group's pre-start total, scatter back."""
    n = len(bank)
    order = np.argsort(bank, kind="stable")
    miss = ~hit[order]
    first = np.empty(n, bool)
    first[0] = True
    first[1:] = bank[order][1:] != bank[order][:-1]
    miss = miss | first
    csum = np.cumsum(miss)
    gstart = np.flatnonzero(first)
    base = np.repeat(csum[gstart] - miss[gstart], np.diff(np.r_[gstart, n]))
    row = np.empty(n, np.int32)
    row[order] = (csum - base).astype(np.int32)
    return row


def _trace_draws(w: Workload, n: int, banks: int, seed: int):
    """The shared per-request draws: lanes 0-3 of the ``trace_uniform``
    counter hash keyed by (stream seed, request index)."""
    i = np.arange(n, dtype=np.uint32)
    bank = (trace_uniform(seed, i, 0) * np.float32(banks)).astype(np.int32)
    hit = trace_uniform(seed, i, 1) < np.float32(w.row_hit_rate)
    is_wr = (trace_uniform(seed, i, 2) < np.float32(w.write_frac)) \
        .astype(np.int32)
    # inter-arrival: geometric via inverse CDF from requests/cycle
    rate = w.mpki / 1000.0 * w.ipc_peak
    p = min(rate, 0.99)
    u = trace_uniform(seed, i, 3).astype(np.float64)
    gaps = (np.floor(np.log1p(-u) / np.log1p(-p)) + 1.0).astype(np.int32)
    arrive = np.cumsum(gaps).astype(np.int32)
    return bank, hit, is_wr, arrive


def make_trace(w: Workload, n: int, banks: int, seed: int = 0):
    """Synthetic request trace honouring ``w.row_hit_rate``: an intended hit
    targets the bank's most recently opened row (the first touch of a bank is
    always a miss), an intended miss opens a fresh row."""
    bank, hit, is_wr, arrive = _trace_draws(w, n, banks, seed)
    return {"bank": bank, "row": _rows_from(bank, hit), "write": is_wr,
            "arrive": arrive}


def make_trace_loop(w: Workload, n: int, banks: int, seed: int = 0):
    """The retained per-bank-loop reference of ``make_trace`` (same hash
    draws, O(banks*n) host time)."""
    bank, hit, is_wr, arrive = _trace_draws(w, n, banks, seed)
    return {"bank": bank, "row": _rows_from_loop(bank, hit, banks),
            "write": is_wr, "arrive": arrive}


def pack_trace(trace) -> np.ndarray:
    """A trace dict -> (n, 4) int32 rows in ``TRACE_KEYS`` order."""
    return np.stack([np.asarray(trace[k], np.int32) for k in TRACE_KEYS],
                    axis=-1)


def timing_cycles(t: TimingParams) -> np.ndarray:
    """(6,) int32 [tRCD, tRAS, tRP, tWR, tCL, tCWL] in memory-bus cycles."""
    return np.asarray([t.cycles(p) for p in PARAMS]
                      + [round(TCL_NS / CYCLE_NS), round(TCWL_NS / CYCLE_NS)],
                      np.int32)


def timing_cycles_banks(timing, banks: int) -> np.ndarray:
    """(banks, 6) int32 per-bank cycle rows for the FR-FCFS simulator.

    ``timing`` is a ``TimingParams`` (whole-DIMM: every bank gets the same
    row), or a (4,) / (Bp, 4) ns array in PARAMS order — ``Bp`` profiled
    bank groups are block-mapped onto the ``banks`` simulator banks (bank b
    reads profiled row ``b * Bp // banks``), so (D, Bp, 4) tables from
    ``profile_population_arrays(banks=...)`` plug in directly.
    """
    if isinstance(timing, TimingParams):
        rows = timing_cycles(timing)[None, :]
    else:
        a = np.asarray(timing, np.float64)
        if a.ndim == 1:
            a = a[None, :]
        if a.ndim != 2 or a.shape[-1] != len(PARAMS):
            raise ValueError(f"timing table must be (4,) or (banks, 4) ns; "
                             f"got shape {np.shape(timing)}")
        rows = np.stack([timing_cycles(TimingParams(*map(float, r)))
                         for r in a])
    bp = rows.shape[0]
    if bp > banks:
        raise ValueError(f"{bp} profiled bank groups > {banks} sim banks")
    idx = (np.arange(banks) * bp) // banks
    return rows[idx].astype(np.int32)


# Bound on the (n_requests, banks, seed, device) -> stacked-trace cache: each
# entry holds a (W, n, 4) device tensor, so an unbounded cache would grow
# with every distinct tuple a long sweep touches.  Within one sweep the tuple
# is constant and N_TRACE_BUILDS does not move; beyond the bound the
# least-recently-used entries are evicted and rebuilt on return.
TRACE_CACHE_MAX = 16
N_TRACE_BUILDS = 0


@functools.lru_cache(maxsize=TRACE_CACHE_MAX)
def _stack_traces_cached(n_requests: int, banks: int, seed: int,
                         device: torch.device) -> torch.Tensor:
    global N_TRACE_BUILDS
    N_TRACE_BUILDS += 1
    trs = [pack_trace(make_trace(w, n_requests, banks, seed + i))
           for i, w in enumerate(WORKLOADS)]
    return torch.as_tensor(np.stack(trs), device=device)


def _stack_traces(n_requests: int, banks: int, seed: int,
                  device) -> torch.Tensor:
    """(W, n, 4) int32 stacked traces of all WORKLOADS on ``device``, cached
    per (n_requests, banks, seed, device)."""
    return _stack_traces_cached(int(n_requests), int(banks), int(seed),
                                torch.device(device))


# ------------------------------------------------------- FR-FCFS simulator

def _reduce_metrics(lat, hit) -> dict:
    """(..., n) int32 latencies and hits -> exact int32 totals, one float32
    multiply by a host reciprocal each, and a nearest-rank p99."""
    n = int(lat.shape[-1])
    k = max(int(np.ceil(0.99 * n)) - 1, 0)
    total = lat.sum(dim=-1, dtype=torch.int32)
    hits = hit.sum(dim=-1, dtype=torch.int32)
    inv_n = float(np.float32(1.0 / n))
    return {"avg_latency_cycles": total.to(torch.float32) * inv_n,
            "p99_latency_cycles": torch.sort(lat, dim=-1).values[..., k]
                .to(torch.float32),
            "row_hit_rate": hits.to(torch.float32) * inv_n,
            "total_latency_cycles": total, "n_row_hits": hits}


def _memsim_grid(traces, tc_tables, cfg: MemSimConfig) -> dict:
    """traces (W, n, 4) and tc_tables (T, banks, 6) int32 on one device ->
    dict of (T, W) metrics: the whole grid as one ``memsim_walk`` call."""
    return _reduce_metrics(*memsim_walk(traces, tc_tables, **_walk_kw(cfg)))


def simulate(trace, timing, *, config: MemSimConfig | None = None,
             device=None) -> dict:
    """One trace through the FR-FCFS simulator under one (possibly per-bank)
    timing table; see ``timing_cycles_banks`` for accepted ``timing`` forms.
    """
    cfg = MemSimConfig() if config is None else config
    dev = resolve_device(device)
    traces = torch.as_tensor(pack_trace(trace)[None], device=dev)
    tc = torch.as_tensor(timing_cycles_banks(timing, cfg.banks)[None],
                         device=dev)
    met = _memsim_grid(traces, tc, cfg)
    return {k: (float(v[0, 0]) if v.dtype != torch.int32 else int(v[0, 0]))
            for k, v in met.items()}


def simulate_trace(trace, t: TimingParams, banks: int = 16,
                   device=None) -> dict:
    """The retained in-order walker's metrics (``inorder_config``) for one
    trace: mean latency and hit rate as ``simulate`` gives them, and p99 by
    linear interpolation (the reference's ``jnp.percentile``).  Latencies in
    memory-bus cycles (DDR3-1600)."""
    dev = resolve_device(device)
    traces = torch.as_tensor(pack_trace(trace)[None], device=dev)
    tc = torch.as_tensor(timing_cycles_banks(t, banks)[None], device=dev)
    lat, hit = memsim_walk(traces, tc, **_walk_kw(inorder_config(banks)))
    met = _reduce_metrics(lat[0, 0], hit[0, 0])
    p99 = torch.quantile(lat[0, 0].to(torch.float32), 0.99)
    return {"avg_latency_cycles": float(met["avg_latency_cycles"]),
            "p99_latency_cycles": float(p99),
            "row_hit_rate": float(met["row_hit_rate"])}


# --------------------------------------------------------- IPC/stall model

_LAT_SCALE = np.float32(CPU_GHZ * CYCLE_NS)     # bus cycles -> cpu cycles
_STALL_FRAC = np.float32(1.0 - MLP_OVERLAP)
# one fused constant: bus-cycle latency -> effective stall cpu cycles
_STALL_SCALE = np.float32(_LAT_SCALE * _STALL_FRAC)


def _wl_consts():
    """(W,) f32 per-workload constants of the IPC model."""
    mpki1k = np.asarray([np.float32(w.mpki / 1000.0) for w in WORKLOADS],
                        np.float32)
    inv_peak = np.asarray([np.float32(1.0 / w.ipc_peak) for w in WORKLOADS],
                          np.float32)
    return mpki1k, inv_peak


def ipc32(avg_lat, mpki1k, inv_peak):
    """Memory-stall IPC model in numpy float32:
    CPI = 1/IPC_peak + MPKI/1000 * stall_cycles."""
    stall = np.asarray(avg_lat, np.float32) * _STALL_SCALE
    cpi = inv_peak + mpki1k * stall
    return np.float32(1.0) / cpi


def _score(totals, *, n: int):
    """(T, W) int32 total latencies -> ((T, W) f32 IPC, (T-1, W) f32 speedup
    ratios vs row 0), on the host: every speedup path scores its exact
    integer totals here, in one operation order."""
    mpki1k, inv_peak = _wl_consts()
    avg = np.asarray(totals).astype(np.float32) * np.float32(1.0 / n)
    ipc_tw = ipc32(avg, mpki1k, inv_peak)
    return ipc_tw, ipc_tw[1:] / ipc_tw[0][None, :]


def ipc(w: Workload, avg_mem_lat_bus_cycles: float) -> float:
    """Single-workload convenience wrapper over ``ipc32``."""
    return float(ipc32(np.float32(avg_mem_lat_bus_cycles),
                       np.float32(w.mpki / 1000.0),
                       np.float32(1.0 / w.ipc_peak)))


def weighted_speedup(ipcs_new, ipcs_base) -> float:
    return float(sum(n / b for n, b in zip(ipcs_new, ipcs_base)))


# --------------------------------------------------------- system evaluation

def _grid_totals(tables, cfg: MemSimConfig, n_requests: int, seed: int,
                 device) -> np.ndarray:
    """(T, W) int32 total latencies of every table spec over all WORKLOADS:
    one ``memsim_walk`` call on ``device``."""
    dev = resolve_device(device)
    traces = _stack_traces(n_requests, cfg.banks, seed, dev)
    tcs = torch.as_tensor(np.stack([timing_cycles_banks(t, cfg.banks)
                                    for t in tables]), device=dev)
    return _memsim_grid(traces, tcs, cfg)["total_latency_cycles"].cpu().numpy()


def evaluate_system_grid(timings, *, n_requests: int = 20000, banks: int = 16,
                         seed: int = 0, config: MemSimConfig | None = None,
                         device=None) -> np.ndarray:
    """(T, W) float32 IPC matrix for T timing points over all WORKLOADS.
    ``config=None`` runs the retained in-order service rule; pass a
    ``MemSimConfig`` for the FR-FCFS scheduler."""
    cfg = inorder_config(banks) if config is None else config
    totals = _grid_totals(timings, cfg, n_requests, seed, device)
    return _score(totals, n=n_requests)[0]


def evaluate_system(t: TimingParams, *, n_requests: int = 20000,
                    banks: int = 16, seed: int = 0, config=None,
                    device=None) -> dict:
    """Per-workload IPC under timing t."""
    ipcs = evaluate_system_grid([t], n_requests=n_requests, banks=banks,
                                seed=seed, config=config, device=device)[0]
    return {w.name: float(v) for w, v in zip(WORKLOADS, ipcs)}


def speedup_summary(t_new: TimingParams, t_base: TimingParams = STANDARD,
                    cores: int = 4, seed: int = 0, ipcs=None, **kw) -> dict:
    """``ipcs`` short-circuits the simulation with a precomputed
    ``evaluate_system_grid([t_base, t_new], ...)`` result — only the
    ``cores``-dependent mix sampling reruns.  The 32 multi-core mixes
    (Sec 6.3) come from the ``mix_uniform`` hash stream keyed by (seed, mix
    draw, core slot)."""
    if ipcs is None:
        ipcs = evaluate_system_grid([t_base, t_new], seed=seed, **kw)
    base, new = ipcs[0], ipcs[1]
    names = [w.name for w in WORKLOADS]
    per_wl = {n: float(new[i] / base[i]) for i, n in enumerate(names)}
    draws = mix_uniform(seed, np.arange(32, dtype=np.uint32)[:, None],
                        np.arange(cores, dtype=np.uint32)[None, :])
    mixes = (draws * np.float32(len(names))).astype(np.int64)   # (32, cores)
    ws = [weighted_speedup(new[m], base[m]) / cores for m in mixes]
    return {"per_workload_speedup": per_wl,
            "mean_singlecore_speedup": float(np.mean(list(per_wl.values()))),
            "mean_weighted_speedup": float(np.mean(ws))}


def _resolve_tables(timings) -> list:
    """``timings`` -> list of per-DIMM table specs accepted by
    ``timing_cycles_banks``: a sequence of TimingParams, a (D, 4) ns array
    (whole-DIMM tables), or a (D, banks, 4) ns array (per-bank tables)."""
    if hasattr(timings, "ndim"):
        a = np.asarray(timings)
        if a.ndim not in (2, 3):
            raise ValueError(f"timing array must be (D, 4) or (D, banks, 4);"
                             f" got {a.shape}")
        return list(a)
    return [t if isinstance(t, TimingParams) else np.asarray(t)
            for t in timings]


def _scheduler_config(scheduler: str, banks: int) -> MemSimConfig:
    if scheduler == "frfcfs":
        return MemSimConfig(banks=banks)
    if scheduler == "inorder":
        return inorder_config(banks)
    raise ValueError(f"unknown scheduler {scheduler!r}")


def _speedup_impl(traces, tc_dimm, tc_base, *, cfg: MemSimConfig):
    """(D, 2, W) int32 [own-table, base-table] total latencies: base + D
    tables walked in one ``memsim_walk`` call.  Only ``tc_dimm`` is
    DIMM-shaped: with a mesh each shard walks the base row again and echoes
    its totals per DIMM, so that every output is DIMM-leading.  The totals
    are exact integers, so a sharded run gives the unsharded one's bits."""
    tc_all = torch.cat([tc_base[None], tc_dimm], dim=0)
    lat, _ = memsim_walk(traces, tc_all, **_walk_kw(cfg))
    tot = lat.sum(dim=-1, dtype=torch.int32)                     # (1+D, W)
    own = tot[1:]
    return torch.stack([own, tot[0][None].expand_as(own)], dim=1)


def _speedups(totals: np.ndarray, n_requests: int) -> dict:
    """(1 + D, W) int32 totals, base first -> the per-DIMM speedup dict."""
    _, ratios = _score(totals, n=n_requests)                    # (D, W) f32
    sp = ratios.astype(np.float64).mean(axis=1)
    return {"per_dimm_speedup": sp,
            "per_dimm_workload_speedup": ratios,
            "mean_speedup": float(sp.mean()),
            "median_speedup": float(np.median(sp)),
            "min_speedup": float(sp.min()), "max_speedup": float(sp.max()),
            "total_latency_cycles": totals}


def system_speedup_population(timings, t_base: TimingParams = STANDARD, *,
                              n_requests: int = 20000, banks: int = 16,
                              seed: int = 0, scheduler: str = "frfcfs",
                              config: MemSimConfig | None = None,
                              device=None,
                              mesh: DimmMesh | None = None) -> dict:
    """Per-DIMM (possibly per-bank) profiled timings -> per-DIMM mean system
    speedups: (base + D timing tables) x workloads simulated in ONE
    ``memsim_walk`` call, then scored from the integer totals.  ``mesh``
    shards the DIMM tables (one call a shard, each walking the base table
    too; traces replicate and are keyed by request index), gathers the
    totals and scores them once; ``device`` is then ignored.

    ``timings``: sequence of `TimingParams`, a (D, 4) ns array (whole-DIMM
    tables) or a (D, banks_profiled, 4) per-bank array from
    ``profile_population_arrays(banks=...)``.  ``scheduler``: "frfcfs"
    (default ``MemSimConfig``) or "inorder" (the retained walker);
    ``config`` overrides either.  Besides the reference's keys, the result
    carries ``total_latency_cycles``: the (1 + D, W) int32 totals, base
    first — the exact surface the speedups are scored from.
    """
    cfg = config if config is not None else _scheduler_config(scheduler, banks)
    dev = mesh_device(mesh, device)
    traces = _stack_traces(n_requests, cfg.banks, seed, dev)
    as_tc = lambda tables: torch.as_tensor(np.stack(
        [timing_cycles_banks(t, cfg.banks) for t in tables]), device=dev)
    out = _dispatch(mesh, _speedup_impl, (traces, as_tc(_resolve_tables(
        timings)), as_tc([t_base])[0]), dict(cfg=cfg), (1,)).cpu().numpy()
    totals = np.concatenate([out[:1, 1], out[:, 0]], axis=0)    # (1+D, W)
    return _speedups(totals, n_requests)
