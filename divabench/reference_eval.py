"""The plain reference of the paper's two evaluations of a profiled
population: DIVA Shuffling under SECDED (Sec 6.2, Fig 17) and the system
speedup of the profiled timings (Sec 6.3, Fig 19).

Written from the paper and the model's rules in plain torch and numpy, on
any device; it imports nothing of the program and takes nothing the program
made.  The benchmark's inputs (``population.py``) and the model's frozen
pieces (``model/``, ``reference.py``'s failure grids) are its only sources.

  * ``burst_profile``  — (D, 9, 64) per-access error probability of each
    burst bit: the row-average failure probability of the (mat, column) a
    bit reads (Fig 5, Fig 12), the ECC chip taking the data chips' mean.
  * ``codeword_counts`` — Fig 17: error draws over the 576 lanes of a
    burst, laid out in the eight 72-bit codewords without and with DIVA
    Shuffling, each codeword scored by its error weight and its SECDED
    syndrome.
  * ``make_traces``, ``table_cycles``, ``walk_totals`` — Fig 19: the model's
    synthetic workload traces and the FR-FCFS walk of every (timing table,
    workload) pair at once, as integer total latencies.
  * ``speedups``       — the memory-stall IPC model scored from the totals.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from divabench.model.geometry import DimmGeometry, burst_bit_to_mat
from divabench.model.hashing import burst_uniform_t, trace_uniform
from divabench.model.latency import PATTERN_STRESS
from divabench.model.timing import (CYCLE_NS, PARAMS, TBL_CYCLES, TCL_NS,
                                    TCWL_NS, TFAW_CYCLES, TRRD_CYCLES)
from divabench.reference import (_geom_consts, cell_probs, condition_adders,
                                 pack_coeffs, to_tensors)

# ------------------------------------------------------------ SECDED(72,64)

# The Hsiao code's parity-check matrix H, one column per codeword bit, each
# column as its 8 check bits packed (bit k = check bit k): the 56 weight-3
# columns of 8 bits in lexicographic order of their set bits, then the
# first 8 weight-5 columns, for the 64 data bits; the identity for the 8
# check bits.  A codeword's syndrome is the XOR of the columns of its set
# bits: 0 for a clean word, a column for a single error, and for two or
# more errors any value, 0 included (an undetected error).
H_COLUMNS = (
    0x07, 0x0B, 0x13, 0x23, 0x43, 0x83, 0x0D, 0x15, 0x25, 0x45, 0x85, 0x19,
    0x29, 0x49, 0x89, 0x31, 0x51, 0x91, 0x61, 0xA1, 0xC1, 0x0E, 0x16, 0x26,
    0x46, 0x86, 0x1A, 0x2A, 0x4A, 0x8A, 0x32, 0x52, 0x92, 0x62, 0xA2, 0xC2,
    0x1C, 0x2C, 0x4C, 0x8C, 0x34, 0x54, 0x94, 0x64, 0xA4, 0xC4, 0x38, 0x58,
    0x98, 0x68, 0xA8, 0xC8, 0x70, 0xB0, 0xD0, 0xE0, 0x1F, 0x2F, 0x4F, 0x8F,
    0x37, 0x57, 0x97, 0x67,
    0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80)
CHECK_BITS, CODE_BITS = 8, 72


def syndrome_values(words: torch.Tensor) -> torch.Tensor:
    """(..., 72) 0/1 codeword error patterns -> (...,) int64 syndromes: each
    check bit is the parity of the word's bits whose H column sets it."""
    h = torch.as_tensor([[(c >> k) & 1 for k in range(CHECK_BITS)]
                         for c in H_COLUMNS], dtype=torch.float32,
                        device=words.device)                    # (72, 8)
    parity = (words.to(torch.float32) @ h).to(torch.int64) % 2   # exact
    return (parity << torch.arange(CHECK_BITS, device=words.device)).sum(-1)


# ------------------------------------------------- the burst and its layout

CHIPS, BURST_BITS, BEATS, DQ = 9, 64, 8, 8   # 8 data chips and the ECC chip
LANES = CHIPS * BURST_BITS                   # 576 lanes a column access


def burst_layout(shuffle: bool) -> np.ndarray:
    """(576,) source lane of each codeword position: position ``72 b + p``
    of the burst's ``b``-th codeword reads lane ``64 c + j`` (chip c, burst
    bit j).  A chip sends bit j in beat j // 8 on pin j % 8, and beat b is
    codeword b: data chip c fills positions 8c..8c+7, the ECC chip the check
    positions 64..71.  DIVA Shuffling sends data chip c's bit j in beat
    (j // 8 + c) % 8, so the chips' design-induced weak bits, which share
    their burst positions, land in different codewords."""
    src = np.empty(LANES, np.int64)
    for c in range(CHIPS):
        for j in range(BURST_BITS):
            beat = j // DQ
            if shuffle and c < CHIPS - 1:
                beat = (beat + c) % BEATS
            src[beat * CODE_BITS + c * DQ + j % DQ] = c * BURST_BITS + j
    return src


COUNT_KEYS = ("total", "corrected_no_shuffle", "corrected_shuffle",
              "uncorrectable_no_shuffle", "uncorrectable_shuffle",
              "undetected_no_shuffle", "undetected_shuffle")


def codeword_counts(profile, seeds, n_accesses: int, *, device,
                    shuffle: bool = True, block: int = 16) -> dict:
    """Fig 17 for (D, 9, 64) burst profiles: each DIMM's ``n_accesses``
    column accesses draw an error on lane l of access a where
    ``burst_uniform(seed, a, l)`` lies below the lane's probability; the
    error lanes, laid out in codewords without and with DIVA Shuffling
    (``shuffle=False`` lays out both modes unshuffled), give per DIMM the
    errors drawn and the codewords with one error (corrected), with more
    (uncorrectable), and with more and a zero syndrome (undetected).
    Returns ``COUNT_KEYS`` -> (D,) int64 numpy."""
    profile = torch.as_tensor(np.asarray(profile, np.float32), device=device)
    seeds = torch.as_tensor(np.asarray(seeds, np.int64), device=device)
    D = profile.shape[0]
    acc = torch.arange(n_accesses, device=device)[None, :, None]
    lane = torch.arange(LANES, device=device)[None, None, :]
    layouts = [torch.as_tensor(burst_layout(s), device=device)
               for s in (False, shuffle)]
    out = {k: [] for k in COUNT_KEYS}
    for lo in range(0, D, block):
        p = profile[lo:lo + block].reshape(-1, 1, LANES)
        u = burst_uniform_t(seeds[lo:lo + block, None, None], acc, lane)
        errs = (u < p).to(torch.int32)                       # (d, n, 576)
        del u
        out["total"].append(errs.sum(dim=(1, 2)))
        for mode, src in zip(("no_shuffle", "shuffle"), layouts):
            words = errs[:, :, src].reshape(errs.shape[0], -1, CODE_BITS)
            weight = words.sum(dim=2)
            silent = syndrome_values(words) == 0
            out[f"corrected_{mode}"].append((weight == 1).sum(dim=1))
            out[f"uncorrectable_{mode}"].append((weight > 1).sum(dim=1))
            out[f"undetected_{mode}"].append(((weight > 1) & silent)
                                             .sum(dim=1))
            del words
    return {k: torch.cat(v).to(torch.int64).cpu().numpy()
            for k, v in out.items()}


def burst_profile(leaves: dict, geom: DimmGeometry, param: str, t_op: float,
                  *, device, dtype=torch.float32, temp_C: float = 85.0,
                  refresh_ms: float = 64.0, pattern: str = "0101",
                  subarray: int = 0, block: int = 32) -> np.ndarray:
    """(D, 9, 64) float32: burst bit j of data chip c reads mat
    ``burst_bit_to_mat(j)`` at column ``w * C / k + C / (2 k)`` (its ``w``-th
    of the ``k`` bits a mat gives a burst); its per-access error probability
    is that cell column's failure probability averaged over the subarray's
    rows, from chip c's grid at the operating point.  The ECC chip's bits
    take the mean of the data chips'.  Grids in blocks of ``block`` DIMMs."""
    pidx = PARAMS.index(param)
    C, k = geom.cols_per_mat, geom.bits_per_mat_in_burst
    bits = np.arange(geom.burst_bits)
    mats = torch.as_tensor(burst_bit_to_mat(geom, bits), device=device)
    cols = torch.as_tensor((bits % k) * (C // k) + C // (2 * k),
                           device=device)
    adders = condition_adders(leaves, temp_C, refresh_ms)
    stress = np.float32(PATTERN_STRESS[pattern])
    D = len(leaves["serial"])
    out = np.zeros((D, CHIPS, geom.burst_bits), np.float32)
    for lo in range(0, D, block):
        part = {key: v[lo:lo + block] for key, v in leaves.items()}
        L = to_tensors(part, device, dtype)
        _, d_mat, _ = _geom_consts(geom, device, dtype)
        adder = torch.as_tensor(adders[lo:lo + block], device=device).to(dtype)
        for chip in range(geom.chips):
            cf = pack_coeffs(L, pidx, t_op, stress, adder, chip, subarray)
            grids = cell_probs(L["row_src"][:, subarray], d_mat, cf, C,
                               geom.open_bitline)
            out[lo:lo + block, chip] = (grids.mean(dim=2)[:, mats, cols]
                                        .float().cpu().numpy())
            del grids
    out[:, CHIPS - 1] = out[:, :geom.chips].mean(axis=1)
    return out


# ---------------------------------------------------- the memory system

@dataclass(frozen=True)
class Workload:
    """A synthetic workload: DRAM requests per kilo-instruction, the share
    of requests that hit the bank's open row, the share of writes, and the
    IPC with a perfect memory system."""
    name: str
    mpki: float
    row_hit_rate: float
    write_frac: float = 0.3
    ipc_peak: float = 2.0


# the model's 12 workloads of the Fig 19 evaluation
WORKLOADS = (
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
)
CPU_GHZ = 3.2        # Table 1's core clock
MLP_OVERLAP = 0.55   # the share of a miss's stall that other work hides


@dataclass(frozen=True)
class MemorySystem:
    """Bank b sits on channel ``b % channels`` and rank ``(b // channels) %
    ranks``; a request waits in a ``queue``-deep queue.  ``bus``: each
    channel's data bus carries one burst (tBL) at a time; ``act_window``:
    a rank's activations keep tRRD apart and at most four fall in any
    tFAW."""
    ranks: int = 2
    channels: int = 2
    queue: int = 8
    bus: bool = True
    act_window: bool = True


FRFCFS = MemorySystem()
# the in-order walk: one request at a time, no bus or activation limits
IN_ORDER = MemorySystem(ranks=1, channels=1, queue=1, bus=False,
                        act_window=False)


def make_traces(n: int, banks: int, seed: int) -> np.ndarray:
    """(W, n, 4) int32 requests [bank, row, write, arrive] of the workloads,
    workload w from stream ``seed + w``: request i draws lanes 0-3 of
    ``trace_uniform(stream, i, lane)`` for its bank, whether it means to hit
    the bank's open row, whether it writes, and its gap after the previous
    request (geometric at the workload's requests a cycle, at least 1).  A
    bank's first request and every intended miss open a new row."""
    out = []
    i = np.arange(n, dtype=np.uint32)
    for w, wl in enumerate(WORKLOADS):
        s = seed + w
        bank = (trace_uniform(s, i, 0) * np.float32(banks)).astype(np.int32)
        hit = trace_uniform(s, i, 1) < np.float32(wl.row_hit_rate)
        write = (trace_uniform(s, i, 2) < np.float32(wl.write_frac)) \
            .astype(np.int32)
        p = min(wl.mpki / 1000.0 * wl.ipc_peak, 0.99)
        u = trace_uniform(s, i, 3).astype(np.float64)
        gaps = (np.floor(np.log1p(-u) / np.log1p(-p)) + 1.0).astype(np.int32)
        row = np.zeros(n, np.int32)
        for b in range(banks):
            idx = np.flatnonzero(bank == b)
            if idx.size:
                opens = ~hit[idx]
                opens[0] = True
                row[idx] = np.cumsum(opens)
        out.append(np.stack([bank, row, write,
                             np.cumsum(gaps).astype(np.int32)], axis=1))
    return np.stack(out)


def table_cycles(tables, banks: int) -> np.ndarray:
    """(T, 4) ns timing tables in tRCD, tRAS, tRP, tWR order -> (T, banks,
    6) int32 bus cycles [tRCD, tRAS, tRP, tWR, tCL, tCWL], every bank of a
    table alike (each ns value rounded to the nearest 1.25 ns cycle)."""
    a = np.asarray(tables, np.float64)
    cyc = [[round(float(v) / CYCLE_NS) for v in row]
           + [round(TCL_NS / CYCLE_NS), round(TCWL_NS / CYCLE_NS)]
           for row in a]
    return np.repeat(np.asarray(cyc, np.int32)[:, None, :], banks, axis=1)


# a request's fields in the walk, in their order
_F = ("bank", "row", "write", "arrive", "rank", "chan", "trp", "trcd",
      "tras", "twr", "tcol", "valid", "order")
_NEG = -(10 ** 6)                    # "long ago" for precharge and ACT times


def walk_totals(traces, cycles, system: MemorySystem = FRFCFS, *,
                device, row_hits_first: bool = True) -> np.ndarray:
    """(W, n, 4) traces and (T, B, 6) cycle tables -> (T, W) int64 total
    latency of every (table, trace) walk, all walks stepped together.

    A step serves one queued request.  A request's latency runs from its
    arrival to its data's end: it waits for its bank; a row miss waits for
    the precharge (tRP after the bank's precharge-ready time) and, with the
    activation window, for tRRD after the rank's last activation and tFAW
    after the oldest of its last four; then tRCD to the column command
    (none on a hit), tCL or tCWL to the data, and with the bus the channel's
    previous burst and tBL.  The bank's row closes tRAS after its
    activation, a write's not before tWR after its data.  The scheduler
    serves requests that have arrived by the last column command before
    those that have not, among those row hits first (FR-FCFS; plain
    first-come first-served with ``row_hits_first=False``), then the oldest
    arrival, then the earlier request of the trace.  The served slot takes
    the trace's next request."""
    traces = torch.as_tensor(np.asarray(traces), dtype=torch.int64,
                             device=device)
    tc = torch.as_tensor(np.asarray(cycles), dtype=torch.int64, device=device)
    W, n, _ = traces.shape
    T, B, _ = tc.shape
    N, Q, R, C = T * W, min(system.queue, n), system.ranks, system.channels
    i64 = dict(dtype=torch.int64, device=device)
    # every request's fields for every walk (walk t * W + w), then Q padding
    # requests that never win
    tr = traces.repeat(T, 1, 1)                                  # (N, n, 4)
    bank, write = tr[..., 0], tr[..., 2]
    rows = tc.repeat_interleave(W, dim=0).gather(
        1, bank[..., None].expand(N, n, 6))                      # (N, n, 6)
    idx = torch.arange(n, **i64).expand(N, n)
    fields = torch.stack([
        bank, tr[..., 1], write, tr[..., 3], (bank // C) % R, bank % C,
        rows[..., 2], rows[..., 0], rows[..., 1], rows[..., 3],
        torch.where(write == 1, rows[..., 5], rows[..., 4]),
        torch.ones_like(bank),
        (((1 << 31) - 1 - tr[..., 3]) << 25) | ((1 << 25) - 1 - idx)], -1)
    del tr, rows, idx
    # step-major: row Q + s is the request every walk's step s takes in
    fields = torch.cat([fields, torch.zeros((N, Q, len(_F)), **i64)], dim=1)
    fields = fields.transpose(0, 1).contiguous()                 # (n+Q, N, F)
    q = fields[:Q].transpose(0, 1).contiguous()                  # (N, Q, F)
    nxt = torch.full((1,), Q, **i64)           # the next request, on device
    bank_state = torch.tensor([-1, 0, _NEG], **i64).repeat(N, B, 1)
    bus = torch.zeros((N, C), **i64)
    rank_state = torch.full((N, R, 5), _NEG, **i64)  # last ACT, 4 ACTs sorted
    t_now = torch.zeros((N, 1), **i64)
    total = torch.zeros(N, **i64)
    lanes = torch.arange(N, device=device)
    hits_first = int(row_hits_first)

    def step():
        """One step of every walk, in place on the device."""
        (q_bank, q_row, q_write, q_arr, q_rank, q_chan, trp, trcd, tras, twr,
         tcol, valid, order) = q.unbind(-1)
        st = bank_state.gather(1, q_bank[..., None].expand(N, Q, 3))
        open_row, ready, pre_ready = st.unbind(-1)
        start = torch.maximum(q_arr, ready)
        hit = (open_row == q_row).to(torch.int64)
        t_act = torch.maximum(start, pre_ready) + trp
        if system.act_window:
            rk = rank_state.gather(1, q_rank[..., None].expand(N, Q, 2))
            t_act = torch.maximum(t_act, torch.maximum(
                rk[..., 0] + TRRD_CYCLES, rk[..., 1] + TFAW_CYCLES))
        t_col = torch.where(hit == 1, start, t_act + trcd)
        done = t_col + tcol
        if system.bus:
            done = torch.maximum(done, bus.gather(1, q_chan)) + TBL_CYCLES
        closes = torch.where(hit == 1, pre_ready, t_act + tras)
        closes = torch.where(q_write == 1,
                             torch.maximum(closes, done + twr), closes)
        # serve first: the largest (class, -arrival, -trace index), packed
        arrived = (q_arr <= t_now).to(torch.int64)
        cls = valid * (1 + arrived * (1 + hit * hits_first))
        w = ((cls << 57) | order).argmax(dim=1)                  # (N,)
        won = torch.stack([q_bank, q_row, done, closes, t_act, t_col,
                           done - q_arr, hit, q_rank, q_chan], -1)[lanes, w]
        wb, wrow, wdone, wclose, wact, wcol, wlat, whit, wr, wc = won.unbind(1)
        bank_state[lanes, wb] = torch.stack([wrow, wdone, wclose], 1)
        if system.bus:
            bus[lanes, wc] = wdone
        if system.act_window:
            old = rank_state[lanes, wr]                          # (N, 5)
            ring = torch.sort(torch.cat([old[:, 2:], wact[:, None]], 1),
                              dim=1).values
            new = torch.cat([torch.maximum(old[:, :1], wact[:, None]), ring],
                            1)
            rank_state[lanes, wr] = torch.where(whit[:, None] == 0, new, old)
        torch.maximum(t_now, wcol[:, None], out=t_now)
        total.add_(wlat)
        q[lanes, w] = fields.index_select(0, nxt)[0]
        nxt.add_(1)

    _repeat(step, n, torch.device(device))
    return total.view(T, W).cpu().numpy()


def _repeat(step, n: int, device: torch.device, graph_steps: int = 250):
    """``step()`` ``n`` times.  On a CUDA device the steps' few hundred
    small operations are replayed from a CUDA graph of ``graph_steps``
    captured steps (the same operations, without their launches' host
    time), after one step run as the warm-up that capture needs."""
    if device.type != "cuda" or n < 2 * graph_steps:
        for _ in range(n):
            step()
        return
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(graph_steps):
            step()
    reps, rest = divmod(n - 1, graph_steps)
    for _ in range(reps):
        graph.replay()
    for _ in range(rest):
        step()


def speedups(totals, n: int, dtype=torch.float32) -> np.ndarray:
    """(1 + D, W) total latencies, the base table's first -> (D,) float64
    mean over the workloads of each table's IPC over the base's.  A
    workload's IPC is ``1 / (1 / ipc_peak + mpki / 1000 * stall)``, its
    stall the mean latency in bus cycles times the CPU cycles a bus cycle
    lasts times the share of the stall left exposed (``1 - MLP_OVERLAP``);
    every step in ``dtype``."""
    f = lambda v: torch.as_tensor(v, dtype=dtype)
    mpki1k = f([w.mpki / 1000.0 for w in WORKLOADS])
    inv_peak = f([1.0 / w.ipc_peak for w in WORKLOADS])
    scale = f(CPU_GHZ * CYCLE_NS) * f(1.0 - MLP_OVERLAP)
    avg = torch.as_tensor(np.asarray(totals)).to(dtype) * f(1.0 / n)
    ipc = 1.0 / (inv_peak + mpki1k * (avg * scale))
    ratios = ipc[1:] / ipc[0]
    return ratios.to(torch.float64).mean(dim=1).numpy()
