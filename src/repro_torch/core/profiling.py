"""DIVA Profiling (Section 6.1) vs conventional profiling.

DIVA Profiling tests ONLY the latency test region — the design-induced
slowest rows (mat-edge rows, one per 512-row subarray, at the worst mat
position) — walking each timing parameter down a grid and returning the
smallest value with zero failures, plus a one-cycle guardband. Because the
test region is the design-worst, every other (data) row is at least as fast:
the returned operating point is safe for the whole DIMM. Conventional
profiling reaches the same operating point by testing EVERY row — 512x the
cost (Appendix A: 625 ms vs 1.22 ms per pattern for a 4GB DIMM).

The counterpart of ``repro.core.profiling`` for the main path:
``diva_profile`` / ``conventional_profile`` run the batched sweep of
core/substrate.py on a one-DIMM batch, and ``diva_operating_point`` its
operating-point sweep; the numpy walkers (``diva_profile_loop`` /
``conventional_profile_loop``) are the per-DIMM references it reproduces
decision for decision.  ``DivaProfiler``, ``ALDRAM`` and ``lifetime_loop``
are not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.errors import DEFAULT_ITERS, DEFAULT_PATTERNS, DimmModel
from repro_torch.core.latency import worst_rows_internal
from repro_torch.core.substrate import (DimmBatch,
                                        operating_points_population,
                                        profile_population)
from repro_torch.core.timing import (CYCLE_NS, STANDARD, VDD_STD,
                                     OperatingPoint, TimingParams, timing_grid)


# ------------------------------------------------------------- cost model

def profiling_time_s(n_bytes_tested: int, patterns: int = 1,
                     bandwidth_bps: float = 102.4e9) -> float:
    """Appendix A: t = bytes/bandwidth * patterns * 2 (write + read-verify).

    4GB DIMM @ DDR3-1600 (102.4 Gbps): 625 ms; DIVA's 8MB test region: 1.22ms.
    """
    return n_bytes_tested * 8 / bandwidth_bps * patterns * 2


def diva_test_bytes(dimm_bytes: int, rows_per_subarray: int = 512) -> int:
    return dimm_bytes // rows_per_subarray


# ------------------------------------------------- batched profilers (hot)

def diva_profile(dimm: DimmModel, *, temp_C=55.0, refresh_ms=64.0,
                 guard_cycles: int = 1, with_ecc: bool = True,
                 device=None) -> TimingParams:
    """Profile only the latency test region (slowest rows per subarray).
    With ECC (the DIVA-DRAM configuration), the criterion is no *multi-bit*
    errors — random singles are SECDED-correctable (Sec 6.1)."""
    return profile_population(DimmBatch.from_population([dimm], device),
                              region="worst", temp_C=temp_C,
                              refresh_ms=refresh_ms, guard_cycles=guard_cycles,
                              multibit_only=with_ecc)[0]


def diva_operating_point(dimm: DimmModel, *, temp_C=55.0, refresh_ms=64.0,
                         vdd=VDD_STD, guard_cycles: int = 1,
                         with_ecc: bool = True, device=None,
                         **kw) -> OperatingPoint:
    """N-axis DIVA profiling of one DIMM: the timing table plus the safe
    supply voltage and refresh interval (each non-timing axis swept one knob
    at a time at standard timing, with the retention channel live) as one
    ``OperatingPoint`` — the per-DIMM face of
    ``substrate.operating_points_population``."""
    return operating_points_population(
        DimmBatch.from_population([dimm], device), temp_C=temp_C,
        refresh_ms=refresh_ms, vdd=vdd, guard_cycles=guard_cycles,
        multibit_only=with_ecc, **kw)[0]


def conventional_profile(dimm: DimmModel, *, temp_C=55.0, refresh_ms=64.0,
                         guard_cycles: int = 1, device=None) -> TimingParams:
    """Profile every row (the expensive reference)."""
    return profile_population(DimmBatch.from_population([dimm], device),
                              region="all", temp_C=temp_C,
                              refresh_ms=refresh_ms, guard_cycles=guard_cycles)[0]


# ------------------------------------------------- legacy NumPy walkers

def _min_safe(dimm: DimmModel, param: str, rows_internal, *, temp_C, refresh_ms,
              guard_cycles: int = 1, patterns=DEFAULT_PATTERNS,
              iters=DEFAULT_ITERS, floor: float = 5.0,
              multibit_only: bool = False) -> float:
    """Smallest grid value whose test of ``rows_internal`` shows no errors,
    plus guardband. Walks downward and stops at the first failing step."""
    best = getattr(STANDARD, param)
    for t_op in timing_grid(param):
        if t_op < floor - 1e-9:
            break  # infrastructure bound (Sec 4)
        if dimm.region_has_errors(param, t_op, rows_internal, temp_C=temp_C,
                                  refresh_ms=refresh_ms, patterns=patterns,
                                  iters=iters, multibit_only=multibit_only):
            break
        best = t_op
    return min(best + guard_cycles * CYCLE_NS, getattr(STANDARD, param))


def _profile_loop(dimm: DimmModel, rows, *, temp_C, refresh_ms, guard_cycles,
                  multibit_only: bool = False, patterns=DEFAULT_PATTERNS,
                  iters=DEFAULT_ITERS) -> TimingParams:
    """tRCD first; tRAS's sweep floor then tracks the reduced tRCD + 10 ns
    (the infrastructure constraint of Section 4)."""
    kw = dict(temp_C=temp_C, refresh_ms=refresh_ms, guard_cycles=guard_cycles,
              multibit_only=multibit_only, patterns=patterns, iters=iters)
    trcd = _min_safe(dimm, "trcd", rows, **kw)
    tras = _min_safe(dimm, "tras", rows, floor=trcd + 10.0, **kw)
    trp = _min_safe(dimm, "trp", rows, **kw)
    twr = _min_safe(dimm, "twr", rows, **kw)
    return TimingParams(trcd=trcd, tras=tras, trp=trp, twr=twr)


def diva_profile_loop(dimm: DimmModel, *, temp_C=55.0, refresh_ms=64.0,
                      guard_cycles: int = 1,
                      with_ecc: bool = True) -> TimingParams:
    """The serial per-DIMM walker (reference / benchmark baseline)."""
    return _profile_loop(dimm, worst_rows_internal(dimm.geom), temp_C=temp_C,
                         refresh_ms=refresh_ms, guard_cycles=guard_cycles,
                         multibit_only=with_ecc)


def conventional_profile_loop(dimm: DimmModel, *, temp_C=55.0, refresh_ms=64.0,
                              guard_cycles: int = 1) -> TimingParams:
    return _profile_loop(dimm, np.arange(dimm.geom.rows_per_mat), temp_C=temp_C,
                         refresh_ms=refresh_ms, guard_cycles=guard_cycles)


# ------------------------------------------------------------- reporting

def latency_reduction(t: TimingParams) -> dict:
    """Fig 18 metric: read/write latency reduction vs standard timings."""
    read = 1.0 - t.read_latency_ns() / STANDARD.read_latency_ns()
    write = 1.0 - t.write_latency_ns() / STANDARD.write_latency_ns()
    return {"read_reduction": read, "write_reduction": write,
            "read_cycles_saved": STANDARD.read_cycles() - t.read_cycles(),
            "write_cycles_saved": STANDARD.write_cycles() - t.write_cycles()}
