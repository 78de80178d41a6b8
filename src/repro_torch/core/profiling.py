"""DIVA Profiling (Section 6.1) vs conventional profiling.

DIVA Profiling tests ONLY the latency test region — the design-induced
slowest rows (mat-edge rows, one per 512-row subarray, at the worst mat
position) — walking each timing parameter down a grid and returning the
smallest value with zero failures, plus a one-cycle guardband. Because the
test region is the design-worst, every other (data) row is at least as fast:
the returned operating point is safe for the whole DIMM. Conventional
profiling reaches the same operating point by testing EVERY row — 512x the
cost (Appendix A: 625 ms vs 1.22 ms per pattern for a 4GB DIMM).

AL-DRAM is the static baseline: it profiles once at install time and never
re-profiles, so aging drift eventually makes its table unsafe (Sec 6.1 fn 2)
— while DIVA's periodic online profiling follows the drift.

The counterpart of ``repro.core.profiling``: ``diva_profile`` /
``conventional_profile`` run the batched sweep of core/substrate.py on a
one-DIMM batch, and ``diva_operating_point`` its operating-point sweep;
``DivaProfiler`` and ``ALDRAM.install`` run the lifetime loop
(``substrate.lifetime_population``) — the profiler serves a precomputed
per-epoch table, AL-DRAM's temperature bins are epochs of a zero-aging
schedule.  The numpy walkers (``diva_profile_loop`` /
``conventional_profile_loop`` / ``lifetime_loop``) are the per-DIMM
references the batched paths reproduce decision for decision.  Each class
and wrapper takes ``device=`` for the batch it builds.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.errors import DEFAULT_ITERS, DEFAULT_PATTERNS, DimmModel
from repro_torch.core.latency import worst_rows_internal
from repro_torch.core.substrate import (DimmBatch, _resolve_rows,
                                        lifetime_population,
                                        operating_points_population,
                                        profile_population)
from repro_torch.core.timing import (AXES, CYCLE_NS, PARAMS, STANDARD, VDD_STD,
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


def lifetime_loop(dimm: DimmModel, ages, temps, *, refresh_ms=64.0,
                  region="worst", guard_cycles: int = 1, multibit: bool = True,
                  patterns=DEFAULT_PATTERNS, iters=DEFAULT_ITERS) -> dict:
    """The per-DIMM numpy reference of ``substrate.lifetime_population``:
    walk the profiling epochs serially, re-profiling under each epoch's
    (age, temperature) with the numpy walker, testing whether the previous
    epoch's table (the standard table at epoch 0) still passes, and
    integrating the multi-bit ECC exposure at the fresh operating point.

    Returns {"timings": (E, 4), "stale_fail": (E,), "ecc_lambda": (E,)} —
    timings and stale decisions identical to the batched epoch loop via the
    shared per-query hash.
    """
    rows = _resolve_rows(region, dimm.geom)  # same validation as the batch
    ages = np.asarray(ages, np.float32)
    temps = np.asarray(temps, np.float64)
    E = len(ages)
    timings = np.zeros((E, len(PARAMS)), np.float32)
    stale = np.zeros(E, bool)
    ecc = np.zeros(E, np.float32)
    kw = dict(refresh_ms=refresh_ms, patterns=patterns, iters=iters)
    prev, age0 = STANDARD, dimm.age_years
    try:
        for e in range(E):
            dimm.age_years = float(ages[e])
            temp = float(temps[e])
            t_new = _profile_loop(dimm, rows, temp_C=temp,
                                  refresh_ms=refresh_ms,
                                  guard_cycles=guard_cycles,
                                  multibit_only=multibit,
                                  patterns=patterns, iters=iters)
            stale[e] = any(
                dimm.region_has_errors(p, getattr(prev, p), rows, temp_C=temp,
                                       multibit_only=multibit, **kw)
                for p in PARAMS)
            ecc[e] = np.float32(sum(
                dimm.region_error_lambdas(p, getattr(t_new, p), rows,
                                          temp_C=temp, multibit_only=True,
                                          **kw).sum()
                for p in PARAMS))
            timings[e] = [getattr(t_new, p) for p in PARAMS]
            prev = t_new
    finally:
        dimm.age_years = age0
    return {"timings": timings, "stale_fail": stale, "ecc_lambda": ecc}


@dataclass
class DivaProfiler:
    """Online profiler: re-profiles every ``period_steps`` accesses so aging
    drift is tracked (Sec 6.1).  The whole re-profiling lifecycle — aging by
    ``years_per_period`` per interval at the profiler's operating point — is
    one ``substrate.lifetime_population`` run on ``device`` (default: the
    CUDA device); ``timing()`` serves the current epoch's row of the
    precomputed trajectory (the horizon doubles on demand).

    ``discovery`` switches the profiler to blind mode: instead of the
    geometry-oracle ``"worst"`` region it tests the EXTERNAL row addresses a
    ``discovery.blind.BlindDiva`` run discovered (either the
    ``BlindDiscovery`` artifact — matched by this DIMM's serial — or a plain
    external row-index array).  The DIMM decodes those addresses with its own
    scramble, as hardware would; the profiler never touches the geometry.

    ``banks > 1`` profiles per-bank tables (subarray groups):
    ``bank_table()`` serves the current epoch's (banks, 4) ns table — what
    the memsim FR-FCFS simulator charges per request — while ``timing()``
    returns the whole-DIMM-safe envelope (per-parameter max over banks).

    ``axes`` extends each epoch's sweep past the 4-timing prefix ("vdd",
    "refresh"), with ``vdd`` the ambient supply and ``retention`` the second
    error channel; ``axis_table()`` serves the full (banks, len(axes)) row
    and ``operating_point()`` its whole-DIMM-safe envelope (max over banks on
    descending axes — timing, vdd — min on the ascending refresh axis)."""
    dimm: DimmModel
    period_steps: int = 1000
    temp_C: float = 55.0
    refresh_ms: float = 64.0
    vdd: float = VDD_STD
    years_per_period: float = 0.0
    banks: int = 1
    axes: tuple = PARAMS
    retention: bool = False
    discovery: object | None = None
    device: object | None = None
    _timings: np.ndarray | None = field(default=None, repr=False)
    _age_base: float | None = field(default=None, repr=False)
    _epoch_base: int = 0
    _cur_epoch: int = field(default=-1, repr=False)
    _step: int = 0

    def _region(self):
        """Internal test rows: the geometry-oracle worst region, or (blind
        mode) the discovered EXTERNAL addresses decoded by the DIMM's own
        scramble — the decode hardware performs on every activate."""
        if self.discovery is None:
            return "worst"
        ext = self.discovery
        if hasattr(ext, "ext_rows_for"):                 # BlindDiscovery
            ext = ext.ext_rows_for(self.dimm.serial)
        return np.asarray(
            self.dimm.vendor.scramble.ext_to_int(np.asarray(ext)))

    def lifecycle(self, n_epochs: int, age_base: float | None = None,
                  diagnostics: bool = False) -> dict:
        """The profiler's full epoch schedule through the lifetime loop.
        ``timing()`` runs it timing-only; pass ``diagnostics=True`` for the
        stale/ECC trajectories."""
        base = self.dimm.age_years if age_base is None else age_base
        ages = np.float32(base) \
            + np.float32(self.years_per_period) * np.arange(n_epochs,
                                                            dtype=np.float32)
        return lifetime_population(
            DimmBatch.from_population([self.dimm], self.device), ages,
            np.full(n_epochs, self.temp_C), refresh_ms=self.refresh_ms,
            vdd=self.vdd, region=self._region(), multibit=True,
            diagnostics=diagnostics, banks=self.banks,
            axes=tuple(self.axes), retention=self.retention)

    def timing(self) -> TimingParams:
        epoch = self._step // self.period_steps
        at_boundary = self._timings is None or epoch != self._cur_epoch
        if at_boundary and self._age_base != self.dimm.age_years:
            # externally applied aging restarts the schedule from the DIMM's
            # current age — but only at a re-profiling boundary: mid-period
            # changes keep serving the stale table until the next period
            # (the staleness window stale_fail models); extensions below
            # reuse _age_base, so epochs already served never change
            self._age_base, self._epoch_base = self.dimm.age_years, epoch
            self._timings = None
        self._cur_epoch = epoch
        rel = epoch - self._epoch_base
        if self._timings is None or rel >= len(self._timings):
            n = max(4, rel + 1,
                    0 if self._timings is None else 2 * len(self._timings))
            self._timings = self.lifecycle(n, self._age_base)["timings"][:, 0]
        self._step += 1
        row = self._timings[rel]
        if row.ndim == 2:           # per-bank mode: whole-DIMM-safe envelope
            row = row.max(axis=0)
        return TimingParams(*(float(v) for v in row[:len(PARAMS)]))

    def _current_row(self) -> np.ndarray:
        if self._timings is None:
            raise RuntimeError("call timing() at least once first")
        return np.atleast_2d(self._timings[self._cur_epoch - self._epoch_base])

    def bank_table(self) -> np.ndarray:
        """(banks, 4) ns table of the epoch most recently served by
        ``timing()`` (``banks=1``: the whole-DIMM row as (1, 4)); always the
        4-timing prefix, whatever ``axes``."""
        return self._current_row()[:, :len(PARAMS)]

    def axis_table(self) -> np.ndarray:
        """(banks, len(axes)) per-axis table of the epoch most recently
        served by ``timing()`` — columns in ``self.axes`` order."""
        return self._current_row()

    def operating_point(self) -> OperatingPoint:
        """Whole-DIMM-safe ``OperatingPoint`` of the epoch most recently
        served by ``timing()``: per-axis envelope over banks (max on
        descending axes, min on the ascending refresh axis), with the
        profiler's ambient temperature."""
        row = self._current_row()
        axes = tuple(self.axes)
        env = {a: float(row[:, i].max() if AXES[a].descending
                        else row[:, i].min())
               for i, a in enumerate(axes)}
        return OperatingPoint(
            timing=TimingParams(*(env[p] for p in PARAMS)),
            vdd=env.get("vdd", self.vdd), temp_C=self.temp_C,
            refresh_ms=env.get("refresh", self.refresh_ms))


@dataclass
class ALDRAM:
    """Static baseline: timing table fixed at install time (age=0); applies a
    temperature bin but cannot see aging (Sec 6.1 / Sec 7)."""
    table: dict  # temp bin -> (banks, len(axes)) ns array, axes-order columns
    axes: tuple = PARAMS

    @classmethod
    def install(cls, dimm: DimmModel, temps=(55.0, 85.0), banks: int = 1,
                axes=PARAMS, vdd: float = VDD_STD, retention: bool = False,
                device=None) -> "ALDRAM":
        # AL-DRAM has no test region: it gets the *oracle* min-safe over all
        # rows at install time (the paper's generous assumption for the
        # baseline) but no re-profiling.  Install is one lifetime run whose
        # "epochs" are the temperature bins of a zero-aging schedule (ages
        # override the DIMM's age), giving conventional_profile per bin;
        # ``banks``/``axes`` install per-bank and per-axis static tables.
        out = lifetime_population(
            DimmBatch.from_population([dimm], device),
            np.zeros(len(temps), np.float32), np.asarray(temps, np.float64),
            vdd=vdd, region="all", multibit=False, diagnostics=False,
            banks=banks, axes=tuple(axes), retention=retention)
        return cls({t: np.atleast_2d(np.asarray(out["timings"][i, 0]))
                    for i, t in enumerate(temps)}, axes=tuple(axes))

    def _bin(self, temp_C: float):
        return min(self.table, key=lambda t: abs(t - temp_C))

    def bank_table(self, temp_C: float) -> np.ndarray:
        """(banks, 4) ns table of the nearest installed temperature bin;
        always the 4-timing prefix, whatever ``axes``."""
        return self.table[self._bin(temp_C)][:, :len(PARAMS)]

    def axis_table(self, temp_C: float) -> np.ndarray:
        """(banks, len(axes)) per-axis table of the nearest installed bin."""
        return self.table[self._bin(temp_C)]

    def timing(self, temp_C: float) -> TimingParams:
        row = self.table[self._bin(temp_C)].max(axis=0)  # whole-DIMM envelope
        return TimingParams(*(float(v) for v in row[:len(PARAMS)]))


# ------------------------------------------------------------- reporting

def latency_reduction(t: TimingParams) -> dict:
    """Fig 18 metric: read/write latency reduction vs standard timings."""
    read = 1.0 - t.read_latency_ns() / STANDARD.read_latency_ns()
    write = 1.0 - t.write_latency_ns() / STANDARD.write_latency_ns()
    return {"read_reduction": read, "write_reduction": write,
            "read_cycles_saved": STANDARD.read_cycles() - t.read_cycles(),
            "write_cycles_saved": STANDARD.write_cycles() - t.write_cycles()}
