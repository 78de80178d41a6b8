"""Monte-Carlo error injection for a simulated DIMM (Section 4 methodology).

A ``DimmModel`` carries geometry + vendor model + per-chip/per-DIMM seeds.
Tests follow the paper: write a row-stripe pattern (+inverse), reduce ONE
timing parameter, wait a refresh interval, verify; 10 iterations; errors are
aggregated per external row / per column / per burst bit.

Everything is computed on (mats_x, rows, cols) probability grids; counts are
Poisson sampled so different iterations/DIMMs decorrelate realistically.
Every sampling query derives its own deterministic seed from the query key
(DIMM serial, parameter, operating point, ...), so results never depend on
call order.  ``region_has_errors`` shares its uniform draws with the batched
substrate (core/substrate.py) via the same counter hash, which is what lets
``profile_population`` reproduce the legacy per-DIMM walker exactly.

This module is the NumPy reference; the population-scale path lives in
core/substrate.py + kernels/fail_prob.py.  It is a copy of
``repro.core.errors`` whose counter hash comes from core/hashing.py.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.geometry import DimmGeometry, burst_bit_to_mat
from repro_torch.core.latency import (DEFAULT_ITERS, DEFAULT_PATTERNS,
                                PATTERN_STRESS, VendorModel, access_vdd_shift,
                                condition_adder, design_slowness_grid,
                                fail_mixture, multibit_tail,
                                retention_fail_mixture, retention_stress,
                                t_req_grid)
from repro_torch.core.hashing import quantize_t, query_uniform
from repro_torch.core.timing import (AXES, OP_GRID_LANE, PARAMS, VDD_STD,
                               OperatingPoint, op_point_key)


@dataclass
class DimmModel:
    geom: DimmGeometry
    vendor: VendorModel
    serial: int = 0  # per-DIMM seed
    age_years: float = 0.0

    def __post_init__(self):
        rng = np.random.default_rng(1000 + self.serial)
        # per-chip timing offsets (process variation across chips of a DIMM)
        self.chip_offsets = rng.normal(0.0, self.vendor.chip_sigma, self.geom.chips)
        # per-subarray offsets (process variation across the die)
        self.sub_offsets = rng.normal(0.0, self.vendor.chip_sigma / 2, self.geom.subarrays)
        # post-manufacturing row repair: repaired rows get a fresh random
        # profile (they were remapped to redundant rows elsewhere)
        n_rows = self.geom.rows_per_mat
        self.repaired = rng.random((self.geom.subarrays, n_rows)) < self.vendor.repair_rate
        self.repair_perm = rng.integers(0, n_rows, (self.geom.subarrays, n_rows))

    def _query_rng(self, kind: str, param: str, t_op: float,
                   **key) -> np.random.Generator:
        """Per-query deterministic RNG: same query => same sample, no matter
        how many other queries ran in between."""
        tag = "-".join(f"{k}={v}" for k, v in sorted(key.items()))
        s = f"{self.serial}-{kind}-{param}-{quantize_t(t_op)}-{tag}"
        return np.random.default_rng(zlib.crc32(s.encode()))

    # ---------------------------------------------------------------- grids

    def fail_prob_grid(self, param: str, t_op: float, *, temp_C=85.0,
                       refresh_ms=64.0, pattern="0101", chip: int = 0,
                       subarray: int = 0) -> np.ndarray:
        """(mats_x, rows, cols) failure probability for one chip/subarray,
        indexed by INTERNAL row order (float32, mirroring the substrate)."""
        t = t_req_grid(self.geom, self.vendor, param, temp_C=temp_C,
                       refresh_ms=refresh_ms, age_years=self.age_years,
                       pattern=pattern)
        t = t + np.float32(self.chip_offsets[chip])
        t = t + np.float32(self.sub_offsets[subarray])
        # heavy-tail weak cells folded in: the scattered single-bit errors
        # that ECC absorbs (Sec 6.1/App C)
        p = fail_mixture(t, t_op, np.float32(self.vendor.sigma),
                         np.float32(self.vendor.outlier_rate),
                         np.float32(self.vendor.outlier_ns))
        # row repair: repaired rows take the profile of their replacement row
        rep = self.repaired[subarray]
        perm = self.repair_perm[subarray]
        p[:, rep, :] = p[:, perm[rep], :]
        return p

    # ------------------------------------------------------------- per-row

    def row_error_counts(self, param: str, t_op: float, *, temp_C=85.0,
                         refresh_ms=64.0, patterns=DEFAULT_PATTERNS,
                         iters=DEFAULT_ITERS, internal_order: bool = False,
                         sample: bool = True) -> np.ndarray:
        """Error counts per external row address (per subarray concatenated),
        aggregated over mats, columns, chips, patterns and iterations.

        With ``internal_order=True`` rows are reported in internal
        (distance-ordered) addressing — what the scramble hides (Sec 5.3).
        The sample is drawn in internal order then scattered, so both views
        report the same underlying errors.
        """
        R = self.geom.rows_per_mat
        rng = self._query_rng("rows", param, t_op, temp=temp_C,
                              refresh=refresh_ms, iters=iters,
                              patterns=patterns)
        out = np.zeros(self.geom.subarrays * R)
        for sub in range(self.geom.subarrays):
            exp_row = np.zeros(R, np.float32)
            for pat in patterns:
                # pattern + inverse both tested: ~2x trials
                p = self.fail_prob_grid(param, t_op, temp_C=temp_C,
                                        refresh_ms=refresh_ms, pattern=pat,
                                        subarray=sub)
                exp_row += 2 * p.sum(axis=(0, 2)) * self.geom.chips
            n_trials = iters
            lam = exp_row * n_trials
            counts = rng.poisson(lam) if sample else lam
            if not internal_order:
                ext = self.vendor.scramble.int_to_ext(np.arange(R))
                ext_counts = np.zeros(R)
                ext_counts[ext] = counts
                counts = ext_counts
            out[sub * R:(sub + 1) * R] = counts
        return out

    def sample_row_counts(self, lam, param: str, t_op: float, *, temp_C=85.0,
                          refresh_ms=64.0, patterns=DEFAULT_PATTERNS,
                          iters=DEFAULT_ITERS) -> np.ndarray:
        """Poisson-sample row error counts from a precomputed expectation
        (e.g. the batched ``substrate.row_error_lambda``), drawing from the
        same per-query stream family as ``row_error_counts``."""
        rng = self._query_rng("rows", param, t_op, temp=temp_C,
                              refresh=refresh_ms, iters=iters,
                              patterns=patterns)
        return rng.poisson(lam)

    # ---------------------------------------------------------- per-column

    def column_error_counts(self, param: str, t_op: float, *, rows=16,
                            temp_C=85.0, refresh_ms=64.0,
                            patterns=DEFAULT_PATTERNS, iters=DEFAULT_ITERS,
                            per_row: bool = False) -> np.ndarray:
        """Error counts vs column address across ``rows`` test rows (Sec 5.2:
        'we test all columns in only 16 rows'). Column address c maps to
        (mat = c // cols_per_cmd..., within-mat col) — we report the mats
        concatenated along the column axis so the Fig 8 mat-boundary jumps
        are visible."""
        g = self.geom
        rng = self._query_rng("cols", param, t_op, rows=rows, temp=temp_C,
                              refresh=refresh_ms, iters=iters)
        row_sel = rng.integers(0, g.rows_per_mat, rows)
        cnt = np.zeros((rows, g.mats_x * 8)) if per_row else np.zeros(g.mats_x * 8)
        # 8 column strides per mat sampled (128 column commands per row in the
        # paper's setup)
        col_sel = np.linspace(0, g.cols_per_mat - 1, 8).astype(int)
        for pat in patterns:
            p = self.fail_prob_grid(param, t_op, pattern=pat, temp_C=temp_C,
                                    refresh_ms=refresh_ms)
            sub = p[:, row_sel][:, :, col_sel]  # (mats, rows, 8)
            lam = 2 * iters * self.geom.chips * np.moveaxis(sub, 0, 1).reshape(rows, -1)
            if per_row:
                cnt += rng.poisson(lam)
            else:
                cnt += rng.poisson(lam).sum(axis=0)
        return cnt

    # --------------------------------------------------------- per-burst-bit

    def burst_bit_error_counts(self, param: str, t_op: float, *, temp_C=85.0,
                               refresh_ms=64.0, iters=DEFAULT_ITERS,
                               n_accesses: int = 2000) -> np.ndarray:
        """(chips, 64) expected error counts per data-out bit position
        (Fig 12): bit j reads from mat burst_bit_to_mat(j) at a column
        position that advances within the mat."""
        g = self.geom
        rng = self._query_rng("burst", param, t_op, temp=temp_C,
                              refresh=refresh_ms, iters=iters,
                              n=n_accesses)
        out = np.zeros((g.chips, g.burst_bits))
        bits = np.arange(g.burst_bits)
        mats = burst_bit_to_mat(g, bits)
        within = bits % g.bits_per_mat_in_burst
        cols = (within * (g.cols_per_mat // g.bits_per_mat_in_burst)
                + g.cols_per_mat // (2 * g.bits_per_mat_in_burst))
        rows = rng.integers(0, g.rows_per_mat, n_accesses)
        for chip in range(g.chips):
            p = self.fail_prob_grid(param, t_op, temp_C=temp_C,
                                    refresh_ms=refresh_ms, chip=chip)
            lam = iters * p[mats, :, :][:, rows, :][np.arange(64), :, cols].sum(axis=1)
            out[chip] = rng.poisson(lam)
        return out

    # ----------------------------------------------------------- aggregates

    def total_errors(self, param: str, t_op: float, **kw) -> int:
        return int(self.row_error_counts(param, t_op, **kw).sum())

    def _region_lam_iter(self, param, t_op, internal_rows, *, temp_C,
                         refresh_ms, patterns, iters, multibit_only):
        """Lazily yield (sub, pat_idx, lam): the per-(subarray, pattern)
        expected failure counts of the region test, computed one grid at a
        time so callers can stop at the first tripped draw."""
        for sub in range(self.geom.subarrays):
            for pi, pat in enumerate(patterns):
                p = self.fail_prob_grid(param, t_op, pattern=pat, subarray=sub,
                                        temp_C=temp_C, refresh_ms=refresh_ms)
                region = p[:, internal_rows, :]
                if not multibit_only:
                    lam = 2 * iters * self.geom.chips * region.sum()
                else:
                    # P(>=2 errors in a 72-bit codeword) with per-bit prob ~p;
                    # each cell contributes 1/72 of a codeword, so the sum of
                    # per-cell p_multi is divided by the codeword width.
                    p_multi = multibit_tail(region)
                    lam = np.maximum(
                        2 * iters * self.geom.chips * p_multi.sum() / 72.0, 0.0)
                yield sub, pi, np.float32(lam)

    def region_error_lambdas(self, param: str, t_op: float, internal_rows,
                             *, temp_C=85.0, refresh_ms=64.0,
                             patterns=DEFAULT_PATTERNS, iters=DEFAULT_ITERS,
                             multibit_only: bool = False) -> np.ndarray:
        """(subarrays, patterns) f32 expected failure counts of the region
        test — the ``lam`` behind ``region_has_errors``'s accept/reject draws
        and the ECC-exposure integrand of the lifetime lifecycle
        (``profiling.lifetime_loop`` / ``substrate.lifetime_population``)."""
        lams = np.zeros((self.geom.subarrays, len(patterns)), np.float32)
        for sub, pi, lam in self._region_lam_iter(
                param, t_op, internal_rows, temp_C=temp_C,
                refresh_ms=refresh_ms, patterns=patterns, iters=iters,
                multibit_only=multibit_only):
            lams[sub, pi] = lam
        return lams

    def _op_lam_iter(self, op: "OperatingPoint", internal_rows, *, patterns,
                     iters, multibit_only, retention):
        """Lazily yield (sub, pat_idx, lam) for one full operating point:
        the access channel summed over ALL four timing parameters at the
        point's table values plus (optionally) the retention channel — the
        per-point loop reference for ``substrate._op_region_eval`` (same
        float32 op order, modulo reduction-order ulps)."""
        g = self.geom
        R = g.rows_per_mat
        shift = access_vdd_shift(self.vendor.vdd_coef, op.vdd)
        x = retention_stress(op.temp_C, op.refresh_ms, op.vdd)
        rows = np.asarray(internal_rows)
        f32 = np.float32
        for sub in range(g.subarrays):
            src = np.where(self.repaired[sub], self.repair_perm[sub],
                           np.arange(R))
            rsel = src[rows]
            for pi, pat in enumerate(patterns):
                lam = f32(0.0)
                for p in PARAMS:
                    t = t_req_grid(g, self.vendor, p, temp_C=op.temp_C,
                                   refresh_ms=op.refresh_ms,
                                   age_years=self.age_years, pattern=pat)
                    t = t + f32(shift)
                    t = t + f32(self.chip_offsets[0])
                    t = t + f32(self.sub_offsets[sub])
                    pr = fail_mixture(t, f32(getattr(op.timing, p)),
                                      f32(self.vendor.sigma),
                                      f32(self.vendor.outlier_rate),
                                      f32(self.vendor.outlier_ns))
                    lam = lam + self._channel_lam(pr[:, rsel, :], iters,
                                                  multibit_only)
                if retention:
                    slow = design_slowness_grid(g, self.vendor, "tras",
                                                pattern=pat)
                    pr = retention_fail_mixture(
                        slow, f32(self.vendor.ret_base),
                        f32(self.vendor.ret_k), x,
                        f32(self.vendor.ret_sigma),
                        f32(self.vendor.outlier_rate),
                        f32(self.vendor.ret_drop))
                    lam = lam + self._channel_lam(pr[:, rsel, :], iters,
                                                  multibit_only)
                yield sub, pi, f32(lam)

    def _channel_lam(self, region, iters, multibit_only) -> np.float32:
        if multibit_only:
            return np.float32(np.maximum(
                2 * iters * self.geom.chips
                * multibit_tail(region).sum() / 72.0, 0.0))
        return np.float32(2 * iters * self.geom.chips * region.sum())

    def operating_point_eval(self, op: "OperatingPoint", internal_rows, *,
                             patterns=DEFAULT_PATTERNS, iters=DEFAULT_ITERS,
                             multibit_only: bool = False,
                             retention: bool = True, lane: int = OP_GRID_LANE,
                             key: int | None = None):
        """Monte-Carlo region test at one full ``OperatingPoint`` — the
        NumPy loop reference for ``substrate.operating_grid_arrays``.

        The accept/reject draw is keyed on ``(lane, key)``; ``key`` defaults
        to the folded ``timing.op_point_key`` of the point's quantized
        timing/vdd/refresh coordinates (never its temperature — conditions
        move lambdas, not draws).  Returns ``(fails, lam_total)``: did any
        (subarray, pattern) draw trip, and the summed expected failure
        count over both error channels.
        """
        if key is None:
            tq = 0
            for p in PARAMS:
                tq = (tq * 0x9E3779B9
                      + AXES[p].quantize(getattr(op.timing, p))) & 0xFFFFFFFF
            key = op_point_key(tq, AXES["vdd"].quantize(op.vdd),
                               AXES["refresh"].quantize(op.refresh_ms))
        S, P = self.geom.subarrays, len(patterns)
        u = query_uniform(np.full((S, P), self.serial, np.uint32), lane, key,
                          int(multibit_only), np.arange(S)[:, None],
                          np.arange(P)[None, :])
        fails = False
        lam_total = np.float32(0.0)
        for sub, pi, lam in self._op_lam_iter(
                op, internal_rows, patterns=patterns, iters=iters,
                multibit_only=multibit_only, retention=retention):
            lam_total = np.float32(lam_total + lam)
            if u[sub, pi] < -np.expm1(-lam):
                fails = True
        return fails, lam_total

    def region_has_errors(self, param: str, t_op: float, internal_rows,
                          *, temp_C=85.0, refresh_ms=64.0,
                          patterns=DEFAULT_PATTERNS, iters=DEFAULT_ITERS,
                          multibit_only: bool = False) -> bool:
        """Monte-Carlo test of a row subset (used by profiling).

        ``multibit_only=True`` is the DIVA+ECC criterion (Sec 6.1): the
        profiled timing must produce no MULTI-bit errors per 72-bit codeword;
        random single-bit failures are SECDED-correctable and tolerated.

        The accept/reject draw is ``u < P(N_errors > 0)`` with ``u`` from the
        per-query counter hash shared with core/substrate.py — deterministic,
        and bit-identical between this walker and ``profile_population``.
        Stops at the first tripped draw (per-query determinism makes the
        early exit decision-neutral).
        """
        S, P = self.geom.subarrays, len(patterns)
        u = query_uniform(np.full((S, P), self.serial, np.uint32),
                          PARAMS.index(param), quantize_t(t_op),
                          int(multibit_only), np.arange(S)[:, None],
                          np.arange(P)[None, :])
        for sub, pi, lam in self._region_lam_iter(
                param, t_op, internal_rows, temp_C=temp_C,
                refresh_ms=refresh_ms, patterns=patterns, iters=iters,
                multibit_only=multibit_only):
            if u[sub, pi] < -np.expm1(-lam):
                return True
        return False


def expected_row_profile(dimm: "DimmModel", param: str, t_op: float, *,
                         temp_C=85.0, refresh_ms=64.0) -> np.ndarray:
    """Model-expected per-internal-row error counts for one subarray (the
    'expected characteristics' of Sec 3.1 used by the mapping estimator)."""
    return dimm.row_error_counts(param, t_op, temp_C=temp_C,
                                 refresh_ms=refresh_ms, internal_order=True,
                                 sample=False)[:dimm.geom.rows_per_mat]


def vulnerability_ratio(row_counts: np.ndarray, frac: float = 0.1) -> float:
    """Fig 14 metric: errors in the top 10% most- vs least-vulnerable rows."""
    s = np.sort(row_counts)
    k = max(1, int(len(s) * frac))
    lo, hi = s[:k].sum(), s[-k:].sum()
    return float(hi / max(lo, 1.0))
