"""Per-cell *required* timing model (ns) — the quantitative heart of DIVA.

t_req(cell, param) =
    base[param]
  + k_bl[param]  * bitline_distance(row, col parity)        (Fig 3)
  + k_wl[param]  * wordline_distance(col)                   (Fig 4)
  + k_mat[param] * mat_position_delay(mat_x)                (Figs 4, 9)
  + temp/refresh/aging adders                               (Sec 5.5, 6.1)
  + process-variation noise  ~ N(0, sigma)                  (Sec 6.1, App C)

The directional coefficients are the SPICE-lite slopes from core/spice.py
scaled per timing parameter; vendors differ in coefficients, scrambling, and
noise — giving the Appendix-D population structure (same die version =>
similar design-induced variation; process noise on top).

A cell operated at t_op fails with probability Phi((t_req_det - t_op)/sigma)
— the analytic fold of per-cell Gaussian noise, which lets us evaluate whole
DIMMs as (mats_x, rows, cols) probability grids instead of sampling billions
of cells.

A frozen copy of the port's ``core/latency.py``, kept with the benchmark:
the numpy model that makes the populations, and the torch twins (``*_t``)
that the plain reference evaluates, in the same operation order.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from divabench.model.geometry import (DimmGeometry, RowScramble, bitline_distance,
                                 precharge_delay, vendor_scramble, wordline_distance)
from divabench.model.timing import PARAMS, STANDARD, TimingParams, VDD_STD

# Retention-channel stress coefficients (global, not per-vendor: the ambient
# physics of leakage, as opposed to the per-design margin structure below).
# Units: equivalent refresh-interval doublings per degC / per volt.
RET_TEMP_COEF = 0.025  # leakage doubles every ~40C (DDR3 2x refresh >85C)
RET_VDD_COEF = 1.5     # lower rail -> less stored charge -> less margin


@dataclass(frozen=True)
class VendorModel:
    name: str
    die: str
    # per timing parameter coefficients (ns); anchored at 85C so that the
    # worst-region required tRP ~ 7.8 ns (errors appear at the paper's 10 ns
    # point only in the tail, strong variation at 7.5 ns, near-total failure
    # at 5 ns — Fig 6) and tRCD ~ 6.6 ns.
    base: dict = field(default_factory=lambda: dict(trcd=3.3, tras=13.0, trp=3.85, twr=1.3))
    k_bl: dict = field(default_factory=lambda: dict(trcd=1.5, tras=4.5, trp=2.2, twr=1.0))
    k_wl: dict = field(default_factory=lambda: dict(trcd=0.8, tras=1.0, trp=0.35, twr=0.4))
    k_mat: dict = field(default_factory=lambda: dict(trcd=0.7, tras=1.0, trp=0.9, twr=0.4))
    # monotone row-index term: rows farther from the row predecoder see a
    # later local-wordline rise — breaks the open-bitline mirror symmetry
    # (this is what makes Fig 10/11's mapping estimation well-posed)
    k_row: dict = field(default_factory=lambda: dict(trcd=0.3, tras=0.5, trp=0.4, twr=0.3))
    sigma: float = 0.15          # per-cell process noise (ns)
    chip_sigma: float = 0.10     # per-chip offset (ns)
    temp_coef: float = 0.040     # ns per degC above/below the 85C anchor
    refresh_coef: float = 0.040  # ns per doubling of the refresh interval
    aging_coef: float = 0.50     # ns per year of wearout (Sec 6.1 fn.2)
    outlier_rate: float = 3e-6   # heavy-tail weak cells (random, ECC's job)
    outlier_ns: float = 3.5      # extra required latency of a weak cell
    repair_rate: float = 0.01    # fraction of rows remapped post-manufacturing
    # Operating-point axes beyond timing (the VAR-DRAM / retention direction).
    # Access channel: required latency grows as the rail drops below nominal.
    vdd_coef: float = 5.0        # ns of extra required latency per volt below VDD_STD
    # Retention channel: per-cell margin (in refresh-interval doublings) that
    # erodes with the same design slowness driving the tRAS (charge-restore)
    # variation — design-induced retention structure, not random retention.
    ret_base: float = 4.0        # margin (doublings) of a zero-slowness cell
    ret_k: float = 0.25          # margin lost per ns of tRAS design slowness
    ret_sigma: float = 0.25      # per-cell retention noise (doublings)
    ret_drop: float = 1.2        # weak-cell margin drop (same mixture as outlier_ns)
    scramble: RowScramble | None = None

    def with_scramble(self, n_bits: int, seed: int = 0) -> "VendorModel":
        import dataclasses
        return dataclasses.replace(self, scramble=vendor_scramble(self.name + self.die, n_bits, seed))


def vendor_models(geom: DimmGeometry) -> dict[str, VendorModel]:
    """Three vendors; B's dies often show little tRCD variation and a sharp
    tRP cliff (Sec 5.6: 'Vendor B has drastically high error counts ... when
    tRCD is reduced below a certain value')."""
    nb = int(np.log2(geom.rows_per_mat))
    A = VendorModel("A", "C").with_scramble(nb, 1)
    B = VendorModel(
        "B", "K",
        base=dict(trcd=5.1, tras=13.5, trp=3.6, twr=1.5),
        k_bl=dict(trcd=0.15, tras=3.6, trp=2.4, twr=1.0),
        k_wl=dict(trcd=0.05, tras=0.9, trp=0.5, twr=0.5),
        k_mat=dict(trcd=0.05, tras=0.6, trp=1.3, twr=0.4),
        sigma=0.20,
    ).with_scramble(nb, 2)
    C = VendorModel(
        "C", "E",
        base=dict(trcd=3.2, tras=12.5, trp=3.95, twr=1.2),
        k_bl=dict(trcd=1.7, tras=4.8, trp=1.9, twr=1.2),
        k_wl=dict(trcd=0.9, tras=0.9, trp=0.3, twr=0.5),
        k_mat=dict(trcd=1.0, tras=0.8, trp=0.8, twr=0.3),
        sigma=0.13,
    ).with_scramble(nb, 3)
    return {"A": A, "B": B, "C": C}


# Data patterns (Section 4): row-stripe patterns stress bitlines differently.
PATTERN_STRESS = {"0000": 0.90, "0101": 1.00, "0011": 0.96, "1001": 0.94}

# Test-campaign defaults (Section 4 methodology); re-exported by core.errors.
DEFAULT_PATTERNS = ("0000", "0101", "0011", "1001")
DEFAULT_ITERS = 10


def condition_scalars(temp_C: float, refresh_ms: float):
    """(temp delta, log2 refresh ratio) as f32 — the dynamic operating point."""
    return (np.float32(temp_C - 85.0),
            np.float32(np.log2(max(refresh_ms, 1.0) / 64.0)))


def condition_adder(vm: VendorModel, temp_C: float, refresh_ms: float,
                    age_years: float) -> np.float32:
    """Scalar operating-condition term (Sec 5.5 / 6.1) in float32, with the
    SAME op order as the batched substrate's host-side adder — both paths add
    literally identical bits to the t_req grid."""
    t_delta, r_log = condition_scalars(temp_C, refresh_ms)
    return (np.float32(vm.temp_coef) * t_delta
            + np.float32(vm.refresh_coef) * r_log
            + np.float32(vm.aging_coef) * np.float32(age_years))


def t_req_grid(geom: DimmGeometry, vm: VendorModel, param: str, *,
               temp_C: float = 85.0, refresh_ms: float = 64.0,
               age_years: float = 0.0, pattern: str = "0101") -> np.ndarray:
    """Deterministic required timing, shape (mats_x, rows_per_mat, cols_per_mat).

    Computed in float32 end to end, with the same operation order as the
    batched substrate (core/substrate.py) so that both paths agree to ~1 ulp.
    """
    R, C, M = geom.rows_per_mat, geom.cols_per_mat, geom.mats_x
    rows = np.arange(R, dtype=np.float32)[None, :, None]
    cols32 = np.arange(C, dtype=np.float32)[None, None, :]
    d_bl = bitline_distance(geom, rows, np.arange(C)[None, None, :])  # (1,R,C) f32
    d_wl = wordline_distance(geom, cols32)                            # (1,1,C) f32
    d_mat = precharge_delay(geom, np.arange(M, dtype=np.float32))[:, None, None]

    stress = PATTERN_STRESS[pattern]
    d_row = rows / (R - 1)
    var = (np.float32(vm.k_bl[param]) * d_bl + np.float32(vm.k_wl[param]) * d_wl
           + np.float32(vm.k_mat[param]) * d_mat
           + np.float32(vm.k_row[param]) * d_row)
    t = np.float32(vm.base[param]) + stress * var
    t = t + condition_adder(vm, temp_C, refresh_ms, age_years)
    return t.astype(np.float32)


def design_slowness_grid(geom: DimmGeometry, vm: VendorModel, param: str, *,
                         pattern: str = "0101") -> np.ndarray:
    """``stress * var`` — the design-induced slowness part of ``t_req_grid``
    (coefficient-weighted distances only; no base, adders, or offsets),
    float32 with the same op order.  The retention channel erodes margin
    along this grid (see ``retention_fail_mixture``), with ``param="tras"``:
    charge-restore slowness.
    """
    R, C, M = geom.rows_per_mat, geom.cols_per_mat, geom.mats_x
    rows = np.arange(R, dtype=np.float32)[None, :, None]
    cols32 = np.arange(C, dtype=np.float32)[None, None, :]
    d_bl = bitline_distance(geom, rows, np.arange(C)[None, None, :])
    d_wl = wordline_distance(geom, cols32)
    d_mat = precharge_delay(geom, np.arange(M, dtype=np.float32))[:, None, None]
    stress = PATTERN_STRESS[pattern]
    d_row = rows / (R - 1)
    var = (np.float32(vm.k_bl[param]) * d_bl + np.float32(vm.k_wl[param]) * d_wl
           + np.float32(vm.k_mat[param]) * d_mat
           + np.float32(vm.k_row[param]) * d_row)
    return (stress * var).astype(np.float32)


def fail_probability(t_req_det, t_op, sigma, xp=np):
    """P(cell fails) = Phi((t_req_det - t_op)/sigma) (Gaussian noise fold).

    ``xp`` selects the array namespace (numpy for the legacy per-DIMM path,
    jax.numpy for the batched substrate) — one op order, two backends.
    """
    from math import sqrt
    z = (t_req_det - t_op) / xp.maximum(sigma, 1e-6)
    # stable erf-based normal CDF
    return 0.5 * (1.0 + _erf(z / sqrt(2.0), xp))


def fail_mixture(t_req_det, t_op, sigma, outlier_rate, outlier_ns, xp=np):
    """Failure probability with the heavy-tail weak-cell mixture folded in
    (the scattered single-bit errors that ECC absorbs — Sec 6.1/App C)."""
    p = fail_probability(t_req_det, t_op, sigma, xp)
    p_out = fail_probability(t_req_det + outlier_ns, t_op, sigma, xp)
    return (1.0 - outlier_rate) * p + outlier_rate * p_out


def multibit_tail(q, width: int = 72, xp=np):
    """P(>= 2 of ``width`` bits fail | per-bit prob q) — the SECDED
    uncorrectable-codeword probability (Sec 6.1).

    Written in expm1/log1p form: the naive ``1-(1-q)^w - w*q*(1-q)^(w-1)``
    cancels catastrophically in float32 for q << 1 (it overstates the tail by
    orders of magnitude and even breaks monotonicity in t_op), while this form
    stays accurate down to q ~ 1e-8 on both numpy and jax.numpy.
    """
    # upper clip just below 1 keeps log1p finite; for q this close to 1 the
    # tail is 1 to float32 precision anyway
    q = xp.clip(q, 0.0, 0.999999)
    log1mq = xp.log1p(-q)
    none_fail = -xp.expm1(width * log1mq)             # 1 - (1-q)^w
    one_fails = width * q * xp.exp((width - 1) * log1mq)
    return xp.clip(none_fail - one_fails, 0.0, 1.0)


def _erf(x, xp=np):
    # Abramowitz-Stegun 7.1.26 vectorized (works on numpy and jax.numpy)
    sign = xp.sign(x)
    x = xp.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * xp.exp(-x * x)
    return sign * y


def retention_stress(temp_C: float, refresh_ms: float,
                     vdd: float = VDD_STD) -> np.float32:
    """Retention stress ``x`` in refresh-doubling units — HOST-side float32.

    Shared verbatim by the numpy reference and the batched substrate (the
    same host-adder trick as ``condition_adder``: precompute conditions in
    numpy f32, never in-trace, so both paths see identical bits).
    """
    t_delta, r_log = condition_scalars(temp_C, refresh_ms)
    return np.float32(r_log + np.float32(RET_TEMP_COEF) * t_delta
                      + np.float32(RET_VDD_COEF) * np.float32(VDD_STD - vdd))


def access_vdd_shift(vdd_coef, vdd: float) -> np.ndarray:
    """Extra required access latency (ns) at supply ``vdd`` — host-side f32.

    ``vdd_coef`` may be a scalar (VendorModel) or a per-DIMM leaf array.
    """
    return (np.asarray(vdd_coef, np.float32)
            * np.float32(VDD_STD - vdd)).astype(np.float32)


def retention_fail_mixture(slowness, ret_base, ret_k, x, sigma,
                           outlier_rate, drop, xp=np):
    """Per-cell retention failure probability at stress ``x``.

    margin = ret_base - ret_k * slowness  (doublings of refresh headroom);
    P(fail) = Phi((x - margin)/sigma), with the weak-cell mixture reusing
    ``fail_mixture`` (a weak cell's margin is ``drop`` doublings lower).
    ``slowness`` is the design-induced part of the tRAS required-latency
    grid (stress * var, no base/adders) — retention erosion rides the same
    charge-restore structure.  One op order, numpy or jax.numpy via ``xp``.
    """
    margin = ret_base - ret_k * slowness
    return fail_mixture(-margin, -x, sigma, outlier_rate, drop, xp)


def worst_rows_internal(geom: DimmGeometry) -> np.ndarray:
    """Internal (distance-ordered) row indices of the design-induced slowest
    rows in a mat: the edge rows (open-bitline: both ends host the
    max-distance cells of alternating bitlines)."""
    return np.array([0, geom.rows_per_mat - 1])


# ------------------------------------------------------------ torch twins
# The reference runs the helpers above on jax.numpy through ``xp=``; torch has
# no drop-in namespace (``xp.maximum(sigma, 1e-6)`` needs a tensor operand),
# so each is restated on tensors with the operations in the same order.

def div_t(x, c: float):
    """``x / c`` for a constant ``c``, as an IEEE float32 division on every
    device.  (Torch's CUDA kernels multiply by the reciprocal of a
    CPU-scalar divisor, which can move the quotient by an ulp; the reference
    divides, and so do the port's CUDA kernels.)"""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def fail_probability_t(t_req_det, t_op, sigma):
    """Torch twin of ``fail_probability``."""
    from math import sqrt
    z = (t_req_det - t_op) / torch.clamp_min(sigma, 1e-6)
    return 0.5 * (1.0 + _erf_t(div_t(z, sqrt(2.0))))


def fail_mixture_t(t_req_det, t_op, sigma, outlier_rate, outlier_ns):
    """Torch twin of ``fail_mixture``."""
    p = fail_probability_t(t_req_det, t_op, sigma)
    p_out = fail_probability_t(t_req_det + outlier_ns, t_op, sigma)
    return (1.0 - outlier_rate) * p + outlier_rate * p_out


def retention_fail_mixture_t(slowness, ret_base, ret_k, x, sigma,
                             outlier_rate, drop):
    """Torch twin of ``retention_fail_mixture``."""
    margin = ret_base - ret_k * slowness
    return fail_mixture_t(-margin, -x, sigma, outlier_rate, drop)


def multibit_tail_t(q, width: int = 72):
    """Torch twin of ``multibit_tail`` (the expm1/log1p form)."""
    q = torch.clamp(q, 0.0, 0.999999)
    log1mq = torch.log1p(-q)
    none_fail = -torch.expm1(width * log1mq)
    one_fails = width * q * torch.exp((width - 1) * log1mq)
    return torch.clamp(none_fail - one_fails, 0.0, 1.0)


def _erf_t(x):
    """Torch twin of ``_erf`` (Abramowitz-Stegun 7.1.26), not ``torch.erf``:
    the polynomial is the model, and the CUDA kernel evaluates it too."""
    sign = torch.sign(x)
    x = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
                - 0.284496736) * t + 0.254829592) * t * torch.exp(-x * x)
    return sign * y
