"""The plain reference of the DIVA paths the benchmark times.

Plain PyTorch on any device, on the benchmark's own host leaves
(``population.py``), in a float dtype of the caller's choosing: float32 is
the configuration's precision and the reference; bfloat16 is the control
(the nearest precision below), which the benchmark's comparisons must fail.
A frozen copy of the port's plain paths (``core/substrate.py``'s sweep,
coefficient packing and row lambdas, ``kernels/fail_prob.py``'s plain
grids, ``core/streaming.py``'s error-summary reductions), restated on a
dict of tensors instead of the port's ``DimmBatch``; it imports nothing of
the port and takes nothing the port made.

  * ``profile_tables``  — DIVA / conventional profiling: (D, 4) timing tables.
  * ``row_lambda``      — expected per-row error counts (D, subarrays*rows).
  * ``error_summary``   — the fail-grid summary of a population at an
                          operating point, computed in blocks of DIMMs.
"""
from __future__ import annotations

import numpy as np
import torch

from divabench.model.geometry import DimmGeometry, precharge_delay, \
    wordline_distance
from divabench.model.hashing import query_uniform_t
from divabench.model.latency import (DEFAULT_ITERS, DEFAULT_PATTERNS,
                                     PATTERN_STRESS, access_vdd_shift, condition_scalars,
                                     div_t, fail_mixture_t, multibit_tail_t,
                                     retention_fail_mixture_t,
                                     retention_stress, worst_rows_internal)
from divabench.model.timing import AXES, CYCLE_NS, PARAMS, STANDARD, VDD_STD

_INT_LEAVES = {"serial": torch.int64, "row_src": torch.int64,
               "int_to_ext": torch.int64, "ext_to_int": torch.int64}


def to_tensors(leaves: dict, device, dtype=torch.float32) -> dict:
    """The leaves as tensors on ``device``: the float leaves in ``dtype``
    (through float32, as the program receives them), the integer ones
    int64."""
    out = {}
    for k, v in leaves.items():
        if k in _INT_LEAVES:
            out[k] = torch.as_tensor(np.asarray(v, np.int64), device=device)
        else:
            out[k] = torch.as_tensor(np.asarray(v, np.float32),
                                     device=device).to(dtype)
    return out


def condition_adders(leaves: dict, temp_C: float,
                     refresh_ms: float) -> np.ndarray:
    """(D,) float32 operating-condition adders, on the host."""
    t_delta, r_log = condition_scalars(temp_C, refresh_ms)
    f = lambda k: np.asarray(leaves[k], np.float32)
    return (f("temp_coef") * t_delta + f("refresh_coef") * r_log
            + f("aging_coef") * f("age_years"))


def _geom_consts(geom: DimmGeometry, device, dtype):
    C, M = geom.cols_per_mat, geom.mats_x
    d_wl = np.asarray(wordline_distance(geom, np.arange(C, dtype=np.float32)),
                      np.float32)
    d_mat = np.asarray(precharge_delay(geom, np.arange(M, dtype=np.float32)),
                       np.float32)
    even = (np.arange(C) % 2) == 0 if geom.open_bitline else np.ones(C, bool)
    as_t = lambda a: torch.as_tensor(a, device=device)
    return as_t(d_wl).to(dtype), as_t(d_mat).to(dtype), as_t(even)


# ----------------------------------------------------------- the sweep

def _region_eval(L: dict, geom: DimmGeometry, consts, pidx: int, t_op: float,
                 rows, stress, adder, iters: int, multibit: bool):
    """(D,) bool: does the row region fail the Monte-Carlo test at ``t_op``
    — every subarray, every pattern, one draw each from the query hash."""
    S, R, chips = geom.subarrays, geom.rows_per_mat, geom.chips
    d_wl, d_mat, even = consts
    dt = d_wl.dtype
    dev = d_wl.device
    e5 = lambda v: v[:, None, None, None, None]
    kbl, kwl = L["k_bl"][:, pidx], L["k_wl"][:, pidx]
    kmat, krow = L["k_mat"][:, pidx], L["k_row"][:, pidx]
    t_cell = torch.as_tensor(t_op, dtype=torch.float32, device=dev)
    t_q = torch.round(t_cell * 4).to(torch.int64)
    t_s = t_cell.to(dt)
    pat_idx = torch.arange(stress.shape[0], device=dev)[None, :]
    fails = torch.zeros(L["serial"].shape[0], dtype=torch.bool, device=dev)
    for s in range(S):
        rf = L["row_src"][:, s][:, rows].to(dt)                  # (D, Rr)
        d_bl = div_t(torch.where(even[None, None, :], rf[:, :, None],
                                 (R - 1) - rf[:, :, None]), R - 1)
        d_row = div_t(rf, R - 1)
        var = (kbl[:, None, None, None] * d_bl[:, None, :, :]
               + kwl[:, None, None, None] * d_wl[None, None, None, :]
               + kmat[:, None, None, None] * d_mat[None, :, None, None]
               + krow[:, None, None, None] * d_row[:, None, :, None])
        t = e5(L["base"][:, pidx]) + stress[None, :, None, None, None] \
            * var[:, None, :, :, :]                              # (D,P,M,Rr,C)
        t = t + e5(adder)
        t = t + e5(L["chip_offsets"][:, 0])
        t = t + e5(L["sub_offsets"][:, s])
        p = fail_mixture_t(t, t_s, e5(L["sigma"]), e5(L["outlier_rate"]),
                           e5(L["outlier_ns"]))
        if multibit:
            lam = torch.clamp_min(div_t(
                2 * iters * chips * multibit_tail_t(p).sum(dim=(2, 3, 4)),
                72.0), 0.0)
        else:
            lam = 2 * iters * chips * p.sum(dim=(2, 3, 4))       # (D, P)
        u = query_uniform_t(L["serial"][:, None], pidx, t_q, int(multibit),
                            s, pat_idx)
        fails |= torch.any(u < -torch.expm1(-lam), dim=1)
    return fails


def _sweep_param(L, geom, consts, pidx: int, floor, rows, stress, adder,
                 guard_cycles: int, iters: int, multibit: bool):
    """One parameter's grid walked downward: the per-DIMM lowest value
    before the first failing or floor-undercutting point, plus the
    guardband, capped at the standard value."""
    grid = AXES[PARAMS[pidx]].grid
    std = getattr(STANDARD, PARAMS[pidx])
    dev = consts[0].device
    stops = []
    for t_op in grid:
        fail = _region_eval(L, geom, consts, pidx, t_op, rows, stress, adder,
                            iters, multibit)
        stops.append(fail | (floor - 1e-9 > t_op))
        if bool(torch.all(stops[-1])):
            break
    stops = torch.stack(stops)                                   # (G', D)
    g = torch.tensor(grid[:len(stops)], dtype=torch.float32, device=dev)
    ok = torch.cumsum(stops.to(torch.int32), dim=0) == 0
    best = torch.min(torch.where(ok, g[:, None], torch.inf), dim=0).values
    best = torch.where(torch.isfinite(best), best, std)
    return torch.clamp_max(best + guard_cycles * CYCLE_NS, std)


def profile_tables(leaves: dict, geom: DimmGeometry, *, device,
                   dtype=torch.float32, region: str = "worst",
                   temp_C: float = 55.0, refresh_ms: float = 64.0,
                   guard_cycles: int = 1, patterns=DEFAULT_PATTERNS,
                   iters: int = DEFAULT_ITERS,
                   multibit_only: bool = False) -> np.ndarray:
    """(D, 4) profiled timing tables in ``PARAMS`` order: tRCD first, tRAS
    floored by tRCD + 10 ns, then tRP and tWR.  ``region`` "worst" is DIVA
    Profiling, "all" conventional every-row profiling."""
    if region == "worst":
        rows_np = worst_rows_internal(geom)
    elif region == "all":
        rows_np = np.arange(geom.rows_per_mat)
    else:
        raise ValueError(f"unknown region {region!r}")
    L = to_tensors(leaves, device, dtype)
    consts = _geom_consts(geom, device, dtype)
    rows = torch.as_tensor(rows_np, dtype=torch.int64, device=device)
    adder = torch.as_tensor(condition_adders(leaves, temp_C, refresh_ms),
                            device=device).to(dtype)
    stress = torch.as_tensor(np.asarray([PATTERN_STRESS[p] for p in patterns],
                                        np.float32), device=device).to(dtype)
    kw = dict(rows=rows, stress=stress, adder=adder,
              guard_cycles=guard_cycles, iters=iters, multibit=multibit_only)
    D = L["serial"].shape[0]
    floor5 = torch.full((D,), 5.0, dtype=torch.float32, device=device)
    trcd = _sweep_param(L, geom, consts, 0, floor5, **kw)
    tras = _sweep_param(L, geom, consts, 1, trcd + 10.0, **kw)
    trp = _sweep_param(L, geom, consts, 2, floor5, **kw)
    twr = _sweep_param(L, geom, consts, 3, floor5, **kw)
    return torch.stack([trcd, tras, trp, twr], dim=1).float().cpu().numpy()


# ----------------------------------------------------- failure grids

def cell_probs(row_src, d_mat, cf, n_cols: int, open_bitline: bool = True,
               voltage: bool = False, retention: bool = False):
    """(D, M, R, C) per-cell failure probabilities of ``row_src`` (D, R)
    from (D, 9) or (D, 15) coefficient rows ``cf``: the access channel,
    shifted by ``cf[9]`` when ``voltage``, plus the retention channel when
    ``retention``."""
    dt, dev = cf.dtype, cf.device
    R = row_src.shape[1]
    rf = row_src.to(dt)[:, None, :, None]
    colf = torch.arange(n_cols, device=dev).to(dt)[None, None, None, :]
    even = (torch.arange(n_cols, device=dev) % 2 == 0)[None, None, None, :]
    dm = d_mat.to(dt)[None, :, None, None]
    c = [cf[:, i, None, None, None] for i in range(cf.shape[1])]
    if open_bitline:
        d_bl = div_t(torch.where(even, rf, (R - 1.0) - rf), R - 1.0)
    else:
        d_bl = div_t(rf, R - 1.0)
    d_wl = div_t(colf, n_cols - 1.0)
    d_row = div_t(rf, R - 1.0)
    t = c[0] + c[1] * d_bl + c[2] * d_wl + c[3] * dm + c[4] * d_row
    if voltage:
        t = t + c[9]
    p = fail_mixture_t(t, c[5], c[6], c[7], c[8])
    if retention:
        slow = c[1] * d_bl + c[2] * d_wl + c[3] * dm + c[4] * d_row
        p = p + retention_fail_mixture_t(slow, c[10], c[11], c[12], c[13],
                                         c[7], c[14])
    return p


def pack_coeffs(L: dict, pidx: int, t_op: float, stress: float, adder,
                chip: int, sub: int):
    """(D, 9) coefficient rows: the effective base, the four
    stress-weighted slopes, t_op, sigma and the outlier mixture."""
    base_eff = (L["base"][:, pidx] + adder + L["chip_offsets"][:, chip]
                + L["sub_offsets"][:, sub])
    stress = float(stress)
    return torch.stack([
        base_eff, stress * L["k_bl"][:, pidx], stress * L["k_wl"][:, pidx],
        stress * L["k_mat"][:, pidx], stress * L["k_row"][:, pidx],
        torch.full_like(base_eff, float(np.float32(t_op))), L["sigma"],
        L["outlier_rate"], L["outlier_ns"]], dim=1)


def pack_op_coeffs(L: dict, pidx: int, t_op: float, stress: float, adder,
                   chip: int, sub: int, shift, ret_x):
    """(D, 15) rows: ``pack_coeffs`` plus the supply's latency shift and
    the retention channel."""
    cf = pack_coeffs(L, pidx, t_op, stress, adder, chip, sub)
    extra = torch.stack([
        shift, L["ret_base"], L["ret_k"],
        torch.full_like(L["ret_base"], float(np.float32(ret_x))),
        L["ret_sigma"], L["ret_drop"]], dim=1)
    return torch.cat([cf, extra], dim=1)


def row_lambda(leaves: dict, geom: DimmGeometry, param: str, t_op: float, *,
               device, dtype=torch.float32, temp_C: float = 85.0,
               refresh_ms: float = 64.0, patterns=DEFAULT_PATTERNS,
               iters: int = DEFAULT_ITERS) -> np.ndarray:
    """(D, subarrays*rows) expected error counts per external row address:
    for each subarray the grids of every pattern, summed over mats and
    columns, times both stripes, the chips and the iterations."""
    L = to_tensors(leaves, device, dtype)
    _, d_mat, _ = _geom_consts(geom, device, dtype)
    adder = torch.as_tensor(condition_adders(leaves, temp_C, refresh_ms),
                            device=device).to(dtype)
    pidx = PARAMS.index(param)
    D, S, R = L["serial"].shape[0], geom.subarrays, geom.rows_per_mat
    lam = []
    for s in range(S):
        exp_row = torch.zeros((D, R), dtype=dtype, device=device)
        for pat in patterns:
            cf = pack_coeffs(L, pidx, t_op, np.float32(PATTERN_STRESS[pat]),
                             adder, 0, s)
            grids = cell_probs(L["row_src"][:, s], d_mat, cf,
                               geom.cols_per_mat, geom.open_bitline)
            exp_row = exp_row + 2 * grids.sum(dim=(1, 3)) * geom.chips
            del grids
        lam.append(exp_row * iters)
    lam = torch.stack(lam, dim=1)                                # (D, S, R)
    idx = L["ext_to_int"][:, None, :].expand(D, S, R)
    return torch.gather(lam, 2, idx).reshape(D, -1).float().cpu().numpy()


def error_summary(leaves: dict, geom: DimmGeometry, param: str, t_op: float,
                  *, device, dtype=torch.float32, temp_C: float = 85.0,
                  refresh_ms: float = 64.0, vdd: float = VDD_STD,
                  retention: bool = False, pattern: str = "0101",
                  chip: int = 0, subarray: int = 0, threshold: float = 0.5,
                  block: int = 64) -> dict:
    """The fail-grid summary of the population, in blocks of ``block``
    DIMMs: per DIMM ``lam_total`` (the grid's sum) and ``worst_cell`` (its
    largest cell) and ``row_fail`` (rows with a cell above ``threshold``);
    over the population ``grid_sum`` (float64) and ``hot_cells`` (the
    number of DIMMs whose cell lies above ``threshold``)."""
    pidx = PARAMS.index(param)
    voltage = vdd != VDD_STD
    stress = np.float32(PATTERN_STRESS[pattern])
    ret_x = retention_stress(temp_C, refresh_ms, vdd)
    M, R, C = geom.mats_x, geom.rows_per_mat, geom.cols_per_mat
    D = len(leaves["serial"])
    adders = condition_adders(leaves, temp_C, refresh_ms)
    shifts = access_vdd_shift(np.asarray(leaves["vdd_coef"], np.float32), vdd)
    out = {"lam_total": [], "worst_cell": [], "row_fail": []}
    grid_sum = torch.zeros((M, R, C), dtype=torch.float64, device=device)
    hot_cells = torch.zeros((M, R, C), dtype=torch.int64, device=device)
    for lo in range(0, D, block):
        part = {k: v[lo:lo + block] for k, v in leaves.items()}
        L = to_tensors(part, device, dtype)
        _, d_mat, _ = _geom_consts(geom, device, dtype)
        adder = torch.as_tensor(adders[lo:lo + block], device=device).to(dtype)
        if voltage or retention:
            shift = torch.as_tensor(shifts[lo:lo + block],
                                    device=device).to(dtype)
            cf = pack_op_coeffs(L, pidx, t_op, stress, adder, chip, subarray,
                                shift, ret_x)
        else:
            cf = pack_coeffs(L, pidx, t_op, stress, adder, chip, subarray)
        grids = cell_probs(L["row_src"][:, subarray], d_mat, cf, C,
                           geom.open_bitline, voltage, retention)
        hot = grids > threshold
        out["lam_total"].append(grids.sum(dim=(1, 2, 3)).float())
        out["worst_cell"].append(grids.amax(dim=(1, 2, 3)).float())
        out["row_fail"].append(torch.any(torch.any(hot, dim=3), dim=1))
        grid_sum += grids.double().sum(dim=0)
        hot_cells += hot.sum(dim=0, dtype=torch.int64)
        del grids, hot
    res = {k: torch.cat(v).cpu().numpy() for k, v in out.items()}
    res["grid_sum"] = grid_sum.cpu().numpy()
    res["hot_cells"] = hot_cells.cpu().numpy()
    return res
