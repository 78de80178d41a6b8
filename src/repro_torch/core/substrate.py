"""Batched characterization substrate on PyTorch: the DIMM population as one
set of tensors on one device.

The counterpart of ``repro.core.substrate`` for the main path:

  * ``DimmBatch``          — stacked per-DIMM leaves (torch tensors), lowered
                             from ``DimmModel``s or carried over from the
                             reference batch's numpy leaves (``from_arrays``).
  * ``fail_prob_grids``    — (D, mats, rows, cols) failure grids through the
                             CUDA ``fail_prob`` kernel (kernels/fail_prob.py).
  * ``row_error_lambda``   — expected per-row error counts (Figs 6/7/14): one
                             ``fail_prob_rows`` launch per (subarray,
                             pattern), the DIMM axis inside the kernel grid
                             and the grid summed on chip.
  * ``profile_population`` — DIVA / conventional profiling of every DIMM
                             (Sec 6.1): plain torch ops, a Python loop where
                             the reference has a ``lax.scan``; with ``axes``
                             beyond the four timings also the safe supply
                             voltage and refresh interval, and with
                             ``retention`` the retention error channel.
  * ``operating_points_population`` / ``operating_grid_arrays`` — per-DIMM
                             ``OperatingPoint``s, and every DIMM evaluated at
                             a static grid of operating points.
  * ``lifetime_population`` — the online re-profiling lifecycle (Sec 6.1
                             fn 2): a Python loop over profiling epochs that
                             re-runs the sweep under each epoch's aging and
                             temperature adders and reports per-DIMM
                             (timing, stale-table failure, ECC exposure)
                             trajectories.
  * ``burst_bit_profile_population`` / ``shuffling_gain_population`` — DIVA
                             Shuffling (Sec 6.2, Fig 17): burst-bit error
                             profiles from the ``fail_prob`` grids, and the
                             SECDED outcome with and without shuffling
                             through the ``diva_shuffle`` and
                             ``secded_syndrome`` kernels.

Monte-Carlo decisions and error draws use the counter hashes of
core/hashing.py, whose torch and numpy forms give the same bits, so the
batched paths reproduce the per-DIMM numpy walkers and the reference's
tables and counts decision for decision.

Entry points run on the batch's device.  A batch lands on CUDA unless the
caller passes ``device="cpu"``; with no CUDA device and no explicit device
the constructors raise.  Results return as numpy, as in the reference.
``mesh=`` (a ``sharding.DimmMesh``) splits the DIMM axis over the mesh's
devices instead (``_run_sharded``): each shard runs the same eager program
on its device and the outputs are gathered on the mesh's first.  Every draw
is keyed by the DIMM's serial, so the split changes no integer and no
decision; float sums over a DIMM's cells may take another order on a
shard's width (the CUDA reductions split by their output count).
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core.errors import DimmModel
from repro_torch.core.geometry import (DimmGeometry, burst_bit_to_mat,
                                       precharge_delay, wordline_distance)
from repro_torch.core.hashing import burst_uniform_t, query_uniform_t
from repro_torch.core.latency import (DEFAULT_ITERS, DEFAULT_PATTERNS,
                                      PATTERN_STRESS, access_vdd_shift,
                                      condition_scalars, div_t, fail_mixture_t,
                                      multibit_tail_t, retention_fail_mixture_t,
                                      retention_stress, worst_rows_internal)
from repro_torch.core.timing import (AXES, CYCLE_NS, EXTENDED_AXES,
                                     OP_GRID_LANE, PARAMS, STANDARD, VDD_STD,
                                     OperatingPoint, TimingParams,
                                     op_point_key)
from repro_torch.device import resolve_device
from repro_torch.kernels.fail_prob import fail_prob, fail_prob_rows
from repro_torch.kernels.secded import syndrome
from repro_torch.kernels.shuffle import apply_shuffle
from repro_torch.obs import tracing as _obs_tracing
from repro_torch.sharding import DimmMesh, mesh_device

TIMING_GRIDS = {p: AXES[p].grid for p in PARAMS}
GRIDS = dict(TIMING_GRIDS, vdd=AXES["vdd"].grid, refresh=AXES["refresh"].grid)


# ------------------------------------------------------------- the batch

_LEAVES = ("serial", "base", "k_bl", "k_wl", "k_mat", "k_row", "sigma",
           "temp_coef", "refresh_coef", "aging_coef", "age_years",
           "outlier_rate", "outlier_ns", "chip_offsets", "sub_offsets",
           "row_src", "int_to_ext", "ext_to_int",
           "vdd_coef", "ret_base", "ret_k", "ret_sigma", "ret_drop")
_NP_DTYPES = {"serial": np.int64, "row_src": np.int32,
              "int_to_ext": np.int32, "ext_to_int": np.int32}  # else float32


@dataclass
class DimmBatch:
    """Stacked per-DIMM state; leading axis D on every leaf, geometry static.

    Coefficient tables are (D, 4) in ``timing.PARAMS`` order; ``row_src`` is
    the repair-resolved internal row source per (D, subarray, row) — repaired
    rows point at their replacement row, everything else at itself.  Every
    leaf is a tensor on one device; ``serial`` is int64 (uint32 in the
    reference).
    """
    geom: DimmGeometry
    serial: Any          # (D,) int64
    base: Any            # (D, 4) f32
    k_bl: Any            # (D, 4) f32
    k_wl: Any            # (D, 4) f32
    k_mat: Any           # (D, 4) f32
    k_row: Any           # (D, 4) f32
    sigma: Any           # (D,) f32
    temp_coef: Any       # (D,) f32
    refresh_coef: Any    # (D,) f32
    aging_coef: Any      # (D,) f32
    age_years: Any       # (D,) f32
    outlier_rate: Any    # (D,) f32
    outlier_ns: Any      # (D,) f32
    chip_offsets: Any    # (D, chips) f32
    sub_offsets: Any     # (D, subarrays) f32
    row_src: Any         # (D, subarrays, R) int32
    int_to_ext: Any      # (D, R) int32
    ext_to_int: Any      # (D, R) int32
    vdd_coef: Any        # (D,) f32
    ret_base: Any        # (D,) f32
    ret_k: Any           # (D,) f32
    ret_sigma: Any       # (D,) f32
    ret_drop: Any        # (D,) f32

    @property
    def n_dimms(self) -> int:
        return int(self.serial.shape[0])

    @property
    def device(self) -> torch.device:
        return self.serial.device

    @classmethod
    def from_arrays(cls, geom_fields: dict, leaves: dict, device=None
                    ) -> "DimmBatch":
        """Build a batch from ``dataclasses.asdict(geom)`` and the 23 leaves
        as numpy arrays (the reference batch's ``_LEAVES``) — how state is
        carried across from the reference package."""
        missing = set(_LEAVES) - set(leaves)
        if missing:
            raise ValueError(f"missing leaves: {sorted(missing)}")
        dev = resolve_device(device)
        kw = {n: torch.as_tensor(
                  np.ascontiguousarray(leaves[n], _NP_DTYPES.get(n, np.float32)),
                  device=dev) for n in _LEAVES}
        return cls(geom=DimmGeometry(**geom_fields), **kw)

    @classmethod
    def from_population(cls, dimms: Sequence[DimmModel], device=None
                        ) -> "DimmBatch":
        """Stack DimmModels (all sharing one geometry) into tensor leaves."""
        if not dimms:
            raise ValueError("empty population: DimmBatch needs >= 1 DimmModel")
        geom = dimms[0].geom
        if any(d.geom != geom for d in dimms):
            raise ValueError("mixed geometries in batch")
        R = geom.rows_per_mat
        rows = np.arange(R)
        f32 = lambda v: np.asarray(v, np.float32)

        def coeff(attr):
            return f32([[getattr(d.vendor, attr)[p] for p in PARAMS]
                        for d in dimms])

        def scalar(attr):
            return f32([getattr(d.vendor, attr) for d in dimms])

        leaves = dict(
            serial=np.asarray([d.serial for d in dimms], np.int64),
            base=coeff("base"), k_bl=coeff("k_bl"), k_wl=coeff("k_wl"),
            k_mat=coeff("k_mat"), k_row=coeff("k_row"),
            age_years=f32([d.age_years for d in dimms]),
            chip_offsets=f32([d.chip_offsets for d in dimms]),
            sub_offsets=f32([d.sub_offsets for d in dimms]),
            row_src=np.stack([np.where(d.repaired, d.repair_perm, rows[None, :])
                              for d in dimms]).astype(np.int32),
            int_to_ext=np.stack([d.vendor.scramble.int_to_ext(rows)
                                 for d in dimms]).astype(np.int32),
            ext_to_int=np.stack([d.vendor.scramble.ext_to_int(rows)
                                 for d in dimms]).astype(np.int32),
            **{a: scalar(a) for a in (
                "sigma", "temp_coef", "refresh_coef", "aging_coef",
                "outlier_rate", "outlier_ns", "vdd_coef", "ret_base", "ret_k",
                "ret_sigma", "ret_drop")})
        return cls.from_arrays(dataclasses.asdict(geom), leaves, device)


def pattern_stress(patterns=DEFAULT_PATTERNS) -> np.ndarray:
    return np.asarray([PATTERN_STRESS[p] for p in patterns], np.float32)


def _geom_consts(geom: DimmGeometry):
    """Static f32 distance tables shared by every DIMM (same die floorplan)."""
    C, M = geom.cols_per_mat, geom.mats_x
    d_wl = np.asarray(wordline_distance(geom, np.arange(C, dtype=np.float32)),
                      np.float32)
    d_mat = np.asarray(precharge_delay(geom, np.arange(M, dtype=np.float32)),
                       np.float32)
    even = (np.arange(C) % 2) == 0 if geom.open_bitline else np.ones(C, bool)
    return d_wl, d_mat, even


# ------------------------------------------------- DIMM-axis sharded dispatch

def _map_leaves(fn, a):
    """``fn`` over the tensor and numpy leaves of ``a``: a ``DimmBatch``
    (its leaves; the geometry stays), a dict, list or tuple of them, or one
    leaf.  Anything else (a number, a string, None) passes through."""
    if isinstance(a, (torch.Tensor, np.ndarray)):
        return fn(a)
    if isinstance(a, DimmBatch):
        return dataclasses.replace(
            a, **{n: fn(getattr(a, n)) for n in _LEAVES})
    if isinstance(a, dict):
        return {k: _map_leaves(fn, v) for k, v in a.items()}
    if isinstance(a, (list, tuple)):
        return type(a)(_map_leaves(fn, v) for v in a)
    return a


def _pad0(a, pad: int):
    """Pad dim 0 of every leaf of ``a`` by repeating its last entry ``pad``
    times (tensors in torch, numpy arrays in numpy).  Padding clones a real
    DIMM: its serial travels with it, so its (discarded) draws are that
    DIMM's and every kept DIMM's draws are untouched."""
    if pad == 0:
        return a

    def grow(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)

    return _map_leaves(grow, a)


def _on(dev: torch.device):
    """The current-device context a shard's launches need on a card."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _shard_outputs(mesh: DimmMesh, impl, args, statics: dict,
                   batch_argnums: tuple):
    """Run ``impl(*shard_args, **statics)`` once per mesh device with dim 0
    of every ``batch_argnums`` argument (trees included) split into
    ``mesh.size`` contiguous shards, D clone-padded up to a multiple of the
    size first.  Every other argument's tensors are copied to each shard's
    device.  All shards' inputs are placed before the first launch and every
    shard is launched before any output is read, so shards on distinct cards
    overlap (an ``impl`` that reads the device itself, as the sweeps' early
    exit does, serializes them).  Returns (the shard outputs in mesh order,
    D)."""
    D = _lead(args[batch_argnums[0]])
    pad = (-D) % mesh.size
    per = (D + pad) // mesh.size
    args = [_pad0(a, pad) if i in batch_argnums else a
            for i, a in enumerate(args)]

    def to(x, dev):
        return x.to(dev) if isinstance(x, torch.Tensor) else x

    shards = [[_map_leaves(lambda x: to(x[k * per:(k + 1) * per], dev), a)
               if i in batch_argnums else _map_leaves(lambda x: to(x, dev), a)
               for i, a in enumerate(args)]
              for k, dev in enumerate(mesh.devices)]
    del args
    outs = []
    for dev, shard in zip(mesh.devices, shards):
        with _on(dev):
            outs.append(impl(*shard, **statics))
    return outs, D


def _lead(a) -> int:
    """D: dim 0 of a batch argument (its first leaf for a dict or tuple)."""
    if isinstance(a, DimmBatch):
        return a.n_dimms
    if isinstance(a, (torch.Tensor, np.ndarray)):
        return int(a.shape[0])
    return _lead(next(iter(a.values() if isinstance(a, dict) else a)))


def _gather(parts: list, dev: torch.device, D: int):
    """Concatenate shard outputs (tensors, or dicts / tuples of them) along
    dim 0 on ``dev`` and slice the padding off."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], dev, D) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([p[i] for p in parts], dev, D)
                           for i in range(len(first)))
    if len(parts) == 1:
        return first.to(dev)[:D]
    return torch.cat([p.to(dev) for p in parts], dim=0)[:D]


def _run_sharded(mesh: DimmMesh, impl, args, statics: dict,
                 batch_argnums: tuple):
    """``impl(*args, **statics)`` with the DIMM axis of the ``batch_argnums``
    arguments split over ``mesh`` (``_shard_outputs``) and every output's
    dim 0 gathered on ``mesh.devices[0]`` and sliced back to D, so any
    population size runs on any mesh.  The port compiles nothing, so
    there is no program cache."""
    outs, D = _shard_outputs(mesh, impl, args, statics, batch_argnums)
    return _gather(outs, mesh.devices[0], D)


def _dispatch(mesh: DimmMesh | None, impl, args, statics: dict,
              batch_argnums: tuple):
    """One dispatch site for every population entry point: ``impl`` on the
    arguments as they are without a mesh, the sharded route with one."""
    if mesh is None:
        return impl(*args, **statics)
    return _run_sharded(mesh, impl, args, statics, batch_argnums)


def condition_adders(batch: DimmBatch, temp_C: float,
                     refresh_ms: float) -> np.ndarray:
    """(D,) f32 operating-condition adders, computed on the host in numpy
    with the op order of ``latency.condition_adder`` — the per-DIMM walker,
    the reference and this sweep add identical bits."""
    t_delta, r_log = condition_scalars(temp_C, refresh_ms)
    host = lambda a: a.cpu().numpy().astype(np.float32)
    return (host(batch.temp_coef) * t_delta
            + host(batch.refresh_coef) * r_log
            + host(batch.aging_coef) * host(batch.age_years))


# ------------------------------------------------- region failure decisions

def _row_distances(batch: DimmBatch, s: int, rows, even):
    """Bitline (D, Rr, C) and row-index (D, Rr) distances of subarray ``s``'s
    test rows after repair, for a shared (Rr,) or per-DIMM (D, Rr) region."""
    R = batch.geom.rows_per_mat
    row_src_s = batch.row_src[:, s]                              # (D, R)
    if rows.dim() == 2:                                          # per-DIMM
        rsel = torch.gather(row_src_s, 1, rows)
    else:
        rsel = row_src_s[:, rows]
    rf = rsel.to(torch.float32)                                  # (D, Rr)
    d_bl = div_t(torch.where(even[None, None, :], rf[:, :, None],
                             (R - 1) - rf[:, :, None]), R - 1)
    return d_bl, div_t(rf, R - 1)


def _channel_lam(pr, chips: int, iters: int, multibit: bool):
    """(D, P) expected failures of one error channel's (D, P, M, Rr, C)
    probabilities: all failing cells, or SECDED-uncorrectable codewords."""
    if multibit:
        return torch.clamp_min(
            div_t(2 * iters * chips * multibit_tail_t(pr).sum(dim=(2, 3, 4)),
                  72.0), 0.0)
    return 2 * iters * chips * pr.sum(dim=(2, 3, 4))


def _region_eval(batch: DimmBatch, pidx: int, t_op, rows, stress,
                 adder, iters: int, multibit: bool, banks: int = 1,
                 extra=None):
    """Monte-Carlo region test of the whole batch at one operating point.

    Returns ``(fails, lam_total)``: (D, banks) bool — does the row region
    fail the test at ``t_op`` in each bank — and (D, banks) f32 — the
    expected failure count behind the accept/reject draws, summed over the
    bank's subarrays and patterns (the ECC-exposure integrand of the lifetime
    sweep when ``multibit``).  ``banks`` partitions the subarray axis into
    equal contiguous groups; ``banks=1`` is the whole-DIMM test.

    ``t_op`` is a Python float (one grid point for everyone), a (D,) f32
    tensor (each DIMM at its own value) or a (D, S) f32 tensor (each
    subarray at its bank's own value); the hash sees the same per-DIMM bits
    in every layout.  ``rows`` is a shared (Rr,) internal row region or a
    per-DIMM (D, Rr) table (int64); ``stress`` the (P,) pattern stresses and
    ``adder`` the (D,) host-computed condition term, both f32 on the batch's
    device.  ``extra`` is an optional (D,) f32 required-latency addend (the
    access-channel voltage shift of a non-nominal supply); ``None`` leaves
    the sum as it was without it.  Mirrors the reference's ``_region_eval``
    operation for operation in float32, including the broadcast order of the
    ``t`` sum; subarrays run in a Python loop.
    """
    g = batch.geom
    S, chips = g.subarrays, g.chips
    subs_per_bank = S // banks
    dev = batch.device
    d_wl, d_mat, even = (torch.as_tensor(a, device=dev)
                         for a in _geom_consts(g))
    base = batch.base[:, pidx]
    kbl, kwl = batch.k_bl[:, pidx], batch.k_wl[:, pidx]
    kmat, krow = batch.k_mat[:, pidx], batch.k_row[:, pidx]
    chip0 = batch.chip_offsets[:, 0]
    t_cell = torch.as_tensor(t_op, dtype=torch.float32, device=dev)
    t_q = torch.round(t_cell * 4).to(torch.int64)
    P = stress.shape[0]
    pat_idx = torch.arange(P, device=dev)[None, :]
    e5 = lambda v: v[:, None, None, None, None]
    D = batch.n_dimms
    fails = torch.zeros((D, banks), dtype=torch.bool, device=dev)
    lam_total = torch.zeros((D, banks), dtype=torch.float32, device=dev)
    for s in range(S):
        if t_cell.dim() == 2:                                    # (D, S) tables
            t_s, t_hash = e5(t_cell[:, s]), t_q[:, s, None]
        elif t_cell.dim() == 1:                                  # (D,) values
            t_s, t_hash = e5(t_cell), t_q[:, None]
        else:
            t_s, t_hash = t_cell, t_q
        d_bl, d_row = _row_distances(batch, s, rows, even)
        var = (kbl[:, None, None, None] * d_bl[:, None, :, :]
               + kwl[:, None, None, None] * d_wl[None, None, None, :]
               + kmat[:, None, None, None] * d_mat[None, :, None, None]
               + krow[:, None, None, None] * d_row[:, None, :, None])
        t = e5(base) + stress[None, :, None, None, None] \
            * var[:, None, :, :, :]                              # (D,P,M,Rr,C)
        t = t + e5(adder)
        if extra is not None:
            t = t + e5(extra)
        t = t + e5(chip0)
        t = t + e5(batch.sub_offsets[:, s])
        p = fail_mixture_t(t, t_s, e5(batch.sigma), e5(batch.outlier_rate),
                           e5(batch.outlier_ns))
        lam = _channel_lam(p, chips, iters, multibit)            # (D, P)
        u = query_uniform_t(batch.serial[:, None], pidx, t_hash,
                            int(multibit), s, pat_idx)
        fail_s = torch.any(u < -torch.expm1(-lam), dim=1)        # (D,)
        b = s // subs_per_bank
        fails[:, b] |= fail_s
        lam_total[:, b] = lam_total[:, b] + lam.sum(dim=1)
    return fails, lam_total


def _sweep_param(batch: DimmBatch, pidx: int, floor, rows, stress, adder,
                 guard_cycles: int, iters: int, multibit: bool,
                 banks: int = 1, extra=None):
    """Walk one parameter's timing grid downward; per-(DIMM, bank) min-safe
    value (``floor`` is (D, banks)).

    Reproduces the walker: stop at the first grid point that fails or
    undercuts the floor, keep the last safe value, add the guardband.  The
    walk ends early once every (DIMM, bank) has stopped; the remaining grid
    points cannot change the result.  While a trace is recorded the walk is
    a ``sweep.param`` span whose ``points`` counts the grid points it
    evaluated: its host syncs.
    """
    grid = TIMING_GRIDS[PARAMS[pidx]]
    std = getattr(STANDARD, PARAMS[pidx])
    stops = []
    with _obs_tracing.span_if_active("sweep.param", param=PARAMS[pidx]) as sp:
        for t_op in grid:
            fail, _ = _region_eval(batch, pidx, t_op, rows, stress, adder,
                                   iters, multibit, banks, extra)
            stops.append(fail | (floor - 1e-9 > t_op))
            if bool(torch.all(stops[-1])):
                break
        sp.set(points=len(stops))
    stops = torch.stack(stops)                                   # (G', D, banks)
    g = torch.tensor(grid[:len(stops)], dtype=torch.float32,
                     device=batch.device)
    ok = torch.cumsum(stops.to(torch.int32), dim=0) == 0
    best = torch.min(torch.where(ok, g[:, None, None], torch.inf), dim=0).values
    best = torch.where(torch.isfinite(best), best, std)
    return torch.clamp_max(best + guard_cycles * CYCLE_NS, std)


def _op_region_eval(batch: DimmBatch, t_subs, rows, stress, adder, extra,
                    lane: int, key_q: int, iters: int, multibit: bool,
                    banks: int, retention: bool, ret_x):
    """Monte-Carlo region test of the whole batch at one operating point.

    Every timing parameter at its (D, S, 4) per-subarray table value
    ``t_subs``, plus the retention error channel when ``retention``, with
    one accept/reject draw per (subarray, pattern) keyed on ``(lane,
    key_q)`` and never on the ambient conditions.  ``extra`` is the (D,)
    access-channel voltage shift or None; ``ret_x`` a 0-d f32 retention
    stress.  Returns ``(fails, lam)``, both (D, banks): lam sums the access
    channel over the four parameters plus the retention channel.  Mirrors
    the reference's ``_op_region_eval`` operation for operation; subarrays
    run in a Python loop.
    """
    g = batch.geom
    S, chips = g.subarrays, g.chips
    subs_per_bank = S // banks
    dev = batch.device
    d_wl, d_mat, even = (torch.as_tensor(a, device=dev)
                         for a in _geom_consts(g))
    chip0 = batch.chip_offsets[:, 0]
    P = stress.shape[0]
    pat_idx = torch.arange(P, device=dev)[None, :]
    e5 = lambda v: v[:, None, None, None, None]
    D = batch.n_dimms
    fails = torch.zeros((D, banks), dtype=torch.bool, device=dev)
    lam_total = torch.zeros((D, banks), dtype=torch.float32, device=dev)
    for s in range(S):
        d_bl, d_row = _row_distances(batch, s, rows, even)
        sub_off = batch.sub_offsets[:, s]
        lam_sp = torch.zeros((D, P), dtype=torch.float32, device=dev)
        var_tras = None
        for p in range(len(PARAMS)):
            var = (batch.k_bl[:, p][:, None, None, None] * d_bl[:, None, :, :]
                   + batch.k_wl[:, p][:, None, None, None]
                   * d_wl[None, None, None, :]
                   + batch.k_mat[:, p][:, None, None, None]
                   * d_mat[None, :, None, None]
                   + batch.k_row[:, p][:, None, None, None]
                   * d_row[:, None, :, None])
            if p == 1:
                var_tras = var   # tRAS (charge restore) drives retention too
            t = e5(batch.base[:, p]) + stress[None, :, None, None, None] \
                * var[:, None, :, :, :]                          # (D,P,M,Rr,C)
            t = t + e5(adder)
            if extra is not None:
                t = t + e5(extra)
            t = t + e5(chip0)
            t = t + e5(sub_off)
            pr = fail_mixture_t(t, e5(t_subs[:, s, p]), e5(batch.sigma),
                                e5(batch.outlier_rate), e5(batch.outlier_ns))
            lam_sp = lam_sp + _channel_lam(pr, chips, iters, multibit)
        if retention:
            slow = stress[None, :, None, None, None] * var_tras[:, None, :, :, :]
            pr = retention_fail_mixture_t(
                slow, e5(batch.ret_base), e5(batch.ret_k), ret_x,
                e5(batch.ret_sigma), e5(batch.outlier_rate),
                e5(batch.ret_drop))
            lam_sp = lam_sp + _channel_lam(pr, chips, iters, multibit)
        u = query_uniform_t(batch.serial[:, None], lane, key_q, int(multibit),
                            s, pat_idx)
        fail_s = torch.any(u < -torch.expm1(-lam_sp), dim=1)     # (D,)
        b = s // subs_per_bank
        fails[:, b] |= fail_s
        lam_total[:, b] = lam_total[:, b] + lam_sp.sum(dim=1)
    return fails, lam_total


def _sweep_axis(batch: DimmBatch, axis: str, t_subs, rows, stress,
                extras_gd, adders_gd, keys_g, retx_g, guard_cycles: int,
                iters: int, multibit: bool, banks: int, retention: bool):
    """Walk one non-timing axis's grid (vdd / refresh) with the timing table
    at standard values (``t_subs``): the per-(DIMM, bank) most aggressive
    safe value.  The guardband retreats ``guard_cycles`` grid steps toward
    standard; fewer safe points than that gives the standard value.  The
    walk ends early once every (DIMM, bank) has stopped; the remaining grid
    points cannot change the count of leading safe points.  Traced as
    ``_sweep_param``'s walk is (``sweep.param``, ``param=axis``).
    """
    spec = AXES[axis]
    stops = []
    with _obs_tracing.span_if_active("sweep.param", param=axis) as sp:
        for i in range(len(spec.grid)):
            fail, _ = _op_region_eval(batch, t_subs, rows, stress,
                                      adders_gd[i], extras_gd[i], spec.index,
                                      int(keys_g[i]), iters, multibit, banks,
                                      retention, retx_g[i])
            stops.append(fail)
            if bool(torch.all(fail)):
                break
        sp.set(points=len(stops))
    stops = torch.stack(stops)                                   # (G', D, banks)
    n_ok = torch.sum(torch.cumsum(stops.to(torch.int32), dim=0) == 0, dim=0)
    idx = n_ok - 1 - guard_cycles                                # (D, banks)
    grid = torch.tensor(spec.grid, dtype=torch.float32, device=batch.device)
    vals = grid[torch.clamp(idx, 0, len(spec.grid) - 1)]
    return torch.where(idx >= 0, vals,
                       torch.tensor(spec.standard, dtype=torch.float32,
                                    device=batch.device))


def _profile_impl(batch: DimmBatch, rows, stress, adder, ctx_d=None,
                  ctx_g=None, *, guard_cycles: int, iters: int,
                  multibit: bool, banks: int = 1, axes=PARAMS,
                  retention: bool = False):
    """The whole-population sweep: tRCD first, tRAS floored by tRCD + 10 ns
    (the Section 4 infrastructure constraint), then tRP and tWR — then the
    further operating-point axes of ``axes`` ("vdd", "refresh"), each swept
    one knob at a time at standard timing.  Returns (D, banks, len(axes)).

    ``ctx_d``/``ctx_g`` are the host-computed per-axis tables of
    ``_axis_context``, as tensors on the batch's device (ctx_g's keys stay
    numpy).  With the default ``axes=PARAMS``, no context and no retention
    this is the 4-parameter sweep, operation for operation.
    """
    if tuple(axes[:len(PARAMS)]) != PARAMS:
        raise ValueError(f"axes must keep the 4 timing params as a prefix, "
                         f"got {axes!r}")
    D, S = batch.n_dimms, batch.geom.subarrays
    dev = batch.device
    extra = None if not ctx_d else ctx_d.get("vdd_extra")
    kw = dict(rows=rows, stress=stress, adder=adder, banks=banks,
              guard_cycles=guard_cycles, iters=iters, multibit=multibit,
              extra=extra)
    floor5 = torch.full((D, banks), 5.0, dtype=torch.float32, device=dev)
    res = {}
    res["trcd"] = trcd = _sweep_param(batch, 0, floor5, **kw)
    res["tras"] = _sweep_param(batch, 1, trcd + 10.0, **kw)
    res["trp"] = _sweep_param(batch, 2, floor5, **kw)
    res["twr"] = _sweep_param(batch, 3, floor5, **kw)
    extra_axes = tuple(axes[len(PARAMS):])
    if extra_axes:
        std_t = torch.tensor([getattr(STANDARD, p) for p in PARAMS],
                             dtype=torch.float32, device=dev)
        t_subs = std_t[None, None, :].expand(D, S, len(PARAMS))
        for ax in extra_axes:
            if ax == "vdd":
                extras_gd = ctx_d["vdd_shift"].T                 # (G, D)
                adders_gd = adder[None, :].expand(extras_gd.shape[0], D)
            elif ax == "refresh":
                adders_gd = adder[None, :] + ctx_d["refresh_delta"].T
                base_extra = extra if extra is not None \
                    else torch.zeros((D,), dtype=torch.float32, device=dev)
                extras_gd = base_extra[None, :].expand(adders_gd.shape[0], D)
            else:
                raise ValueError(f"unknown operating-point axis {ax!r}")
            res[ax] = _sweep_axis(
                batch, ax, t_subs, rows, stress, extras_gd, adders_gd,
                ctx_g[f"{ax}_keys"], ctx_g[f"{ax}_retx"], guard_cycles,
                iters, multibit, banks, retention)
    return torch.stack([res[a] for a in axes], dim=2)


def _resolve_rows(region, geom: DimmGeometry, n_dimms: int | None = None
                  ) -> np.ndarray:
    """Region spec -> internal row indices: the named regions, a shared (Rr,)
    index array, or a per-DIMM (D, Rr) table (each DIMM tests its own rows —
    the blind-discovery mode)."""
    if isinstance(region, str):
        if region == "worst":
            return worst_rows_internal(geom)
        if region == "all":
            return np.arange(geom.rows_per_mat)
        raise ValueError(f"unknown region {region!r}; "
                         "use 'worst', 'all', or an index array")
    rows = np.asarray(region)
    if rows.ndim not in (1, 2):
        raise ValueError(f"region must be (rows,) or (dimms, rows); "
                         f"got shape {rows.shape}")
    if rows.ndim == 2 and n_dimms is not None and rows.shape[0] != n_dimms:
        raise ValueError(f"per-DIMM region has {rows.shape[0]} rows for "
                         f"{n_dimms} DIMMs")
    if rows.size and (rows.min() < 0 or rows.max() >= geom.rows_per_mat):
        raise ValueError(f"region rows must lie in [0, {geom.rows_per_mat})")
    return rows


def _axis_context(batch: DimmBatch, axes, *, temp_C: float, refresh_ms: float,
                  vdd: float):
    """Host-computed per-axis tables for the operating-point sweep, in numpy
    float32 with the op order of the latency-module helpers (the reference's
    ``_axis_context``): every operating-point-dependent float enters the
    sweep as data.  Returns ``(ctx_d, ctx_g)``: DIMM-leading (D,) / (D, G)
    f32 tables and per-grid-point (G,) uint32 hash keys and f32 retention
    stresses, as tensors on the batch's device (the keys stay numpy); both
    ``None`` at the nominal supply with no extra axes.
    """
    ctx_d, ctx_g = {}, {}
    vc = batch.vdd_coef.cpu().numpy()
    if vdd != VDD_STD:
        ctx_d["vdd_extra"] = access_vdd_shift(vc, vdd)
    if "vdd" in axes:
        spec = AXES["vdd"]
        ctx_d["vdd_shift"] = np.stack(
            [access_vdd_shift(vc, v) for v in spec.grid], axis=1)
        ctx_g["vdd_keys"] = np.asarray([spec.quantize(v) for v in spec.grid],
                                       np.uint32)
        ctx_g["vdd_retx"] = np.asarray(
            [retention_stress(temp_C, refresh_ms, v) for v in spec.grid],
            np.float32)
    if "refresh" in axes:
        spec = AXES["refresh"]
        base = condition_adders(batch, temp_C, refresh_ms)
        ctx_d["refresh_delta"] = np.stack(
            [condition_adders(batch, temp_C, r) - base for r in spec.grid],
            axis=1).astype(np.float32)
        ctx_g["refresh_keys"] = np.asarray(
            [spec.quantize(r) for r in spec.grid], np.uint32)
        ctx_g["refresh_retx"] = np.asarray(
            [retention_stress(temp_C, r, vdd) for r in spec.grid], np.float32)
    if not ctx_d and not ctx_g:
        return None, None
    dev = batch.device
    return ({k: torch.as_tensor(v, device=dev) for k, v in ctx_d.items()},
            {k: v if k.endswith("_keys") else torch.as_tensor(v, device=dev)
             for k, v in ctx_g.items()})


def profile_population_arrays(batch: DimmBatch, *, region="worst",
                              temp_C: float = 55.0, refresh_ms: float = 64.0,
                              vdd: float = VDD_STD, guard_cycles: int = 1,
                              multibit_only: bool = False,
                              patterns=DEFAULT_PATTERNS,
                              iters: int = DEFAULT_ITERS,
                              banks: int = 1, axes=PARAMS,
                              retention: bool = False,
                              mesh: DimmMesh | None = None) -> np.ndarray:
    """(D, len(axes)) profiled operating values for every DIMM, or
    (D, banks, len(axes)) per-bank tables when ``banks > 1``; the first four
    columns are the timing table in PARAMS order.

    ``region="worst"`` is DIVA Profiling (the design-induced slowest rows);
    ``region="all"`` is conventional every-row profiling; an (Rr,) array is a
    shared internal row region and a (D, Rr) array gives every DIMM its own.
    ``banks`` partitions the subarray axis into that many equal bank groups,
    each profiled against only its own subarrays.  ``axes`` extends the
    sweep beyond the four timings with "vdd" and "refresh", each swept one
    knob at a time at standard timing; ``vdd`` is the ambient supply of the
    timing sweeps, and ``retention`` adds the retention error channel to the
    non-timing axes' evaluations.  ``mesh`` shards the DIMM axis; the
    tables are those of the unsharded call.
    """
    if batch.geom.subarrays % banks != 0:
        raise ValueError(f"banks={banks} must divide "
                         f"subarrays={batch.geom.subarrays}")
    axes = tuple(axes)
    dev = batch.device
    rows = torch.as_tensor(_resolve_rows(region, batch.geom, batch.n_dimms),
                           dtype=torch.int64, device=dev)
    adder = torch.as_tensor(condition_adders(batch, temp_C, refresh_ms),
                            device=dev)
    stress = torch.as_tensor(pattern_stress(patterns), device=dev)
    ctx_d, ctx_g = _axis_context(batch, axes, temp_C=temp_C,
                                 refresh_ms=refresh_ms, vdd=vdd)
    args = (batch, rows, stress, adder)
    # a per-DIMM region is batch-shaped: it shards with the DIMM axis
    argnums = (0, 1, 3) if rows.dim() == 2 else (0, 3)
    if ctx_d is not None:
        args, argnums = args + (ctx_d, ctx_g), argnums + (4,)
    statics = dict(guard_cycles=guard_cycles, iters=iters,
                   multibit=multibit_only, banks=banks, axes=axes,
                   retention=retention)
    out = _dispatch(mesh, _profile_impl, args, statics, argnums).cpu().numpy()
    return out[:, 0] if banks == 1 else out


def profile_population(batch: DimmBatch, **kw) -> list[TimingParams]:
    """Per-DIMM ``TimingParams`` for the whole population (see the arrays
    variant; ``banks`` must stay 1).  With extended ``axes`` only the
    4-timing prefix lands in the ``TimingParams``."""
    arr = profile_population_arrays(batch, **kw)
    return [TimingParams(*(float(v) for v in row[:len(PARAMS)]))
            for row in arr]


def operating_points_population(batch: DimmBatch, *, temp_C: float = 55.0,
                                vdd: float = VDD_STD, **kw
                                ) -> list[OperatingPoint]:
    """Per-DIMM ``OperatingPoint`` over the full extended axis list: the
    timing table plus the min-safe supply voltage and the max-safe refresh
    interval, each profiled one knob at a time with the retention channel
    live (defaults ``axes=EXTENDED_AXES``, ``retention=True``)."""
    kw.setdefault("axes", EXTENDED_AXES)
    kw.setdefault("retention", True)
    arr = profile_population_arrays(batch, temp_C=temp_C, vdd=vdd, **kw)
    axes = tuple(kw["axes"])
    out = []
    for row in arr:
        d = dict(zip(axes, (float(v) for v in row)))
        out.append(OperatingPoint(
            timing=TimingParams(*(d[p] for p in PARAMS)),
            vdd=d.get("vdd", vdd), temp_C=temp_C,
            refresh_ms=d.get("refresh", 64.0)))
    return out


# --------------------------------------------- lifetime sweeps (Sec 6.1 fn 2)

def lifetime_adders(batch: DimmBatch, ages, temps,
                    refresh_ms: float = 64.0) -> np.ndarray:
    """(E, D) f32 per-epoch operating-condition adders, on the host in numpy
    with the op order of ``latency.condition_adder`` — the per-DIMM lifecycle
    (``profiling.lifetime_loop``), the reference and the epoch loop add
    identical bits.

    ``ages`` / ``temps``: per-epoch (E,) or per-epoch-per-DIMM (E, D) values;
    ``ages`` *overrides* the batch's static ``age_years`` leaf — the epoch
    schedule owns the drift.
    """
    D = batch.n_dimms
    ages = np.asarray(ages, np.float32)
    temps = np.asarray(temps, np.float64)
    if ages.ndim == 1:
        ages = np.broadcast_to(ages[:, None], (ages.shape[0], D))
    if temps.ndim == 1:
        temps = np.broadcast_to(temps[:, None], (temps.shape[0], D))
    if not (ages.shape == temps.shape == (ages.shape[0], D)):
        raise ValueError(f"ages {ages.shape} / temps {temps.shape} must both "
                         f"resolve to (n_epochs, {D})")
    t_delta = np.float32(temps - 85.0)
    _, r_log = condition_scalars(85.0, refresh_ms)
    host = lambda a: a.cpu().numpy().astype(np.float32)[None, :]
    return (host(batch.temp_coef) * t_delta + host(batch.refresh_coef) * r_log
            + host(batch.aging_coef) * ages)


def _lifetime_impl(batch: DimmBatch, rows, stress, adders_de, ctx_d=None,
                   ctx_g=None, *, guard_cycles: int, iters: int,
                   multibit: bool, diagnostics: bool, banks: int = 1,
                   axes=PARAMS, retention: bool = False):
    """Profiling epochs in a Python loop on the batch's device (the
    reference's ``lax.scan``); ``adders_de`` is the (D, E) f32 tensor of
    per-epoch condition adders, DIMM-leading so that the sharded route splits
    dim 0 as it does every other batch argument.

    Each epoch re-runs the full sweep under that epoch's conditions; with
    ``diagnostics`` it also reports, per (DIMM, bank):
      * ``stale``: would the PREVIOUS epoch's table (the standard table at
        epoch 0) now fail the region test — the aging-drift unsafety that
        static AL-DRAM-style tables accumulate (Sec 6.1 fn 2);
      * ``ecc``: expected SECDED-multi-bit codewords of the region test at
        the freshly profiled point — the residual ECC exposure.
    With ``banks > 1`` each epoch profiles (D, banks, n_axes) tables and the
    stale test runs every subarray at its own bank's previous value.  The
    diagnostics evaluate the 4-timing prefix of ``axes``.

    Returns DIMM-leading trajectories: (D, E, banks, len(axes)) timings,
    and with ``diagnostics`` (D, E, banks) bool stale decisions and
    (D, E, banks) f32 ECC exposures.
    """
    D, S = batch.n_dimms, batch.geom.subarrays
    dev = batch.device
    sub_bank = torch.arange(S, device=dev) // (S // banks)
    std = torch.tensor([AXES[a].standard for a in axes], dtype=torch.float32,
                       device=dev)
    extra = None if not ctx_d else ctx_d.get("vdd_extra")
    kw = dict(rows=rows, stress=stress, guard_cycles=guard_cycles,
              iters=iters, multibit=multibit, banks=banks, axes=axes,
              retention=retention)
    prev = std.expand(D, banks, len(axes))
    timings, stales, eccs = [], [], []
    for e in range(adders_de.shape[1]):
        adder = adders_de[:, e]
        t_new = _profile_impl(batch, adder=adder, ctx_d=ctx_d, ctx_g=ctx_g,
                              **kw)                              # (D, banks, n_axes)
        timings.append(t_new)
        if diagnostics:
            stale = torch.zeros((D, banks), dtype=torch.bool, device=dev)
            ecc = torch.zeros((D, banks), dtype=torch.float32, device=dev)
            for p in range(len(PARAMS)):
                # each subarray at ITS bank's value: the (D, banks) column
                # spread to a (D, S) per-subarray table
                fail_p, _ = _region_eval(batch, p, prev[:, sub_bank, p], rows,
                                         stress, adder, iters, multibit, banks,
                                         extra)
                stale = stale | fail_p
                _, lam_p = _region_eval(batch, p, t_new[:, sub_bank, p], rows,
                                        stress, adder, iters, True, banks,
                                        extra)
                ecc = ecc + lam_p
            stales.append(stale)
            eccs.append(ecc)
        prev = t_new
    out = (torch.stack(timings, dim=1),)
    if diagnostics:
        out += (torch.stack(stales, dim=1), torch.stack(eccs, dim=1))
    return out


def lifetime_population(batch: DimmBatch, ages, temps, *,
                        refresh_ms: float = 64.0, vdd: float = VDD_STD,
                        region="worst", guard_cycles: int = 1,
                        multibit: bool = True, patterns=DEFAULT_PATTERNS,
                        iters: int = DEFAULT_ITERS, diagnostics: bool = True,
                        banks: int = 1, axes=PARAMS,
                        retention: bool = False,
                        mesh: DimmMesh | None = None) -> dict:
    """The whole online re-profiling lifecycle of every DIMM, on the batch's
    device.

    ``ages`` / ``temps`` give each profiling epoch's operating point ((E,) or
    (E, D)); every epoch re-runs the DIVA sweep under drifted conditions —
    the Sec 6.1 argument for *online* profiling, and the drift that makes
    static AL-DRAM tables unsafe.  Epoch-by-epoch timing decisions are those
    of the per-DIMM walker (``profiling.lifetime_loop``) via the shared
    per-query hash.

    Returns epoch-leading numpy arrays: ``timings`` (E, D, 4) ns in PARAMS
    order, ``stale_fail`` (E, D) bool (previous epoch's table — standard at
    epoch 0 — now fails the region test), ``ecc_lambda`` (E, D) expected
    multi-bit codewords at the fresh operating point, plus the resolved
    (E, D) ``ages``/``temps`` schedule.  ``banks > 1`` threads per-bank
    tables through every epoch: ``timings`` becomes (E, D, banks, 4) and the
    diagnostics (E, D, banks).  ``diagnostics=False`` skips the stale/ECC
    evaluations (and their keys) — the timing-only mode of the ALDRAM /
    DivaProfiler wrappers.  ``axes``/``vdd``/``retention`` extend each
    epoch's sweep to the full operating-point space (see
    ``profile_population_arrays``); ``timings`` then carries len(axes)
    columns per epoch.  ``mesh`` shards the DIMM axis.
    """
    if batch.geom.subarrays % banks != 0:
        raise ValueError(f"banks={banks} must divide "
                         f"subarrays={batch.geom.subarrays}")
    axes = tuple(axes)
    dev = batch.device
    rows = torch.as_tensor(_resolve_rows(region, batch.geom, batch.n_dimms),
                           dtype=torch.int64, device=dev)
    adders = lifetime_adders(batch, ages, temps, refresh_ms)     # (E, D)
    # the per-axis context is epoch-constant: refresh deltas and vdd shifts
    # do not depend on the age/temperature schedule
    ctx_d, ctx_g = _axis_context(batch, axes, temp_C=85.0,
                                 refresh_ms=refresh_ms, vdd=vdd)
    args = (batch, rows, torch.as_tensor(pattern_stress(patterns), device=dev),
            torch.as_tensor(np.ascontiguousarray(adders.T), device=dev))
    argnums = (0, 1, 3) if rows.dim() == 2 else (0, 3)
    if ctx_d is not None:
        args, argnums = args + (ctx_d, ctx_g), argnums + (4,)
    statics = dict(guard_cycles=guard_cycles, iters=iters, multibit=multibit,
                   diagnostics=diagnostics, banks=banks, axes=axes,
                   retention=retention)
    out = _dispatch(mesh, _lifetime_impl, args, statics, argnums)
    # drop the bank axis in whole-DIMM mode (timings (D,E,1,4) -> (D,E,4)),
    # then epoch-leading
    out = [np.ascontiguousarray(np.moveaxis(
        (v[:, :, 0] if banks == 1 else v).cpu().numpy(), 0, 1)) for v in out]
    E, D = adders.shape
    # the resolved schedule: ages are consumed as f32, temps as f64
    to_ed = lambda v, dt: np.broadcast_to(
        np.asarray(v, dt).reshape((E, -1)), (E, D)).copy()
    res = {"timings": out[0], "ages": to_ed(ages, np.float32),
           "temps": to_ed(temps, np.float64)}
    if diagnostics:
        res["stale_fail"], res["ecc_lambda"] = out[1], out[2]
    return res


# ------------------------------------------- operating-grid sweeps (N-axis)

def operating_grid_tables(batch: DimmBatch, points) -> tuple:
    """Host-side numpy tables for a static grid of ``OperatingPoint``s:
    per-point timing rows (G, 4) f32, per-DIMM condition adders and voltage
    shifts (D, G) f32, per-point hash keys (G,) uint32 folding the quantized
    timing/vdd/refresh coordinates (``timing.op_point_key``; temperature
    never keys a draw) and retention stresses (G,) f32."""
    t_g = np.asarray([[getattr(pt.timing, p) for p in PARAMS]
                      for pt in points], np.float32)
    adders_dg = np.stack([condition_adders(batch, pt.temp_C, pt.refresh_ms)
                          for pt in points], axis=1).astype(np.float32)
    vc = batch.vdd_coef.cpu().numpy()
    shifts_dg = np.stack([access_vdd_shift(vc, pt.vdd) for pt in points],
                         axis=1)
    keys = []
    for pt in points:
        tq = 0
        for p in PARAMS:
            tq = (tq * 0x9E3779B9 + AXES[p].quantize(getattr(pt.timing, p))) \
                & 0xFFFFFFFF
        keys.append(op_point_key(tq, AXES["vdd"].quantize(pt.vdd),
                                 AXES["refresh"].quantize(pt.refresh_ms)))
    keys_g = np.asarray(keys, np.uint32)
    retx_g = np.asarray([retention_stress(pt.temp_C, pt.refresh_ms, pt.vdd)
                         for pt in points], np.float32)
    return t_g, adders_dg, shifts_dg, keys_g, retx_g


def _op_grid_impl(batch: DimmBatch, rows, stress, t_g, adders_dg, shifts_dg,
                  keys_g, retx_g, *, iters: int, multibit: bool,
                  banks: int = 1, retention: bool = True):
    """Every DIMM at every point of a static operating-point grid (a Python
    loop where the reference scans): ``(fails, lam)`` shaped (D, G, banks).
    Points are independent (no stop logic), so the loop carries no state."""
    D, S = batch.n_dimms, batch.geom.subarrays
    fails, lams = [], []
    for i in range(t_g.shape[0]):
        t_subs = t_g[i][None, None, :].expand(D, S, len(PARAMS))
        f, lam = _op_region_eval(batch, t_subs, rows, stress, adders_dg[:, i],
                                 shifts_dg[:, i], OP_GRID_LANE, int(keys_g[i]),
                                 iters, multibit, banks, retention, retx_g[i])
        fails.append(f)
        lams.append(lam)
    return torch.stack(fails, dim=1), torch.stack(lams, dim=1)


def operating_grid_arrays(batch: DimmBatch, points, *,
                          region="worst", patterns=DEFAULT_PATTERNS,
                          iters: int = DEFAULT_ITERS,
                          multibit_only: bool = False, banks: int = 1,
                          retention: bool = True,
                          mesh: DimmMesh | None = None) -> dict:
    """Every DIMM at every ``OperatingPoint`` in ``points`` — the batched
    N-axis (timing x voltage x temperature x refresh) evaluation.  Returns
    ``fails`` (D, G[, banks]) bool Monte-Carlo region outcomes and ``lam``
    (D, G[, banks]) f32 expected failure counts (access + retention
    channels), as numpy.  ``mesh`` shards the DIMM axis."""
    if batch.geom.subarrays % banks != 0:
        raise ValueError(f"banks={banks} must divide "
                         f"subarrays={batch.geom.subarrays}")
    dev = batch.device
    rows = torch.as_tensor(_resolve_rows(region, batch.geom, batch.n_dimms),
                           dtype=torch.int64, device=dev)
    t_g, adders_dg, shifts_dg, keys_g, retx_g = \
        operating_grid_tables(batch, points)
    as_t = lambda a: torch.as_tensor(a, device=dev)
    args = (batch, rows, as_t(pattern_stress(patterns)), as_t(t_g),
            as_t(adders_dg), as_t(shifts_dg), keys_g, as_t(retx_g))
    statics = dict(iters=iters, multibit=multibit_only, banks=banks,
                   retention=retention)
    argnums = (0, 1, 4, 5) if rows.dim() == 2 else (0, 4, 5)
    fails, lam = _dispatch(mesh, _op_grid_impl, args, statics, argnums)
    sq = (lambda a: a[..., 0]) if banks == 1 else (lambda a: a)
    return {"fails": sq(fails).cpu().numpy(), "lam": sq(lam).cpu().numpy()}


# --------------------------------------------------- full-grid batched API

def _pack_coeffs(batch: DimmBatch, pidx: int, t_op: float, stress: float,
                 adder, chip: int, sub_idx: int):
    """(D, 9) folded per-DIMM coefficient rows for the fail_prob kernel;
    ``adder`` is the host-computed (D,) operating-condition term."""
    base_eff = (batch.base[:, pidx] + adder + batch.chip_offsets[:, chip]
                + batch.sub_offsets[:, sub_idx])
    stress = float(stress)
    return torch.stack([
        base_eff, stress * batch.k_bl[:, pidx], stress * batch.k_wl[:, pidx],
        stress * batch.k_mat[:, pidx], stress * batch.k_row[:, pidx],
        torch.full_like(base_eff, float(np.float32(t_op))), batch.sigma,
        batch.outlier_rate, batch.outlier_ns,
    ], dim=1).to(torch.float32).contiguous()


def _pack_op_coeffs(batch: DimmBatch, pidx: int, t_op: float, stress: float,
                    adder, chip: int, sub_idx: int, shift, ret_x):
    """(D, 15) operating-point coefficient rows for the ``fail_prob_op``
    kernel: the 9 access coefficients of ``_pack_coeffs`` plus the
    host-computed (D,) voltage shift and the retention channel (ret_base,
    ret_k, the scalar retention stress ``ret_x``, ret_sigma, ret_drop)."""
    cf = _pack_coeffs(batch, pidx, t_op, stress, adder, chip, sub_idx)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=batch.device)
    extra = torch.stack([
        shift, batch.ret_base, batch.ret_k,
        torch.full_like(batch.ret_base, float(np.float32(ret_x))),
        batch.ret_sigma, batch.ret_drop,
    ], dim=1).to(torch.float32)
    return torch.cat([cf, extra], dim=1).contiguous()


def fail_prob_grids(batch: DimmBatch, param: str, t_op: float, *,
                    temp_C: float = 85.0, refresh_ms: float = 64.0,
                    pattern: str = "0101", chip: int = 0,
                    subarray: int = 0,
                    mesh: DimmMesh | None = None) -> torch.Tensor:
    """(D, mats, rows, cols) failure-probability grids for every DIMM, on the
    batch's device — one ``fail_prob`` call (one kernel launch on CUDA).
    ``mesh`` shards the DIMM axis (one launch a shard); the grids are then
    gathered on ``mesh.devices[0]``."""
    pidx = PARAMS.index(param)
    dev = batch.device
    adder = torch.as_tensor(condition_adders(batch, temp_C, refresh_ms),
                            device=dev)
    coeffs = _pack_coeffs(batch, pidx, t_op, PATTERN_STRESS[pattern], adder,
                          chip, subarray)
    d_mat = torch.as_tensor(_geom_consts(batch.geom)[1], device=dev)
    return _dispatch(mesh, fail_prob,
                     (batch.row_src[:, subarray].contiguous(), d_mat, coeffs),
                     dict(cols=batch.geom.cols_per_mat), (0, 2))


def _row_lambda_impl(batch: DimmBatch, stress, adder, *, pidx: int,
                     t_op: float, iters: int, internal: bool):
    """(D, subarrays*rows) expected error counts on the batch's device: one
    ``fail_prob_rows`` launch per (subarray, pattern), each over all DIMMs
    (the grid's row sums, without the grid); ``stress`` is the (P,) numpy
    pattern stresses, ``adder`` the (D,) condition term."""
    g = batch.geom
    dev = batch.device
    D, S, R = batch.n_dimms, g.subarrays, g.rows_per_mat
    d_mat = torch.as_tensor(_geom_consts(g)[1], device=dev)
    lam = []
    for s in range(S):
        row_src = batch.row_src[:, s].contiguous()
        exp_row = torch.zeros((D, R), dtype=torch.float32, device=dev)
        for stress_p in stress:
            coeffs = _pack_coeffs(batch, pidx, t_op, stress_p, adder, 0, s)
            rows = fail_prob_rows(row_src, d_mat, coeffs, cols=g.cols_per_mat)
            exp_row = exp_row + 2 * rows * g.chips
        lam.append(exp_row * iters)
    lam = torch.stack(lam, dim=1)                                # (D, S, R)
    if not internal:
        # counts are produced in internal order then scattered to external
        # addressing: ext_counts[j] = counts[ext_to_int[j]]
        idx = batch.ext_to_int.to(torch.int64)[:, None, :].expand(D, S, R)
        lam = torch.gather(lam, 2, idx)
    return lam.reshape(D, -1)


def row_error_lambda(batch: DimmBatch, param: str, t_op: float, *,
                     temp_C: float = 85.0, refresh_ms: float = 64.0,
                     patterns=DEFAULT_PATTERNS, iters: int = DEFAULT_ITERS,
                     internal_order: bool = False,
                     mesh: DimmMesh | None = None) -> np.ndarray:
    """(D, subarrays*rows) expected error counts per row address for every
    DIMM — the population-scale ``row_error_counts(sample=False)``.  One
    ``fail_prob_rows`` launch per (subarray, pattern), each over all DIMMs
    (over a shard's, once a shard, with ``mesh``)."""
    adder = torch.as_tensor(condition_adders(batch, temp_C, refresh_ms),
                            device=batch.device)
    statics = dict(pidx=PARAMS.index(param), t_op=t_op, iters=iters,
                   internal=internal_order)
    return _dispatch(mesh, _row_lambda_impl,
                     (batch, pattern_stress(patterns), adder), statics,
                     (0, 2)).cpu().numpy()


# ----------------------------------------------- batched DIVA Shuffling (Fig 17)

N_LANES = 9 * 64  # chips x burst bits, the SECDED burst of core/shuffling.py


def _shuffling_impl(probs, seeds, n_accesses: int):
    """The whole Fig 17 experiment on ``probs``' device: sample (D, n, 576)
    error lanes with the counter hash, lay the lanes out per codeword without
    and with DIVA Shuffling (two ``diva_shuffle`` launches), and score every
    codeword by its error weight and its syndrome (one ``secded_syndrome``
    launch over both layouts).  ``probs`` is (D, 9, 64) float32 and ``seeds``
    (D,) int64, both on one device.  Returns seven (D,) int64 counts."""
    D, dev = probs.shape[0], probs.device
    acc = torch.arange(n_accesses, device=dev)
    lane = torch.arange(N_LANES, device=dev)
    u = burst_uniform_t(seeds[:, None, None], acc[None, :, None],
                        lane[None, None, :])                     # (D, n, 576)
    errs = (u < probs.reshape(D, 1, N_LANES)).to(torch.int32)
    del u
    total = errs.sum(dim=(1, 2))
    flat = errs.reshape(D * n_accesses, N_LANES)
    # (beat, chip, dq) layout -> 8 codeword masks of 72 bits per access
    masks_ns = apply_shuffle(flat, shuffle=False)
    masks_s = apply_shuffle(flat, shuffle=True)
    del errs, flat
    both = torch.stack([masks_ns, masks_s]).reshape(2, D, n_accesses * 8, 72)
    del masks_ns, masks_s
    w = both.sum(dim=3)                                     # per-codeword weight
    syn = syndrome(both.reshape(-1, 72))
    detected = torch.any(syn.reshape(2, D, n_accesses * 8, 8) > 0, dim=3)
    corrected = (w == 1).sum(dim=2)                          # (2, D)
    uncorrectable = (w > 1).sum(dim=2)
    undetected = ((w > 1) & ~detected).sum(dim=2)            # silent corruption
    return (total, corrected[0], corrected[1], uncorrectable[0],
            uncorrectable[1], undetected[0], undetected[1])


def shuffling_gain_population(bit_error_prob, *, seeds=None, seed: int = 0,
                              n_accesses: int = 2000, device=None,
                              mesh: DimmMesh | None = None) -> dict:
    """Fig 17 at population scale: per-DIMM correctable-error fractions with
    and without DIVA Shuffling, for (D, 9, 64) burst-bit error profiles
    (numpy or a tensor; from ``burst_bit_profile_population`` or synthetic),
    on ``device`` (default: the CUDA device).

    ``seeds`` gives each DIMM its error-draw stream (default ``seed + i``;
    taken mod 2**32); on a singleton batch with the same seed this reproduces
    ``shuffling.shuffling_gain_loop`` count for count.  Beyond the loop's
    counts it reports uncorrectable and undetected (syndrome-aliased
    multi-bit) codewords per mode.  Counts return as int64 numpy arrays,
    fractions as float64.  ``mesh`` shards the DIMM axis (each DIMM's draws
    are keyed by its own seed); ``device`` is then ignored.
    """
    dev = mesh_device(mesh, device)
    probs = torch.as_tensor(bit_error_prob).to(dev, torch.float32)
    if probs.dim() == 2:
        probs = probs[None]
    if tuple(probs.shape[1:]) != (9, 64):
        raise ValueError(f"burst-bit profiles must be (D, 9, 64), got "
                         f"{tuple(probs.shape)}")
    D = probs.shape[0]
    if seeds is None:
        seeds = seed + np.arange(D)
    if not isinstance(seeds, torch.Tensor):
        seeds = torch.as_tensor(np.asarray(seeds).astype(np.int64))
    seeds = seeds.to(dev, torch.int64) & 0xFFFFFFFF
    if tuple(seeds.shape) != (D,):
        raise ValueError(f"seeds must be ({D},), got {tuple(seeds.shape)}")
    out = _dispatch(mesh, _shuffling_impl, (probs.contiguous(), seeds),
                    dict(n_accesses=n_accesses), (0, 1))
    total, c_ns, c_s, unc_ns, unc_s, und_ns, und_s = (
        v.cpu().numpy().astype(np.int64) for v in out)
    denom = np.maximum(total, 1)
    return {"total": total,
            "frac_no_shuffle": np.where(total == 0, 1.0, c_ns / denom),
            "frac_shuffle": np.where(total == 0, 1.0, c_s / denom),
            "gain": np.where(total == 0, 0.0, (c_s - c_ns) / denom),
            "uncorrectable_no_shuffle": unc_ns, "uncorrectable_shuffle": unc_s,
            "undetected_no_shuffle": und_ns, "undetected_shuffle": und_s}


def burst_bit_profile_population(batch: DimmBatch, param: str, t_op: float, *,
                                 temp_C: float = 85.0, refresh_ms: float = 64.0,
                                 pattern: str = "0101",
                                 subarray: int = 0,
                                 mesh: DimmMesh | None = None) -> np.ndarray:
    """(D, 9, 64) per-access error probability per burst-bit position — the
    population-scale Fig 12 profile feeding ``shuffling_gain_population`` —
    on the batch's device.

    Bit j of chip c reads mat ``burst_bit_to_mat(j)`` at the bit's column
    stride; its per-access error probability is the row-average failure
    probability at that (mat, col), from one ``fail_prob`` grid per data chip
    (``chips`` kernel launches).  Each grid is reduced on the device; only
    (D, 64) floats per chip cross to the host.  The ECC chip (row 8) gets the
    across-data-chip mean profile.  ``mesh`` shards the grids' DIMM axis;
    they are reduced after the gather, on ``mesh.devices[0]``.
    """
    g = batch.geom
    dev = batch.device if mesh is None else mesh.devices[0]
    bits = np.arange(g.burst_bits)
    mats = torch.as_tensor(burst_bit_to_mat(g, bits), device=dev)
    within = bits % g.bits_per_mat_in_burst
    cols = torch.as_tensor(
        within * (g.cols_per_mat // g.bits_per_mat_in_burst)
        + g.cols_per_mat // (2 * g.bits_per_mat_in_burst), device=dev)
    out = np.zeros((batch.n_dimms, 9, g.burst_bits), np.float32)
    for chip in range(g.chips):
        grids = fail_prob_grids(batch, param, t_op, temp_C=temp_C,
                                refresh_ms=refresh_ms, pattern=pattern,
                                chip=chip, subarray=subarray, mesh=mesh)
        out[:, chip, :] = grids.mean(dim=2)[:, mats, cols].cpu().numpy()
        del grids
    out[:, 8, :] = out[:, :g.chips, :].mean(axis=1)
    return out
