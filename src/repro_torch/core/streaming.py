"""Streaming population scans: fleet-scale characterization in fixed memory.

The counterpart of ``repro.core.streaming`` for the fleet error summary at an
operating point:

  * ``PopulationStream`` — a lazy population: total size plus a
    ``chunk(lo, hi) -> DimmBatch`` factory; ``from_batch`` wraps a resident
    batch (tensor views, no copies).
  * ``stream_population`` — the chunk loop: fixed-size chunks over the DIMM axis
    (``chunk_spans``), the ragged tail clone-padded to the one chunk width,
    each chunk's program run eagerly on the batch's device and its results
    folded through online reductions.
  * Online reductions — ``Sum``, ``Min``/``Max`` (with the attaining serial),
    ``Welford``, ``Collect`` and ``Passthrough`` (numpy, copied).
  * ``stream_error_summary`` — the (mats, rows, cols) failure-grid summary of
    the fleet, reduced on the device chunk by chunk; at a non-nominal supply
    or with the retention channel its grids come from the ``fail_prob_op``
    kernel, else from ``fail_prob``.

Per-DIMM outputs do not depend on the chunk size: per-DIMM computation is
independent along D and the counter-hash draws are keyed by serial.  Integer
cross-DIMM folds are exact; float ones are widened to float64 and hold to a
tolerance across chunk sizes.  Not ported yet (ROADMAP queue 1 #10): the
streamed profile, lifetime, shuffling, operating-grid, signature and
generation scans and the streamed SECDED scrub.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.geometry import DimmGeometry
from repro_torch.core.latency import (PATTERN_STRESS, access_vdd_shift,
                                      retention_stress)
from repro_torch.core.packing import pack_bool
from repro_torch.core.substrate import (_LEAVES, DimmBatch, _geom_consts,
                                        _pack_coeffs, _pack_op_coeffs,
                                        condition_adders)
from repro_torch.core.timing import PARAMS, VDD_STD
from repro_torch.kernels.fail_prob import fail_prob, fail_prob_op


def chunk_spans(n_dimms: int, chunk_size: int) -> list[tuple[int, int]]:
    """[lo, hi) population spans of a chunked scan: fixed-size chunks that
    tile [0, n_dimms) exactly, in serial order."""
    if n_dimms < 0 or chunk_size <= 0:
        raise ValueError(f"need n_dimms >= 0 < chunk_size; got "
                         f"({n_dimms}, {chunk_size})")
    return [(lo, min(lo + chunk_size, n_dimms))
            for lo in range(0, n_dimms, chunk_size)]


# ------------------------------------------------------------- the stream

def slice_batch(batch: DimmBatch, lo: int, hi: int) -> DimmBatch:
    """[lo, hi) population slice of a resident batch — tensor views, no copy."""
    return dataclasses.replace(
        batch, **{n: getattr(batch, n)[lo:hi] for n in _LEAVES})


def pad_batch(batch: DimmBatch, pad: int) -> DimmBatch:
    """Clone-pad the DIMM axis (repeat the last DIMM ``pad`` times).  The
    clone's serial travels with it, so its (discarded) draws are that DIMM's
    and every kept DIMM's draws are untouched."""
    if pad == 0:
        return batch

    def grow(a):
        return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])], dim=0)

    return dataclasses.replace(
        batch, **{n: grow(getattr(batch, n)) for n in _LEAVES})


@dataclass
class PopulationStream:
    """A population that is never resident: D plus a chunk factory.

    ``chunk_fn(lo, hi)`` must be a pure function of the global serial range —
    never of chunk position — so any chunk partition yields the same DIMMs."""
    n_dimms: int
    geom: DimmGeometry
    chunk_fn: Callable[[int, int], DimmBatch]

    @classmethod
    def from_batch(cls, batch: DimmBatch) -> "PopulationStream":
        return cls(batch.n_dimms, batch.geom,
                   lambda lo, hi: slice_batch(batch, lo, hi))

    def chunk(self, lo: int, hi: int) -> DimmBatch:
        if not 0 <= lo < hi <= self.n_dimms:
            raise ValueError(f"chunk [{lo}, {hi}) outside population "
                             f"[0, {self.n_dimms})")
        return self.chunk_fn(lo, hi)


def as_stream(source) -> PopulationStream:
    if isinstance(source, PopulationStream):
        return source
    if isinstance(source, DimmBatch):
        return PopulationStream.from_batch(source)
    raise TypeError(f"expected DimmBatch or PopulationStream, "
                    f"got {type(source).__name__}")


# ------------------------------------------------------- online reductions

class Reduction:
    """Folds per-chunk values; ``per_dimm`` declares a leading DIMM axis
    (``stream_population`` strips clone-padding and passes chunk
    serials)."""
    per_dimm = True

    def update(self, value: np.ndarray, serials: np.ndarray) -> None:
        raise NotImplementedError

    def result(self):
        raise NotImplementedError


class Sum(Reduction):
    """Sum over the DIMM axis: exact int64 for integer/bool chunks (adds
    commute — bit-invariant to chunk size and order), f64-widened for float
    chunks (tolerance-stable only)."""

    def __init__(self):
        self._acc: np.ndarray | None = None
        self._mode: str | None = None

    def update(self, value, serials) -> None:
        value = np.asarray(value)
        is_int = np.issubdtype(value.dtype, np.integer) \
            or value.dtype == np.bool_
        mode = "int" if is_int else "float"
        if self._mode is None:
            self._mode = mode
        elif self._mode != mode:
            raise TypeError("Sum fed mixed integer/float chunks")
        part = value.astype(np.int64 if is_int else np.float64).sum(axis=0)
        self._acc = part if self._acc is None else self._acc + part

    def result(self):
        return self._acc


class _Extreme(Reduction):
    """Elementwise min/max over the DIMM axis, tracking the serial that
    attains it (first-in-serial-order on ties — chunk-invariant because the
    scan walks serials in order)."""

    def __init__(self, op):
        self._op = op  # np.minimum or np.maximum
        self._pick = np.argmin if op is np.minimum else np.argmax
        self._val: np.ndarray | None = None
        self._serial: np.ndarray | None = None

    def update(self, value, serials) -> None:
        value = np.asarray(value)
        idx = self._pick(value, axis=0)
        cv = np.take_along_axis(value, idx[None], axis=0)[0]
        cs = np.asarray(serials)[idx]
        if self._val is None:
            self._val, self._serial = cv, cs
            return
        # strict comparison: on a tie the earlier (already-held) serial wins
        better = cv < self._val if self._op is np.minimum else cv > self._val
        self._val = np.where(better, cv, self._val)
        self._serial = np.where(better, cs, self._serial)

    def result(self):
        return {"value": self._val, "serial": self._serial}


class Min(_Extreme):
    def __init__(self):
        super().__init__(np.minimum)


class Max(_Extreme):
    def __init__(self):
        super().__init__(np.maximum)


class Welford(Reduction):
    """Streaming mean/variance over the DIMM axis (Chan parallel merge in
    f64).  Tolerance-stable — NOT bit-stable — across chunk sizes."""

    def __init__(self):
        self.n = 0
        self._mean: np.ndarray | None = None
        self._m2: np.ndarray | None = None

    def update(self, value, serials) -> None:
        value = np.asarray(value, np.float64)
        n_b = value.shape[0]
        mean_b = value.mean(axis=0)
        m2_b = ((value - mean_b) ** 2).sum(axis=0)
        if self._mean is None:
            self.n, self._mean, self._m2 = n_b, mean_b, m2_b
            return
        n = self.n + n_b
        delta = mean_b - self._mean
        self._mean = self._mean + delta * (n_b / n)
        self._m2 = self._m2 + m2_b + delta ** 2 * (self.n * n_b / n)
        self.n = n

    def result(self):
        var = self._m2 / self.n if self.n else self._m2
        return {"mean": self._mean, "var": var, "count": self.n}


class Collect(Reduction):
    """Materialize per-DIMM chunk outputs (the dense result).  Explicit
    opt-in: fine for parity tests and small fleets, defeats the point at
    scale — the streamed summaries are the fleet-scale product."""

    def __init__(self):
        self._parts: list[np.ndarray] = []

    def update(self, value, serials) -> None:
        self._parts.append(np.asarray(value))

    def result(self):
        return np.concatenate(self._parts, axis=0)


class Passthrough(Reduction):
    """For chunk outputs the device already reduced over the chunk's DIMMs
    (no leading DIMM axis): fold with elementwise addition (or a supplied
    merge).  Integer chunk aggregates fold exactly, float ones only to a
    tolerance."""
    per_dimm = False

    def __init__(self, merge=None):
        self._merge = merge if merge is not None else (lambda a, b: a + b)
        self._acc = None

    def update(self, value, serials) -> None:
        value = np.asarray(value)
        self._acc = value if self._acc is None \
            else self._merge(self._acc, value)

    def result(self):
        return self._acc


# ----------------------------------------------------------- the chunk loop

def stream_population(source, program, reducers: dict, *,
                      chunk_size: int = 1024) -> dict:
    """Run ``program`` over fixed-size population chunks, folding outputs
    through online reductions — no full-population result is ever resident.

    ``program(chunk_batch, keep, lo) -> dict[str, array]`` is called once per
    chunk with the clone-padded chunk (every chunk the same width) and a
    ``keep`` (chunk_size,) bool numpy mask that is False on padding —
    programs that reduce over the chunk's DIMM axis on the device must mask
    with it.  ``reducers`` maps output names to ``Reduction`` instances;
    per-DIMM outputs are pad-stripped before folding.

    Returns ``{name: reduction.result()}`` plus ``n_dimms`` / ``n_chunks`` /
    ``chunk_size``.
    """
    stream = as_stream(source)
    spans = chunk_spans(stream.n_dimms, chunk_size)
    full = chunk_size
    for lo, hi in spans:
        batch = stream.chunk(lo, hi)
        keep = np.arange(full) < (hi - lo)
        out = program(pad_batch(batch, full - (hi - lo)), keep, lo)
        serials = batch.serial.cpu().numpy()
        for name, red in reducers.items():
            value = np.asarray(out[name])
            if red.per_dimm:
                value = value[:hi - lo]
            red.update(value, serials)
    res = {name: red.result() for name, red in reducers.items()}
    res.update(n_dimms=stream.n_dimms, n_chunks=len(spans), chunk_size=full)
    return res


# --------------------------------------- streamed fail-grid fleet summary

def _error_summary_impl(row_src, d_mat, coeffs, keep, *, cols: int,
                        threshold: float, voltage: bool = False,
                        retention: bool = False) -> dict:
    """One chunk of the fleet fail-grid summary, reduced on the device: the
    (C, mats, rows, cols) grid exists only chunk-sized; what crosses to the
    host is per-DIMM scalars, the fleet cell-sum, exact per-cell hot counts
    and a per-DIMM row fail map.  ``keep`` masks clone-padding out of the
    cross-DIMM aggregates.  With ``voltage`` or ``retention`` the grids come
    from ``fail_prob_op`` (15-coefficient rows), else from ``fail_prob``."""
    if voltage or retention:
        grids = fail_prob_op(row_src, d_mat, coeffs, cols=cols,
                             voltage=voltage, retention=retention)
    else:
        grids = fail_prob(row_src, d_mat, coeffs, cols=cols)  # (C, M, R, cols)
    keep4 = keep[:, None, None, None]
    hot = grids > threshold
    out = {
        "lam_total": grids.sum(dim=(1, 2, 3)),                # (C,) per-DIMM
        "worst_cell": grids.amax(dim=(1, 2, 3)),              # (C,) per-DIMM
        "grid_sum": torch.where(keep4, grids, 0.0).sum(dim=0),
        "hot_cells": (hot & keep4).sum(dim=0, dtype=torch.int32),  # (M, R, cols)
        "row_fail": torch.any(torch.any(hot, dim=3), dim=1),  # (C, R) bool
    }
    del grids, hot
    return out


def stream_error_summary(source, param: str, t_op: float, *,
                         chunk_size: int = 2048, temp_C: float = 85.0,
                         refresh_ms: float = 64.0, vdd: float = VDD_STD,
                         retention: bool = False, pattern: str = "0101",
                         chip: int = 0, subarray: int = 0,
                         threshold: float = 0.5,
                         collect_fail_maps: bool = False) -> dict:
    """Fleet-scale failure-probability summary without materializing the
    (D, mats, rows, cols) grids, on the source batch's device.

    Per chunk, the grids are computed and reduced on the device; online
    reductions fold chunks into:

      * ``lam_stats`` / ``lam_min`` / ``lam_max`` — per-DIMM expected-failure
        mass (Welford, and extremes with the attaining serial);
      * ``worst_cell_max`` — the largest cell probability and its DIMM;
      * ``grid_sum`` — (mats, rows, cols) fleet cell-sum (float64): the
        population heatmap, Fig 7 at fleet scale;
      * ``hot_cells`` — (mats, rows, cols) exact count of DIMMs whose cell
        fails with p > ``threshold``;
      * ``fail_maps`` (opt-in) — per-chunk (DIMMs, R) row fail maps,
        bit-packed 8 cells per byte (``packing.pack_bool``), and with them
        ``lam_total``, the (D,) per-DIMM lambdas (``Collect``).

    A non-nominal ``vdd`` shifts the access channel and ``retention=True``
    adds the refresh/temperature retention channel (canonically at
    ``param="tras"``, the charge-restore knob); either routes the chunk
    program through the ``fail_prob_op`` kernel.  At the defaults it is the
    plain ``fail_prob`` program.
    """
    stream = as_stream(source)
    pidx = PARAMS.index(param)
    voltage = vdd != VDD_STD
    stress = np.float32(PATTERN_STRESS[pattern])
    statics = dict(cols=stream.geom.cols_per_mat, threshold=threshold,
                   voltage=voltage, retention=retention)
    ret_x = retention_stress(temp_C, refresh_ms, vdd)
    packed_maps: list = []
    d_mat_np = _geom_consts(stream.geom)[1]

    red = {"lam_stats": Welford(), "lam_min": Min(), "lam_max": Max(),
           "worst_cell_max": Max(), "grid_sum": Passthrough(),
           "hot_cells": Passthrough()}
    names = {"lam_stats": "lam_total", "lam_min": "lam_total",
             "lam_max": "lam_total", "worst_cell_max": "worst_cell",
             "grid_sum": "grid_sum", "hot_cells": "hot_cells",
             "lam_total": "lam_total"}
    if collect_fail_maps:
        red["lam_total"] = Collect()

    def program(batch, keep, lo):
        dev = batch.device
        adder = torch.as_tensor(condition_adders(batch, temp_C, refresh_ms),
                                device=dev)
        if voltage or retention:
            shift = access_vdd_shift(batch.vdd_coef.cpu().numpy(), vdd)
            coeffs = _pack_op_coeffs(batch, pidx, t_op, stress, adder, chip,
                                     subarray, shift, ret_x)
        else:
            coeffs = _pack_coeffs(batch, pidx, t_op, stress, adder, chip,
                                  subarray)
        out = _error_summary_impl(
            batch.row_src[:, subarray].contiguous(),
            torch.as_tensor(d_mat_np, device=dev), coeffs,
            torch.as_tensor(keep, device=dev), **statics)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        # fleet aggregates fold across many chunks: widen before the host add
        out["grid_sum"] = out["grid_sum"].astype(np.float64)
        out["hot_cells"] = out["hot_cells"].astype(np.int64)
        if collect_fail_maps:
            packed_maps.append(pack_bool(out["row_fail"][:int(keep.sum())]))
        return {name: out[names[name]] for name in red}

    out = stream_population(stream, program, red, chunk_size=chunk_size)
    if collect_fail_maps:
        out["fail_maps"] = packed_maps
    return out
