"""Streaming population scans: fleet-scale characterization in fixed memory.

The counterpart of ``repro.core.streaming``:

  * ``PopulationStream`` — a lazy population: total size plus a
    ``chunk(lo, hi) -> DimmBatch`` factory and the device its chunks land
    on; ``from_batch`` wraps a resident batch (tensor views, no copies),
    ``population.synthetic_fleet`` synthesizes a fleet chunk by chunk.
  * ``stream_population`` — the chunk loop: fixed-size chunks over the DIMM axis
    (``sharding.chunk_spans``), the ragged tail clone-padded to the one chunk
    width, each chunk's program run eagerly on the batch's device (or split
    over a ``mesh``) and its results folded through online reductions.
  * Online reductions — ``Sum``, ``Min``/``Max`` (with the attaining serial),
    ``Welford``, ``Collect`` and ``Passthrough`` (numpy, copied).
  * Streamed entry points, each a loop over the dense path's own chunk
    program: ``stream_profile_population``, ``stream_lifetime_population``,
    ``stream_shuffling_gain`` (``diva_shuffle`` + ``secded_syndrome``),
    ``stream_error_summary`` (the (mats, rows, cols) failure-grid summary,
    reduced on the device chunk by chunk; its grids come from the
    ``fail_prob_op`` kernel at a non-nominal supply or with the retention
    channel, else from ``fail_prob``), ``stream_operating_grid``,
    ``stream_bit_signature`` (``bit_signature``), ``stream_secded_scrub``
    (``secded_syndrome``), and the campaign counts ``hash_poisson_counts``
    (``fail_prob_rows``) behind ``stream_discover_generations``.

Per-DIMM outputs do not depend on the chunk size: per-DIMM computation is
independent along D and every draw is keyed by serial.  Integer
cross-DIMM folds are exact; float ones are widened to float64 and hold to a
tolerance across chunk sizes.  Each chunk call bumps
``repro_stream_chunks_total{entry}``.  While a trace is recorded,
``stream_population`` records each call as a ``stream.call`` span and each
chunk's stages under it: ``stream.lower`` (the chunk factory and the
padding), ``stream.prep`` (the host tables), ``stream.chunk`` (the chunk
program, waiting for its outputs at close), ``stream.readback`` (the
outputs to numpy) and ``stream.fold`` (the reductions), every one with
``chunk=(call span id, lo)``.
``mesh=`` (a ``sharding.DimmMesh``) shards each chunk over the DIMM axis:
the chunk size is rounded up to the mesh's size and each chunk runs through
``substrate._run_sharded``, which cannot change a per-DIMM integer or
decision, so the folded summaries do not depend on the mesh either (the
error summary's float cell-sum adds the shards' partials, to a tolerance).
The counter and the span count chunks, not shards.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core import ecc as _ecc
from repro_torch.core.geometry import DimmGeometry
from repro_torch.core.latency import (DEFAULT_ITERS, DEFAULT_PATTERNS,
                                      PATTERN_STRESS, access_vdd_shift,
                                      retention_stress)
from repro_torch.core.packing import narrow_counts, pack_bool
from repro_torch.core.substrate import (_LEAVES, DimmBatch, _axis_context,
                                        _dispatch, _gather, _geom_consts,
                                        _lifetime_impl, _op_grid_impl,
                                        _pack_coeffs, _pack_op_coeffs, _pad0,
                                        _profile_impl, _resolve_rows,
                                        _shard_outputs, _shuffling_impl,
                                        condition_adders, lifetime_adders,
                                        operating_grid_tables, pattern_stress,
                                        row_error_lambda)
from repro_torch.core.timing import PARAMS, VDD_STD
from repro_torch.device import resolve_device
from repro_torch.kernels.fail_prob import fail_prob, fail_prob_op
from repro_torch.kernels.secded import syndrome
from repro_torch.obs import REGISTRY as _OBS_REGISTRY
from repro_torch.obs import tracing as _obs_tracing
from repro_torch.sharding import DimmMesh, chunk_spans, mesh_device

# Chunk calls by entry point, counted at the HOST chunk boundary.  The stage
# spans are ``span_if_active`` sections: an idle tracer costs the loop one
# branch a stage.
_OBS_CHUNKS = _OBS_REGISTRY.counter(
    "repro_stream_chunks_total",
    "chunk programs dispatched by the streaming driver, by entry point",
    labelnames=("entry",))


# ------------------------------------------------------------- the stream

def slice_batch(batch: DimmBatch, lo: int, hi: int) -> DimmBatch:
    """[lo, hi) population slice of a resident batch — tensor views, no copy."""
    return dataclasses.replace(
        batch, **{n: getattr(batch, n)[lo:hi] for n in _LEAVES})


# clone-pad a chunk's DIMM axis (repeat its last DIMM): substrate._pad0
pad_batch = _pad0


@dataclass
class PopulationStream:
    """A population that is never resident: D plus a chunk factory.

    ``chunk_fn(lo, hi)`` must be a pure function of the global serial range —
    never of chunk position — so any chunk partition yields the same DIMMs.
    ``device`` is the device its chunks land on, where the factory states
    it (``from_batch`` and ``synthetic_fleet`` do)."""
    n_dimms: int
    geom: DimmGeometry
    chunk_fn: Callable[[int, int], DimmBatch]
    device: torch.device | None = None

    @classmethod
    def from_batch(cls, batch: DimmBatch) -> "PopulationStream":
        return cls(batch.n_dimms, batch.geom,
                   lambda lo, hi: slice_batch(batch, lo, hi), batch.device)

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

def _padded_width(chunk_size: int, mesh: DimmMesh | None) -> int:
    """The one chunk width: ``chunk_size`` rounded up to the mesh's size, as
    ``chunk_spans`` rounds it, so that every padded chunk splits evenly."""
    return chunk_size if mesh is None else chunk_size + (-chunk_size) % mesh.size


def stream_population(source, entry: str, prep, readback, reducers: dict,
                      *, chunk_size: int = 1024,
                      mesh: DimmMesh | None = None) -> dict:
    """Run a chunk program over fixed-size population chunks, folding its
    outputs through online reductions — no full-population result is ever
    resident.

    Per chunk: ``prep(chunk_batch, keep)`` builds the host tables and
    returns the chunk program's call ``(fn, args, statics, batch_argnums)``,
    which ``_chunk_call`` runs as ``entry``, split over ``mesh`` along the
    ``batch_argnums`` arguments (with none, ``fn`` takes the whole chunk
    and splits it itself); ``readback(out, keep) -> dict[str, array]``
    brings the outputs to the host by reducer name.  ``chunk_batch`` is the
    clone-padded chunk (every chunk the same width) and ``keep`` a
    (chunk_size,) bool numpy mask that is False on padding — programs that
    reduce over the chunk's DIMM axis on the device must mask with it.
    ``reducers`` maps output names to ``Reduction`` instances; per-DIMM
    outputs are pad-stripped before folding.  With a ``mesh`` the chunk
    width is rounded up to its size.  Each stage is a span while a trace is
    recorded (the module's docstring).

    Returns ``{name: reduction.result()}`` plus ``n_dimms`` / ``n_chunks`` /
    ``chunk_size``.
    """
    stream = as_stream(source)
    spans = chunk_spans(stream.n_dimms, chunk_size, mesh)
    full = _padded_width(chunk_size, mesh)
    stage = _obs_tracing.span_if_active
    with stage("stream.call", entry=entry, n_chunks=len(spans)) as call:
        for lo, hi in spans:
            chunk = (call.id, lo)
            with stage("stream.lower", chunk=chunk):
                batch = stream.chunk(lo, hi)
                keep = np.arange(full) < (hi - lo)
                padded = pad_batch(batch, full - (hi - lo))
            with stage("stream.prep", chunk=chunk):
                fn, args, statics, argnums = prep(padded, keep)
            out = _chunk_call(entry, fn, args, statics, argnums,
                              mesh if argnums else None, chunk=chunk)
            with stage("stream.readback", chunk=chunk):
                values = readback(out, keep)
            del padded, args, out     # the chunk's device buffers, not the fold's
            with stage("stream.fold", chunk=chunk):
                serials = batch.serial.cpu().numpy()
                for name, red in reducers.items():
                    value = np.asarray(values[name])
                    if red.per_dimm:
                        value = value[:hi - lo]
                    red.update(value, serials)
    res = {name: red.result() for name, red in reducers.items()}
    res.update(n_dimms=stream.n_dimms, n_chunks=len(spans), chunk_size=full)
    return res


def _chunk_call(name: str, fn, args: tuple, statics: dict,
                batch_argnums: tuple = (), mesh: DimmMesh | None = None,
                chunk: tuple | None = None):
    """One chunk's program, run eagerly (split over ``mesh`` by
    ``substrate._dispatch`` when one is given): a chunk counter always, and
    while a trace is recording a "stream.chunk" span (``entry=name``, and
    ``chunk`` where given) that waits for the chunk's device work at close;
    both once a chunk, whatever the mesh."""
    _OBS_CHUNKS.labels(entry=name).inc()
    extra = {} if chunk is None else {"chunk": chunk}
    with _obs_tracing.span_if_active("stream.chunk", entry=name,
                                     **extra) as sp:
        out = _dispatch(mesh, fn, args, statics, batch_argnums)
        sp.bind(out)
    return out


# ------------------------------------------------- streamed profiling sweep

def stream_profile_population(source, *, chunk_size: int = 1024,
                              region: str = "worst", temp_C: float = 55.0,
                              refresh_ms: float = 64.0,
                              vdd: float = VDD_STD, guard_cycles: int = 1,
                              multibit_only: bool = False,
                              patterns=DEFAULT_PATTERNS,
                              iters: int = DEFAULT_ITERS, banks: int = 1,
                              axes=PARAMS, retention: bool = False,
                              collect: bool = False,
                              mesh: DimmMesh | None = None) -> dict:
    """DIVA / conventional profiling of an arbitrarily large population in
    fixed memory, on the stream's device: the streamed
    ``profile_population_arrays``.

    Per-DIMM tables are identical to the dense path at any chunk size; the
    fleet summary is folded online — ``tables_min`` / ``tables_max``
    (elementwise over the population, with the attaining serial) and
    ``tables_stats`` (Welford mean/var).  ``collect=True`` also concatenates
    the per-DIMM (D, [banks,] len(axes)) tables.  ``axes`` / ``vdd`` /
    ``retention`` extend the sweep as in ``profile_population_arrays``; the
    per-axis context tables are rebuilt on the host per chunk.  ``mesh``
    shards each chunk over the DIMM axis.
    """
    stream = as_stream(source)
    if stream.geom.subarrays % banks != 0:
        raise ValueError(f"banks={banks} must divide "
                         f"subarrays={stream.geom.subarrays}")
    axes = tuple(axes)
    rows = _resolve_rows(region, stream.geom)
    if rows.ndim != 1:
        raise ValueError("stream_profile_population takes a shared (Rr,) "
                         "region; use the dense path for per-DIMM regions")
    statics = dict(guard_cycles=guard_cycles, iters=iters,
                   multibit=multibit_only, banks=banks, axes=axes,
                   retention=retention)

    red: dict[str, Reduction] = {}
    if collect:
        red["tables"] = Collect()
    red.update(tables_min=Min(), tables_max=Max(), tables_stats=Welford())

    def prep(batch, keep):
        dev = batch.device
        adder = torch.as_tensor(condition_adders(batch, temp_C, refresh_ms),
                                device=dev)
        ctx_d, ctx_g = _axis_context(batch, axes, temp_C=temp_C,
                                     refresh_ms=refresh_ms, vdd=vdd)
        args = (batch, torch.as_tensor(rows, dtype=torch.int64, device=dev),
                torch.as_tensor(pattern_stress(patterns), device=dev), adder)
        argnums = (0, 3)
        if ctx_d is not None:
            args, argnums = args + (ctx_d, ctx_g), (0, 3, 4)
        return _profile_impl, args, statics, argnums

    def readback(tables, keep):
        tables = tables.cpu().numpy()
        tables = tables if banks > 1 else tables[:, 0]
        return {name: tables for name in red}

    return stream_population(stream, "stream_profile", prep, readback, red,
                             chunk_size=chunk_size, mesh=mesh)


# ------------------------------------------------- streamed lifetime scan

def stream_lifetime_population(source, ages, temps, *,
                               chunk_size: int = 1024,
                               refresh_ms: float = 64.0,
                               region: str = "worst", guard_cycles: int = 1,
                               multibit: bool = True,
                               patterns=DEFAULT_PATTERNS,
                               iters: int = DEFAULT_ITERS,
                               diagnostics: bool = True, banks: int = 1,
                               collect: bool = False,
                               mesh: DimmMesh | None = None) -> dict:
    """The streamed ``lifetime_population``, on the stream's device: the
    online re-profiling lifecycle over an arbitrarily large fleet in fixed
    memory.

    ``ages`` / ``temps`` are per-epoch (E,) schedules shared by the fleet
    (per-DIMM (E, D) schedules are a dense-path feature).  Online summaries:
    per-epoch timing Welford stats + min/max-with-serial, exact per-epoch
    ``stale_count`` and float64-widened ``ecc_lambda_total``.
    ``collect=True`` also keeps per-DIMM trajectories (``timings``
    (D, E, [banks,] 4), ``stale_fail``, ``ecc_lambda`` — DIMM-leading; the
    dense path's epoch-leading arrays are one ``moveaxis`` away).  ``mesh``
    shards each chunk over the DIMM axis.
    """
    stream = as_stream(source)
    if stream.geom.subarrays % banks != 0:
        raise ValueError(f"banks={banks} must divide "
                         f"subarrays={stream.geom.subarrays}")
    ages = np.asarray(ages, np.float32)
    temps = np.asarray(temps, np.float64)
    if ages.ndim != 1 or temps.ndim != 1:
        raise ValueError("stream_lifetime_population takes shared (E,) "
                         "schedules; per-DIMM (E, D) schedules are dense-only")
    rows = _resolve_rows(region, stream.geom)
    statics = dict(guard_cycles=guard_cycles, iters=iters, multibit=multibit,
                   diagnostics=diagnostics, banks=banks)
    sq = (lambda a: a[:, :, 0]) if banks == 1 else (lambda a: a)

    red: dict[str, Reduction] = {"timings_stats": Welford(),
                                 "timings_min": Min(), "timings_max": Max()}
    names = {"timings_stats": "timings", "timings_min": "timings",
             "timings_max": "timings"}
    if diagnostics:
        red.update(stale_count=Sum(), ecc_lambda_total=Sum())
        names.update(stale_count="stale", ecc_lambda_total="ecc")
    if collect:
        red["timings"] = Collect()
        names["timings"] = "timings"
        if diagnostics:
            red.update(stale_fail=Collect(), ecc_lambda=Collect())
            names.update(stale_fail="stale", ecc_lambda="ecc")

    def prep(batch, keep):
        dev = batch.device
        adders = lifetime_adders(batch, ages, temps, refresh_ms)   # (E, C)
        return _lifetime_impl, (
            batch, torch.as_tensor(rows, dtype=torch.int64, device=dev),
            torch.as_tensor(pattern_stress(patterns), device=dev),
            torch.as_tensor(np.ascontiguousarray(adders.T), device=dev)
        ), statics, (0, 3)

    def readback(out, keep):
        out = [sq(v.cpu().numpy()) for v in out]
        vals = {"timings": out[0]}                     # (C, E, [banks,] 4)
        if diagnostics:
            vals["stale"], vals["ecc"] = out[1], out[2]   # (C, E[, banks])
        return {name: vals[names[name]] for name in red}

    out = stream_population(stream, "stream_lifetime", prep, readback, red,
                            chunk_size=chunk_size, mesh=mesh)
    out["ages"], out["temps"] = ages, temps
    return out


# ------------------------------------------------- streamed Fig 17 scoring

_SHUFFLING_KEYS = ("total", "corrected_no_shuffle", "corrected_shuffle",
                   "uncorrectable_no_shuffle", "uncorrectable_shuffle",
                   "undetected_no_shuffle", "undetected_shuffle")


def stream_shuffling_gain(probs_source, n_dimms: int | None = None, *,
                          chunk_size: int = 2048, seed: int = 0,
                          n_accesses: int = 2000, collect: bool = False,
                          device=None, mesh: DimmMesh | None = None) -> dict:
    """The streamed ``shuffling_gain_population``: Fig 17 ECC scoring over an
    arbitrarily large fleet of (9, 64) burst-bit error profiles, on
    ``device`` (default: the CUDA device) — per chunk two ``diva_shuffle``
    launches and one ``secded_syndrome``.

    ``probs_source`` is a (D, 9, 64) array or a ``(lo, hi) -> (C, 9, 64)``
    chunk factory (with ``n_dimms`` given).  Per-DIMM seeds are ``seed +
    global index`` — chunk-invariant by construction.  All seven codeword
    counters fold as exact int64 sums (``<key>_sum``), so the fleet
    correctable fractions are bit-invariant to chunking; ``collect=True``
    keeps the per-DIMM counters too.  ``mesh`` shards each chunk over the
    DIMM axis (``device`` is then ignored).
    """
    dev = mesh_device(mesh, device)
    if callable(probs_source):
        if n_dimms is None:
            raise ValueError("n_dimms is required with a chunk factory")
        probs_fn, D = probs_source, int(n_dimms)
    else:
        probs = np.asarray(probs_source, np.float32)
        if probs.ndim == 2:
            probs = probs[None]
        probs_fn, D = (lambda lo, hi: probs[lo:hi]), probs.shape[0]

    spans = chunk_spans(D, chunk_size, mesh)
    red: dict[str, Reduction] = {f"{k}_sum": Sum() for k in _SHUFFLING_KEYS}
    if collect:
        red.update({k: Collect() for k in _SHUFFLING_KEYS})
    for lo, hi in spans:
        chunk = np.asarray(probs_fn(lo, hi), np.float32)
        if chunk.shape != (hi - lo, 9, 64):
            raise ValueError(f"chunk factory returned {chunk.shape}, "
                             f"expected {(hi - lo, 9, 64)}")
        seeds = (seed + np.arange(lo, hi)).astype(np.uint32)
        out = _chunk_call(
            "stream_shuffling", _shuffling_impl,
            (torch.as_tensor(chunk, device=dev),
             torch.as_tensor(seeds.astype(np.int64), device=dev)),
            dict(n_accesses=n_accesses), (0, 1), mesh)
        for k, arr in zip(_SHUFFLING_KEYS, out):
            v = arr.cpu().numpy().astype(np.int64)
            red[f"{k}_sum"].update(v, seeds)
            if collect:
                red[k].update(v, seeds)
    res = {name: r.result() for name, r in red.items()}
    total = max(int(res["total_sum"]), 1)
    res["frac_no_shuffle"] = int(res["corrected_no_shuffle_sum"]) / total
    res["frac_shuffle"] = int(res["corrected_shuffle_sum"]) / total
    res["gain"] = (int(res["corrected_shuffle_sum"])
                   - int(res["corrected_no_shuffle_sum"])) / total
    res.update(n_dimms=D, n_chunks=len(spans),
               chunk_size=_padded_width(int(chunk_size), mesh))
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


def _error_summary_sharded(row_src, d_mat, coeffs, keep, *,
                           mesh: DimmMesh, **statics) -> dict:
    """The error-summary chunk program split over ``mesh``: the per-DIMM
    outputs (``lam_total``, ``worst_cell``, ``row_fail``) are gathered; the
    fleet aggregates are each shard's partials, masked by the shard's own
    slice of ``keep`` (clone padding is dropped: ``keep`` pads with False),
    and added in mesh order on ``mesh.devices[0]`` — ``grid_sum`` in
    float32 as the reference's ``psum`` adds, ``hot_cells`` in int32."""
    D = row_src.shape[0]
    pad = (-D) % mesh.size
    row_src, coeffs = _pad0(row_src, pad), _pad0(coeffs, pad)
    keep = torch.cat([keep, keep.new_zeros(pad)])
    parts, _ = _shard_outputs(mesh, _error_summary_impl,
                              (row_src, d_mat, coeffs, keep), statics,
                              (0, 2, 3))
    dev = mesh.devices[0]
    out = {k: _gather([p[k] for p in parts], dev, D)
           for k in ("lam_total", "worst_cell", "row_fail")}
    for k in ("grid_sum", "hot_cells"):
        acc = parts[0][k].to(dev)
        for p in parts[1:]:
            acc = acc + p[k].to(dev)
        out[k] = acc
    return out


def stream_error_summary(source, param: str, t_op: float, *,
                         chunk_size: int = 2048, temp_C: float = 85.0,
                         refresh_ms: float = 64.0, vdd: float = VDD_STD,
                         retention: bool = False, pattern: str = "0101",
                         chip: int = 0, subarray: int = 0,
                         threshold: float = 0.5,
                         collect_fail_maps: bool = False,
                         mesh: DimmMesh | None = None) -> dict:
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
    plain ``fail_prob`` program.  ``mesh`` shards each chunk over the DIMM
    axis (``_error_summary_sharded``): ``hot_cells``, the fail maps and the
    extremes' serials are those of the unsharded scan; ``grid_sum`` adds the
    shards' float32 partials in another order, and on a card a DIMM's
    lambda may sum its cells in another order on a narrower shard.
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

    def prep(batch, keep):
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
        impl, kw = (_error_summary_impl, statics) if mesh is None \
            else (_error_summary_sharded, dict(statics, mesh=mesh))
        # no batch_argnums: the sharded program splits the chunk itself
        return impl, (batch.row_src[:, subarray].contiguous(),
                      torch.as_tensor(d_mat_np, device=dev), coeffs,
                      torch.as_tensor(keep, device=dev)), kw, ()

    def readback(out, keep):
        out = {k: v.cpu().numpy() for k, v in out.items()}
        # fleet aggregates fold across many chunks: widen before the host add
        out["grid_sum"] = out["grid_sum"].astype(np.float64)
        out["hot_cells"] = out["hot_cells"].astype(np.int64)
        if collect_fail_maps:
            packed_maps.append(pack_bool(out["row_fail"][:int(keep.sum())]))
        return {name: out[names[name]] for name in red}

    out = stream_population(stream, "stream_error_summary", prep, readback,
                            red, chunk_size=chunk_size, mesh=mesh)
    if collect_fail_maps:
        out["fail_maps"] = packed_maps
    return out


# --------------------------------------- streamed N-axis operating grid

def stream_operating_grid(source, points, *, chunk_size: int = 1024,
                          region: str = "worst", patterns=DEFAULT_PATTERNS,
                          iters: int = DEFAULT_ITERS,
                          multibit_only: bool = False, banks: int = 1,
                          retention: bool = True,
                          collect: bool = False,
                          mesh: DimmMesh | None = None) -> dict:
    """The streamed ``operating_grid_arrays``, on the stream's device: every
    DIMM of an arbitrarily large fleet evaluated at every ``OperatingPoint``
    in ``points``, the (D, G) result grid never resident.

    Per chunk, the host tables (per-DIMM condition adders and voltage
    shifts) are rebuilt from the chunk's leaves.  Folded summaries, all
    (G[, banks])-shaped: ``fail_count`` (exact int64 count of DIMMs whose
    region trips at each point), ``fail_stats`` (Welford over the 0/1
    outcomes), ``lam_stats`` / ``lam_max`` (expected-failure-mass moments
    and the worst DIMM per point, with its serial).  ``collect=True`` also
    keeps the per-DIMM (D, G[, banks]) ``fails`` / ``lam``.  Per-DIMM
    decisions are identical to the dense path at any chunk size and on any
    ``mesh``, which shards each chunk over the DIMM axis.
    """
    stream = as_stream(source)
    if stream.geom.subarrays % banks != 0:
        raise ValueError(f"banks={banks} must divide "
                         f"subarrays={stream.geom.subarrays}")
    points = list(points)
    rows = _resolve_rows(region, stream.geom)
    if rows.ndim != 1:
        raise ValueError("stream_operating_grid takes a shared (Rr,) "
                         "region; use the dense path for per-DIMM regions")
    statics = dict(iters=iters, multibit=multibit_only, banks=banks,
                   retention=retention)
    sq = (lambda a: a[..., 0]) if banks == 1 else (lambda a: a)

    red: dict[str, Reduction] = {"fail_count": Sum(), "fail_stats": Welford(),
                                 "lam_stats": Welford(), "lam_max": Max()}
    names = {"fail_count": "fails", "fail_stats": "fails",
             "lam_stats": "lam", "lam_max": "lam"}
    if collect:
        red.update(fails=Collect(), lam=Collect())
        names.update(fails="fails", lam="lam")

    def prep(batch, keep):
        dev = batch.device
        as_t = lambda a: torch.as_tensor(a, device=dev)
        t_g, adders_dg, shifts_dg, keys_g, retx_g = \
            operating_grid_tables(batch, points)
        return _op_grid_impl, (
            batch, torch.as_tensor(rows, dtype=torch.int64, device=dev),
            as_t(pattern_stress(patterns)), as_t(t_g), as_t(adders_dg),
            as_t(shifts_dg), keys_g, as_t(retx_g)), statics, (0, 4, 5)

    def readback(out, keep):
        fails, lam = out
        vals = {"fails": sq(fails.cpu().numpy()),
                "lam": sq(lam.cpu().numpy())}
        return {name: vals[names[name]] for name in red}

    out = stream_population(stream, "stream_op_grid", prep, readback, red,
                            chunk_size=chunk_size, mesh=mesh)
    out["points"] = points
    return out


# ------------------------------------- streamed signatures + generations

def stream_bit_signature(counts_fn, n_dimms: int, *, chunk_size: int = 4096,
                         device=None,
                         mesh: DimmMesh | None = None) -> np.ndarray:
    """Streamed ``bit_signature_population``: (D, S, nbits) signatures from a
    ``(lo, hi) -> (C, S, R)`` integer-count chunk factory, on ``device``
    (default: the CUDA device; one ``bit_signature`` launch a chunk, or a
    shard with ``mesh``).  Signatures are a pure per-DIMM map (exact integer
    kernel + one power-of-two divide), so the concatenated result is
    identical to the dense call at any chunk size and on any mesh."""
    from repro_torch.discovery.signatures import bit_signature_population
    dev = mesh_device(mesh, device)
    parts = [_chunk_call("stream_bit_signature", bit_signature_population,
                         (np.asarray(counts_fn(lo, hi)),),
                         dict(device=dev, mesh=mesh))
             for lo, hi in chunk_spans(n_dimms, chunk_size, mesh)]
    return np.concatenate(parts, axis=0) if parts \
        else np.zeros((0, 0, 0), np.float32)


# ------------------------------------------------- streamed SECDED scrub

def _scrub_impl(code, *, in_place: bool):
    """One scrub chunk: syndrome (the ``secded_syndrome`` kernel on a card)
    -> single-bit correction.  Returns (fixed (C, 72) int32, status (C,)
    int32); with ``in_place`` the corrected words overwrite ``code``'s own
    buffer, which is returned as ``fixed``."""
    fixed, status = _ecc.correct_codewords(code, syndrome(code))
    if in_place:
        code.copy_(fixed)
        fixed = code
    return fixed, status


def stream_secded_scrub(source, n_words: int | None = None, *,
                        chunk_size: int = 262_144, collect: bool = False,
                        donate: bool = True, device=None) -> dict:
    """Streamed controller-side ECC scrub on ``device`` (default: the CUDA
    device): SECDED(72,64) syndrome + single-bit correction over a stream of
    codewords in fixed memory — the paper's DIVA-Shuffling ECC path at
    checkpoint-scrubbing scale.

    ``source`` is a (N, 72) 0/1 array, or a ``(lo, hi) -> (hi-lo, 72)``
    chunk factory (then ``n_words`` is required and no full array is ever
    resident).  With ``donate`` (the reference's buffer donation turned into
    reuse) every chunk is copied into one device buffer of ``chunk_size``
    words and corrected there in place; without it each chunk gets buffers
    of its own.  Counts and collected words are exact at any chunk size.

    Returns clean/corrected/uncorrectable counts (+ ``codewords`` (N, 72)
    when ``collect``) and ``donated``.
    """
    dev = resolve_device(device)
    if callable(source):
        if n_words is None:
            raise ValueError("n_words is required with a chunk factory")
        fetch = source
    else:
        arr = np.asarray(source)
        n_words = arr.shape[0]
        fetch = lambda lo, hi: arr[lo:hi]
    spans = chunk_spans(n_words, chunk_size)
    buf = torch.empty((min(chunk_size, n_words), _ecc.CODE_BITS),
                      dtype=torch.int32, device=dev) if donate else None
    counts = np.zeros(3, np.int64)
    collected: list[np.ndarray] = []
    for lo, hi in spans:
        chunk = np.asarray(fetch(lo, hi), np.int32)
        m = hi - lo
        if chunk.shape != (m, _ecc.CODE_BITS):
            raise ValueError(f"scrub chunk [{lo}:{hi}) has shape "
                             f"{chunk.shape}, want ({m}, {_ecc.CODE_BITS})")
        if donate:
            code = buf[:m]
            code.copy_(torch.from_numpy(np.ascontiguousarray(chunk)))
        else:
            code = torch.as_tensor(chunk, device=dev)
        fixed, status = _chunk_call("secded_scrub", _scrub_impl, (code,),
                                    dict(in_place=donate))
        counts += np.bincount(status.cpu().numpy(), minlength=3)[:3]
        if collect:   # a copy: a CPU buffer is reused by the next chunk
            collected.append(fixed.cpu().numpy().copy())
        del fixed, code
    res = {"n_words": int(n_words), "n_chunks": len(spans),
           "chunk_size": int(chunk_size),
           "clean": int(counts[0]), "corrected": int(counts[1]),
           "uncorrectable": int(counts[2]), "donated": bool(donate)}
    if collect:
        res["codewords"] = (np.concatenate(collected) if collected
                            else np.zeros((0, _ecc.CODE_BITS), np.int32))
    return res


# --------------------------------------------- campaigns and generations

def _campaign_impl(batch: DimmBatch, param: str, t_op: float, *,
                   temp_C: float, refresh_ms: float, patterns, iters: int,
                   seed: int, mesh: DimmMesh | None) -> np.ndarray:
    """(C, S, R) int64 counts: the row lambdas in external order (one
    ``fail_prob_rows`` launch per (subarray, pattern) on a card, split over
    ``mesh``), then one numpy Poisson generator per DIMM keyed by (seed,
    serial)."""
    g = batch.geom
    C, S, R = batch.n_dimms, g.subarrays, g.rows_per_mat
    lam = row_error_lambda(batch, param, t_op, temp_C=temp_C,
                           refresh_ms=refresh_ms, patterns=patterns,
                           iters=iters, internal_order=False, mesh=mesh
                           ).reshape(C, S, R)
    counts = np.empty((C, S, R), np.int64)
    for d, serial in enumerate(batch.serial.cpu().numpy()):
        counts[d] = np.random.default_rng([seed, int(serial)]).poisson(lam[d])
    return counts


def hash_poisson_counts(batch: DimmBatch, param: str, t_op: float, *,
                        temp_C: float = 85.0, refresh_ms: float = 64.0,
                        patterns=DEFAULT_PATTERNS, iters: int = DEFAULT_ITERS,
                        seed: int = 0,
                        mesh: DimmMesh | None = None) -> np.ndarray:
    """Synthetic observed campaign counts for a (chunk) batch, on the batch's
    device: the row-lambda sweep (``row_error_lambda``, external order),
    then per-DIMM Poisson draws keyed by the DIMM's SERIAL — never its batch
    position — so a chunked campaign draws the same counts at any chunk
    size.  Returns (C, S, R) int64 external-order counts.

    The draws come from ``np.random.default_rng([seed, serial])`` on the
    host: exact and independent of the device, but not ``repro``'s bits
    (``jax.random.poisson`` under ``fold_in(PRNGKey(seed), serial)``, which
    torch cannot reproduce).  Parity runs feed the reference's counts in
    through the ``counts_fn`` hooks.  ``mesh`` shards the row-lambda sweep
    (the draws stay keyed by serial on the host)."""
    return _chunk_call("stream_campaign", _campaign_impl,
                       (batch, param, float(t_op)),
                       dict(temp_C=temp_C, refresh_ms=refresh_ms,
                            patterns=patterns, iters=iters, seed=seed,
                            mesh=mesh))


def stream_discover_generations(source, *, counts_fn=None, param: str = "trp",
                                t_op: float = 7.5, temp_C: float = 85.0,
                                refresh_ms: float = 256.0,
                                chunk_size: int = 4096,
                                threshold: float = 0.85, k_rows: int = 2,
                                campaign_seed: int = 0,
                                collect_labels: bool = True,
                                mesh: DimmMesh | None = None) -> dict:
    """Generation inference as chunks flow through, on the stream's device:
    the streamed sibling of the blind-discovery clustering stage, built on
    ``generation.StreamingGenerations``.

    Per chunk: observed counts (``counts_fn(chunk_batch)``, default the
    serial-keyed ``hash_poisson_counts`` campaign) are dtype-narrowed
    (``packing.narrow_counts``), signatures run through the
    ``bit_signature`` kernel, features update the running clusterer, and
    the chunk's counts fold into its generation's exact canonical sums.  At
    finalize: per-DIMM labels (identical to the dense greedy clusterer),
    mean canonical profiles (exact: integer sums / profile count) and the
    discovered vulnerable rows per generation.  ``mesh`` shards the
    campaign's row lambdas and the signatures over the DIMM axis; the chunk
    size is rounded up to its size.
    """
    from repro_torch.discovery.generation import StreamingGenerations
    from repro_torch.discovery.signatures import (bit_signature_population,
                                                  signature_features)
    stream = as_stream(source)
    if counts_fn is None:
        counts_fn = lambda b: hash_poisson_counts(
            b, param, t_op, temp_C=temp_C, refresh_ms=refresh_ms,
            seed=campaign_seed, mesh=mesh)

    gens = StreamingGenerations(threshold=threshold)
    labels_parts: list[np.ndarray] = []
    serial_parts: list[np.ndarray] = []
    spans = chunk_spans(stream.n_dimms, chunk_size, mesh)
    for lo, hi in spans:
        batch = stream.chunk(lo, hi)
        counts = narrow_counts(np.asarray(counts_fn(batch)))
        sigs = bit_signature_population(counts.astype(np.int32),
                                        device=batch.device, mesh=mesh)
        labels = gens.update(signature_features(sigs), counts)
        if collect_labels:
            labels_parts.append(labels)
            serial_parts.append(batch.serial.cpu().numpy())
    out = gens.finalize(k_rows=k_rows)
    if collect_labels:
        out["labels"] = gens.resolve_labels(
            np.concatenate(labels_parts) if labels_parts
            else np.zeros(0, np.int64))
        out["serials"] = np.concatenate(serial_parts) if serial_parts \
            else np.zeros(0, np.int64)
    out.update(n_dimms=stream.n_dimms, n_chunks=len(spans),
               chunk_size=_padded_width(int(chunk_size), mesh))
    return out
