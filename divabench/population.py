"""The benchmark's inputs: DIMM populations as host leaves, made from a seed.

A frozen numpy copy of the port's population makers (its
``core/population.py`` and ``DimmModel``'s per-serial draws in
``core/errors.py``), kept here so that the benchmark makes its own inputs and
hands the same leaves to the program (through ``DimmBatch.from_arrays``) and
to the plain reference:

  * ``paper96_leaves`` — the paper's tested population (Appendix D): vendors
    A/B/C 30/30/36 over 11 vendor/die designs, each DIMM's process variation
    and row repairs drawn from its serial, as ``make_population`` builds it.
  * ``fleet_leaves`` — one chunk of the synthetic fleet, as
    ``synthetic_fleet``'s chunk factory builds it: the 11 designs cycled by
    serial, chip and subarray offsets drawn from the (fleet seed, serial)
    hash stream, no repairs.

Leaves are the 23 arrays of the port's ``DimmBatch`` (``LEAVES``), numpy,
with the DIMM axis first.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from divabench.model.geometry import DimmGeometry
from divabench.model.hashing import fleet_uniform
from divabench.model.latency import VendorModel, vendor_models
from divabench.model.timing import PARAMS

LEAVES = ("serial", "base", "k_bl", "k_wl", "k_mat", "k_row", "sigma",
          "temp_coef", "refresh_coef", "aging_coef", "age_years",
          "outlier_rate", "outlier_ns", "chip_offsets", "sub_offsets",
          "row_src", "int_to_ext", "ext_to_int",
          "vdd_coef", "ret_base", "ret_k", "ret_sigma", "ret_drop")
_SCALARS = ("sigma", "temp_coef", "refresh_coef", "aging_coef",
            "outlier_rate", "outlier_ns", "vdd_coef", "ret_base", "ret_k",
            "ret_sigma", "ret_drop")
_COEFFS = ("base", "k_bl", "k_wl", "k_mat", "k_row")

# die versions per vendor: (name, coefficient scale)
_DIES = {
    "A": [("A", 1.0), ("B", 1.1), ("C", 1.25), ("T", 1.6)],
    "B": [("D", 1.0), ("F", 0.18), ("K", 1.2), ("M", 0.15)],
    "C": [("D", 1.05), ("E", 1.15), ("F", 0.22)],
}
PAPER_COUNTS = {"A": 30, "B": 30, "C": 36}


def _die_variant(vm: VendorModel, die: str, scale: float, nbits: int,
                 seed: int) -> VendorModel:
    scaled = dataclasses.replace(
        vm,
        die=die,
        k_bl={k: v * scale for k, v in vm.k_bl.items()},
        k_wl={k: v * scale for k, v in vm.k_wl.items()},
        k_mat={k: v * scale for k, v in vm.k_mat.items()},
        sigma=vm.sigma * (0.8 + 0.4 * (seed % 3) / 2),
        ret_k=vm.ret_k * scale,
        ret_base=vm.ret_base * (0.9 + 0.05 * (seed % 5)),
        vdd_coef=vm.vdd_coef * (0.85 + 0.1 * (seed % 4)),
    )
    return scaled.with_scramble(nbits, seed)


def _design(base: dict, vendor: str, die: str, scale: float,
            nbits: int) -> VendorModel:
    return _die_variant(base[vendor], die, scale, nbits,
                        seed=zlib.crc32(f"{vendor}{die}".encode()) % 97)


def designs(geom: DimmGeometry) -> list[VendorModel]:
    """The 11 vendor/die designs, in the fleet's cycling order."""
    base = vendor_models(geom)
    nbits = int(np.log2(geom.rows_per_mat))
    return [_design(base, v, die, scale, nbits)
            for v, variants in _DIES.items() for die, scale in variants]


def _design_leaves(tmpl: list[VendorModel], ti: np.ndarray,
                   geom: DimmGeometry) -> dict:
    """The leaves a DIMM takes from its design: coefficient tables, scalars
    and the row scramble, for design indices ``ti``."""
    f32 = lambda v: np.asarray(v, np.float32)
    rows = np.arange(geom.rows_per_mat)
    out = {a: f32([[getattr(t, a)[p] for p in PARAMS] for t in tmpl])[ti]
           for a in _COEFFS}
    out.update({a: f32([getattr(t, a) for t in tmpl])[ti] for a in _SCALARS})
    out["int_to_ext"] = np.stack([np.asarray(t.scramble.int_to_ext(rows))
                                  for t in tmpl]).astype(np.int32)[ti]
    out["ext_to_int"] = np.stack([np.asarray(t.scramble.ext_to_int(rows))
                                  for t in tmpl]).astype(np.int32)[ti]
    return out


def paper96_leaves(geom: DimmGeometry, n: int = 96,
                   counts: dict = PAPER_COUNTS) -> dict:
    """Leaves of the paper's population of ``n`` DIMMs (serials 0..n-1):
    vendor blocks in A, B, C order, each cycling its dies; per DIMM the
    chip and subarray offsets and the row repairs drawn from
    ``default_rng(1000 + serial)``, as ``DimmModel`` draws them."""
    base = vendor_models(geom)
    nbits = int(np.log2(geom.rows_per_mat))
    S, R = geom.subarrays, geom.rows_per_mat
    tmpl, ti = [], []
    for vendor, cnt in counts.items():
        for i in range(round(cnt * n / 96)):
            die, scale = _DIES[vendor][i % len(_DIES[vendor])]
            tmpl.append(_design(base, vendor, die, scale, nbits))
            ti.append(len(tmpl) - 1)
    tmpl, ti = tmpl[:n], np.asarray(ti[:n])
    chip_off, sub_off, row_src = [], [], []
    rows = np.arange(R)
    for serial, vm in enumerate(tmpl):
        rng = np.random.default_rng(1000 + serial)
        chip_off.append(rng.normal(0.0, vm.chip_sigma, geom.chips))
        sub_off.append(rng.normal(0.0, vm.chip_sigma / 2, S))
        repaired = rng.random((S, R)) < vm.repair_rate
        perm = rng.integers(0, R, (S, R))
        row_src.append(np.where(repaired, perm, rows[None, :]))
    leaves = _design_leaves(tmpl, ti, geom)
    leaves.update(
        serial=np.arange(len(tmpl), dtype=np.int64),
        age_years=np.zeros(len(tmpl), np.float32),
        chip_offsets=np.asarray(chip_off, np.float32),
        sub_offsets=np.asarray(sub_off, np.float32),
        row_src=np.stack(row_src).astype(np.int32))
    return leaves


def fleet_leaves(geom: DimmGeometry, seed: int, lo: int, hi: int) -> dict:
    """Leaves of fleet serials [lo, hi): pure functions of (``seed``,
    serial), so any chunking of the fleet gives the same DIMMs.  ``seed`` is
    taken modulo 2**32 (the hash keys 32-bit words)."""
    tmpl = designs(geom)
    seed = int(seed) % (1 << 32)
    serials = np.arange(lo, hi, dtype=np.uint32)
    ti = (serials % len(tmpl)).astype(np.int64)
    C, R = hi - lo, geom.rows_per_mat
    chip_sig = np.asarray([t.chip_sigma for t in tmpl], np.float32)[ti]

    def normals(lane0: int, count: int) -> np.ndarray:
        """(C, count) standard normals: Box-Muller over two hash lanes."""
        lanes = lane0 + np.arange(count)[None, :]
        s = serials[:, None]
        u1 = fleet_uniform(seed, s, 2 * lanes)
        u2 = fleet_uniform(seed, s, 2 * lanes + 1)
        return np.sqrt(-2.0 * np.log1p(-u1.astype(np.float64))) \
            * np.cos(2.0 * np.pi * u2.astype(np.float64))

    leaves = _design_leaves(tmpl, ti, geom)
    leaves.update(
        serial=serials.astype(np.int64),
        age_years=np.zeros(C, np.float32),
        chip_offsets=(normals(0, geom.chips)
                      * chip_sig[:, None]).astype(np.float32),
        sub_offsets=(normals(geom.chips, geom.subarrays)
                     * (chip_sig / 2.0)[:, None]).astype(np.float32),
        row_src=np.ascontiguousarray(np.broadcast_to(
            np.arange(R, dtype=np.int32), (C, geom.subarrays, R))))
    return leaves


def take(leaves: dict, idx) -> dict:
    """The leaves of DIMMs ``idx`` (an index array or a slice)."""
    return {k: v[idx] for k, v in leaves.items()}


def fleet_pool(geom: DimmGeometry, seed: int, chunk: int,
               n_chunks: int) -> list[dict]:
    """The fleet's first ``n_chunks * chunk`` DIMMs as ``n_chunks`` host
    chunks of leaves, each contiguous in memory."""
    return [fleet_leaves(geom, seed, k * chunk, (k + 1) * chunk)
            for k in range(n_chunks)]
