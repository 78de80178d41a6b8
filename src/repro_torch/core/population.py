"""The simulated 96-DIMM population (Appendix D structure).

3 vendors (A: 30, B: 30, C: 36 DIMMs), multiple die versions per vendor with
scaled coefficients, per-DIMM process-variation seeds. DIMMs from the same
vendor+die share design-induced variation (same scramble, same coefficient
shape); absolute error counts differ via process noise — matching Sec 5.6.

A copy of ``repro.core.population`` (numpy): ``_die_variant``,
``make_population``, and the streaming fleet — ``fleet_templates`` and
``synthetic_fleet``, whose leaves are built on the host exactly as in the
reference and reach the device through ``DimmBatch.from_arrays``.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.errors import DimmModel
from repro_torch.core.geometry import SMALL, DimmGeometry
from repro_torch.core.latency import VendorModel, vendor_models
from repro_torch.core.timing import PARAMS


def _die_variant(vm: VendorModel, die: str, scale: float, nbits: int, seed: int) -> VendorModel:
    scaled = dataclasses.replace(
        vm,
        die=die,
        k_bl={k: v * scale for k, v in vm.k_bl.items()},
        k_wl={k: v * scale for k, v in vm.k_wl.items()},
        k_mat={k: v * scale for k, v in vm.k_mat.items()},
        sigma=vm.sigma * (0.8 + 0.4 * (seed % 3) / 2),
        # design-scaled operating-point coefficients: stronger design
        # variation also means steeper retention erosion and voltage
        # sensitivity (deterministic per die, like the timing scales)
        ret_k=vm.ret_k * scale,
        ret_base=vm.ret_base * (0.9 + 0.05 * (seed % 5)),
        vdd_coef=vm.vdd_coef * (0.85 + 0.1 * (seed % 4)),
    )
    return scaled.with_scramble(nbits, seed)


# die versions per vendor: (name, coefficient scale) — visibility on the
# 2.5 ns grid requires scale >~ 0.95 (below that, the whole variation window
# sits between grid steps -> Fig 14's 24 "no observed variation" DIMMs)
_DIES = {
    "A": [("A", 1.0), ("B", 1.1), ("C", 1.25), ("T", 1.6)],
    "B": [("D", 1.0), ("F", 0.18), ("K", 1.2), ("M", 0.15)],
    "C": [("D", 1.05), ("E", 1.15), ("F", 0.22)],
}


def make_population(geom: DimmGeometry = SMALL, n: int = 96) -> list[DimmModel]:
    base = vendor_models(geom)
    nbits = int(np.log2(geom.rows_per_mat))
    counts = {"A": 30, "B": 30, "C": 36}
    dimms = []
    serial = 0
    for vendor, cnt in counts.items():
        cnt = round(cnt * n / 96)
        for i in range(cnt):
            die, scale = _DIES[vendor][i % len(_DIES[vendor])]
            vm = _die_variant(base[vendor], die, scale, nbits,
                              seed=zlib.crc32(f'{vendor}{die}'.encode()) % 97)
            dimms.append(DimmModel(geom, vm, serial=serial))
            serial += 1
    return dimms[:n]


# ------------------------------------------------- streaming synthetic fleet

def fleet_templates(geom: DimmGeometry) -> list[VendorModel]:
    """The 11 vendor+die designs of ``make_population`` as a flat template
    list — every design the 96-DIMM population samples, reused by the
    streaming fleet so generation inference has the same cluster structure
    to discover at any scale (same design => same scramble => same
    signature direction)."""
    base = vendor_models(geom)
    nbits = int(np.log2(geom.rows_per_mat))
    return [_die_variant(base[vendor], die, scale, nbits,
                         seed=zlib.crc32(f'{vendor}{die}'.encode()) % 97)
            for vendor, variants in _DIES.items()
            for die, scale in variants]


def synthetic_fleet(n: int, geom: DimmGeometry = SMALL, seed: int = 0,
                    device=None):
    """A ``PopulationStream`` of ``n`` synthetic DIMMs that is never
    resident, on ``device`` (default: the CUDA device): each chunk's
    ``DimmBatch`` leaves are pure functions of (fleet ``seed``, global
    serial) via ``hashing.fleet_uniform`` — never of chunk position — so
    any chunk partition of the fleet synthesizes identical DIMMs.

    Designs cycle through ``fleet_templates`` by serial; per-DIMM process
    variation (chip and subarray offsets) is Box-Muller normals drawn from
    the hash stream at the template's ``chip_sigma``, in float64 and then
    float32, as in the reference.  ``row_src`` is identity (a pristine
    fleet: no post-manufacturing repairs).  The leaves are built on the
    host and copied to the device chunk by chunk."""
    from repro_torch.core.hashing import fleet_uniform
    from repro_torch.core.streaming import PopulationStream
    from repro_torch.core.substrate import DimmBatch
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    tmpl = fleet_templates(geom)
    R = geom.rows_per_mat
    rows = np.arange(R)
    f32 = lambda v: np.asarray(v, np.float32)
    coeff = lambda attr: f32([[getattr(t, attr)[p] for p in PARAMS]
                              for t in tmpl])
    tab = {a: coeff(a) for a in ("base", "k_bl", "k_wl", "k_mat", "k_row")}
    scal = {a: f32([getattr(t, a) for t in tmpl])
            for a in ("sigma", "chip_sigma", "temp_coef", "refresh_coef",
                      "aging_coef", "outlier_rate", "outlier_ns",
                      "vdd_coef", "ret_base", "ret_k", "ret_sigma",
                      "ret_drop")}
    i2e = np.stack([np.asarray(t.scramble.int_to_ext(rows))
                    for t in tmpl]).astype(np.int32)
    e2i = np.stack([np.asarray(t.scramble.ext_to_int(rows))
                    for t in tmpl]).astype(np.int32)
    geom_fields = dataclasses.asdict(geom)

    def normals(serials, lane0: int, count: int) -> np.ndarray:
        """(C, count) standard normals: Box-Muller over two hash lanes per
        draw, keyed only by (seed, serial, lane)."""
        lanes = lane0 + np.arange(count)[None, :]
        s = serials[:, None]
        u1 = fleet_uniform(seed, s, 2 * lanes)
        u2 = fleet_uniform(seed, s, 2 * lanes + 1)
        # 1 - u1 maps [0,1) -> (0,1]: log never sees zero
        return np.sqrt(-2.0 * np.log1p(-u1.astype(np.float64))) \
            * np.cos(2.0 * np.pi * u2.astype(np.float64))

    def chunk_fn(lo: int, hi: int) -> DimmBatch:
        serials = np.arange(lo, hi, dtype=np.uint32)
        ti = (serials % len(tmpl)).astype(np.int64)
        C = hi - lo
        chip_sig = scal["chip_sigma"][ti]
        chip_off = normals(serials, 0, geom.chips) * chip_sig[:, None]
        sub_off = normals(serials, geom.chips, geom.subarrays) \
            * (chip_sig / 2.0)[:, None]
        leaves = dict(
            serial=serials.astype(np.int64),
            base=tab["base"][ti], k_bl=tab["k_bl"][ti], k_wl=tab["k_wl"][ti],
            k_mat=tab["k_mat"][ti], k_row=tab["k_row"][ti],
            age_years=np.zeros(C, np.float32),
            chip_offsets=chip_off.astype(np.float32),
            sub_offsets=sub_off.astype(np.float32),
            row_src=np.broadcast_to(rows.astype(np.int32),
                                    (C, geom.subarrays, R)),
            int_to_ext=i2e[ti], ext_to_int=e2i[ti],
            **{a: scal[a][ti] for a in (
                "sigma", "temp_coef", "refresh_coef", "aging_coef",
                "outlier_rate", "outlier_ns", "vdd_coef", "ret_base", "ret_k",
                "ret_sigma", "ret_drop")})
        return DimmBatch.from_arrays(geom_fields, leaves, dev)

    return PopulationStream(n_dimms=int(n), geom=geom, chunk_fn=chunk_fn,
                            device=dev)
