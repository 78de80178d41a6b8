"""The simulated 96-DIMM population (Appendix D structure).

3 vendors (A: 30, B: 30, C: 36 DIMMs), multiple die versions per vendor with
scaled coefficients, per-DIMM process-variation seeds. DIMMs from the same
vendor+die share design-induced variation (same scramble, same coefficient
shape); absolute error counts differ via process noise — matching Sec 5.6.

A copy of ``repro.core.population``'s ``_die_variant`` and
``make_population`` (numpy); the streaming fleet is not ported yet.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.errors import DimmModel
from repro_torch.core.geometry import SMALL, DimmGeometry
from repro_torch.core.latency import VendorModel, vendor_models


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


def make_population(geom: DimmGeometry = SMALL, n: int = 96) -> list[DimmModel]:
    base = vendor_models(geom)
    nbits = int(np.log2(geom.rows_per_mat))
    counts = {"A": 30, "B": 30, "C": 36}
    # die versions per vendor: (name, coefficient scale) — visibility on the
    # 2.5 ns grid requires scale >~ 0.95 (below that, the whole variation
    # window sits between grid steps -> Fig 14's 24 "no observed variation"
    # DIMMs)
    dies = {
        "A": [("A", 1.0), ("B", 1.1), ("C", 1.25), ("T", 1.6)],
        "B": [("D", 1.0), ("F", 0.18), ("K", 1.2), ("M", 0.15)],
        "C": [("D", 1.05), ("E", 1.15), ("F", 0.22)],
    }
    dimms = []
    serial = 0
    for vendor, cnt in counts.items():
        cnt = round(cnt * n / 96)
        for i in range(cnt):
            die, scale = dies[vendor][i % len(dies[vendor])]
            vm = _die_variant(base[vendor], die, scale, nbits,
                              seed=zlib.crc32(f'{vendor}{die}'.encode()) % 97)
            dimms.append(DimmModel(geom, vm, serial=serial))
            serial += 1
    return dimms[:n]
