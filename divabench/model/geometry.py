"""DRAM organization model: DIMM -> chips -> banks -> subarrays -> 512x512 mats.

A frozen copy of the port's ``core/geometry.py``, kept with the benchmark:
its inputs and its plain reference import nothing of the program.

Coordinates (Section 2/3 of the paper):
  * bitline direction: a column of cells in a mat shares a bitline; in the
    open-bitline scheme even columns sense at the bottom sense-amp row,
    odd columns at the top (Fig 3b), so a cell's bitline distance depends on
    (row, col parity).
  * wordline direction: all cells of a row in a mat share a local wordline
    driven from the left edge; mats are chained along the global wordline,
    and the precharge control signal reaches mats per Fig 9 (main signal
    left->right with per-mat delay alpha, sub signal arrives right with delay
    beta then propagates right->left; sense amps use the earlier one).
  * row interface: DRAM-external row addresses are scrambled; we model vendor
    scrambling as a bit permutation + XOR mask on the in-subarray row bits
    (Section 5.3 reverse-engineers exactly this structure).
  * column interface: one column command moves a 64-bit burst per chip whose
    bits come from different mats (Fig 5), so burst-bit position maps to mat
    position — the lever DIVA Shuffling uses.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DimmGeometry:
    rows_per_mat: int = 512
    cols_per_mat: int = 512
    mats_x: int = 16          # mats chained along a global wordline (subarray width)
    subarrays: int = 8        # subarrays stacked per bank
    banks: int = 1
    chips: int = 8            # data chips (the ECC chip is the 9th, modeled in ecc.py)
    burst_bits: int = 64      # bits per chip per column command
    open_bitline: bool = True

    @property
    def rows_per_bank(self) -> int:
        return self.rows_per_mat * self.subarrays

    @property
    def rows_total(self) -> int:
        return self.rows_per_bank * self.banks

    @property
    def cells_per_chip(self) -> int:
        return self.rows_total * self.cols_per_mat * self.mats_x

    @property
    def bits_per_mat_in_burst(self) -> int:
        return max(1, self.burst_bits // self.mats_x)


TINY = DimmGeometry(rows_per_mat=64, cols_per_mat=64, mats_x=4, subarrays=2)
SMALL = DimmGeometry(rows_per_mat=128, cols_per_mat=128, mats_x=8, subarrays=4)
FULL = DimmGeometry()  # 512x512x16x8 = 33.5M cells/chip-bank: the benchmark size


# ------------------------------------------------------------ row scrambling

@dataclass(frozen=True)
class RowScramble:
    """External->internal row mapping inside a subarray: permute the low row
    bits then XOR a mask (van de Goor & Schanstra-style address scrambling)."""
    perm: tuple[int, ...]  # permutation of bit indices (len = log2 rows_per_mat)
    xor_mask: int

    def n_bits(self) -> int:
        return len(self.perm)

    def ext_to_int(self, ext_rows: np.ndarray) -> np.ndarray:
        """Vectorized: external in-subarray row -> internal (distance-ordered) row."""
        ext_rows = np.asarray(ext_rows)
        out = np.zeros_like(ext_rows)
        for i, p in enumerate(self.perm):
            out |= ((ext_rows >> p) & 1) << i
        return out ^ self.xor_mask

    def int_to_ext(self, int_rows: np.ndarray) -> np.ndarray:
        int_rows = np.asarray(int_rows) ^ self.xor_mask
        out = np.zeros_like(int_rows)
        for i, p in enumerate(self.perm):
            out |= ((int_rows >> i) & 1) << p
        return out


def vendor_scramble(vendor: str, n_bits: int, seed: int = 0) -> RowScramble:
    """Deterministic per-vendor scrambling (same design => same scramble,
    Section 5.3's 'similar in DRAMs with the same design'). Uses crc32, not
    hash(): python string hashing is randomized per process."""
    import zlib
    rng = np.random.default_rng(zlib.crc32(f"{vendor}-scramble-{seed}".encode()))
    perm = tuple(int(x) for x in rng.permutation(n_bits))
    mask = int(rng.integers(0, 2 ** n_bits))
    return RowScramble(perm, mask)


# ------------------------------------------------------------ cell coordinates

def bitline_distance(geom: DimmGeometry, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Normalized distance [0,1] from a cell to its sense amplifier."""
    R = geom.rows_per_mat
    if not geom.open_bitline:
        return rows / (R - 1)
    even = (cols % 2) == 0
    return np.where(even, rows, (R - 1) - rows) / (R - 1)


def wordline_distance(geom: DimmGeometry, cols: np.ndarray) -> np.ndarray:
    """Normalized distance [0,1] from a cell to its local wordline driver."""
    return cols / (geom.cols_per_mat - 1)


def precharge_delay(geom: DimmGeometry, mat_x: np.ndarray,
                    alpha: float = 1.0, beta: float = 2.0) -> np.ndarray:
    """Fig 9: per-mat precharge-control arrival, normalized to [0,1].

    main signal: alpha * (mat_x + 1); sub signal: beta + alpha * (mats-1-mat_x).
    Sense amps respond to the earlier one; the worst mat sits where the two
    meet (around 2/3 across for beta=2*alpha), producing the column-direction
    jumps of Figs 8b-8d.
    """
    main = alpha * (np.asarray(mat_x) + 1.0)
    sub = beta + alpha * (geom.mats_x - 1.0 - mat_x)
    d = np.minimum(main, sub)
    return d / d.max() if np.size(d) > 1 else d / (alpha * geom.mats_x)


def burst_bit_to_mat(geom: DimmGeometry, bit: np.ndarray) -> np.ndarray:
    """Which mat (x position) a burst-bit position reads from (Fig 5)."""
    return np.asarray(bit) // geom.bits_per_mat_in_burst
