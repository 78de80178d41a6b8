"""Packed error-count grids for the streaming population substrate (a copy of
``repro.core.packing``).

The dense population paths carry error counts as int64 / float32 tensors with
a leading DIMM axis — fine for tens of DIMMs, ruinous for a fleet.  This
module provides the *exact* compressed representations the streaming scans
(``core/streaming.py``) move between chunks:

  * ``narrow_counts`` — checked dtype narrowing: a nonnegative integer count
    grid is stored in the smallest unsigned dtype that holds its maximum
    (uint8 for campaign counts under 256, int64 only when genuinely needed).
    Narrowing is value-checked, so parity is guaranteed by construction: the
    packed grid unpacks to the original bits or ``narrow_counts`` refuses to
    narrow (it widens instead — never saturates, never clips).
  * ``CountAccumulator`` — dtype-widening accumulate: chunk grids (however
    narrow) fold into an int64 (or uint64) accumulator with exact integer
    adds, so the fleet-total grid is invariant to chunk size and order.
  * ``pack_bool`` / ``unpack_bool`` — bit-packing for boolean fail grids
    (8 cells per byte, ``np.packbits`` layout), exact roundtrip.

Everything here is host-side numpy: the packed forms are the *resident*
representation between device calls, which is exactly where the dense paths
spent their memory.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# narrowing ladder: smallest first; int64 is the "no narrowing possible" rung
_UNSIGNED_LADDER = (np.uint8, np.uint16, np.uint32)


def narrow_counts(counts: np.ndarray) -> np.ndarray:
    """Smallest-exact-dtype view of a nonnegative integer count grid.

    Picks the first unsigned dtype in (uint8, uint16, uint32) that holds
    ``counts.max()`` exactly, falling back to int64.  Raises on negative
    values or non-integer dtypes — packing is for counts, and a silent cast
    of float data would be a parity bug, not a compression.
    """
    counts = np.asarray(counts)
    if not np.issubdtype(counts.dtype, np.integer):
        raise TypeError(f"narrow_counts packs integer count grids; "
                        f"got dtype {counts.dtype}")
    if counts.size and int(counts.min()) < 0:
        raise ValueError("negative values in a count grid")
    hi = int(counts.max()) if counts.size else 0
    for dt in _UNSIGNED_LADDER:
        if hi <= int(np.iinfo(dt).max):
            return counts.astype(dt)
    return counts.astype(np.int64)


class CountAccumulator:
    """Exact widening accumulator for streamed count grids.

    ``update`` adds a chunk grid (any integer dtype, typically the narrowed
    form) into an int64 accumulator over the leading (DIMM) axis — or
    elementwise when ``axis=None``.  Integer adds commute, so the total is
    bit-invariant to chunk size and arrival order: the online-reduction
    exactness contract of ARCHITECTURE.md's streaming section.
    """

    def __init__(self, axis: int | None = 0):
        self.axis = axis
        self._acc: np.ndarray | None = None
        self.n_seen = 0

    def update(self, chunk: np.ndarray) -> None:
        chunk = np.asarray(chunk)
        if not np.issubdtype(chunk.dtype, np.integer):
            raise TypeError(f"CountAccumulator is exact-integer only; "
                            f"got dtype {chunk.dtype}")
        if self.axis is None:
            part, n = chunk.astype(np.int64), 1
        else:
            part = chunk.astype(np.int64).sum(axis=self.axis)
            n = chunk.shape[self.axis]
        self._acc = part if self._acc is None else self._acc + part
        self.n_seen += n

    def result(self) -> np.ndarray:
        if self._acc is None:
            raise ValueError("CountAccumulator.result() before any update")
        return self._acc


@dataclass(frozen=True)
class PackedBoolGrid:
    """Bit-packed boolean grid: 8 cells per byte plus the original shape."""
    bits: np.ndarray      # uint8, packbits of the flattened grid
    shape: tuple

    @property
    def nbytes(self) -> int:
        return int(self.bits.nbytes)


def pack_bool(grid: np.ndarray) -> PackedBoolGrid:
    """Bit-pack a boolean grid (fail/no-fail maps) — 8x smaller, exact."""
    grid = np.asarray(grid)
    if grid.dtype != np.bool_:
        raise TypeError(f"pack_bool packs boolean grids; got {grid.dtype}")
    return PackedBoolGrid(np.packbits(grid.reshape(-1)), tuple(grid.shape))


def unpack_bool(packed: PackedBoolGrid) -> np.ndarray:
    """Exact inverse of ``pack_bool``."""
    n = int(np.prod(packed.shape)) if packed.shape else 1
    flat = np.unpackbits(packed.bits, count=n).astype(bool)
    return flat.reshape(packed.shape)
