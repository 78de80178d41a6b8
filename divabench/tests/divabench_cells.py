"""The benchmark's cells cut to CPU-test sizes (the geometry and the pool
only; the traffic's operating points and limits are the cells' own)."""
from __future__ import annotations

import dataclasses

from divabench import harness

TINY = {"rows_per_mat": 64, "cols_per_mat": 64, "mats_x": 4, "subarrays": 2,
        "banks": 1, "chips": 8, "burst_bits": 64, "open_bitline": True}
SMALL = {"rows_per_mat": 128, "cols_per_mat": 128, "mats_x": 8,
         "subarrays": 4, "banks": 1, "chips": 8, "burst_bits": 64,
         "open_bitline": True}
CELLS = ("fleet.profile", "paper96.characterize", "fleet.summary")


def manifest() -> dict:
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def small_cell(name: str, geom: dict = TINY, dimms: int = 32) -> harness.Cell:
    """``name`` at ``geom`` with ``dimms`` DIMMs: a fleet in two chunks, or
    a resident population."""
    cell = harness.Cell.load(manifest(), name)
    config = dict(cell.config, geometry=dict(geom), n_dimms=dimms)
    traffic = dict(cell.traffic)
    if "chunk_dimms" in traffic:
        traffic["chunk_dimms"] = dimms // 2
    return dataclasses.replace(cell, config=config, traffic=traffic)
