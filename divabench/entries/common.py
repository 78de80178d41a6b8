"""What the entry drivers share: the program's batches and streams over the
benchmark's host leaves."""
from __future__ import annotations

import numpy as np

from divabench.population import take


def port_stream(leaves: dict, geom_fields: dict, device):
    """The program's ``PopulationStream`` over one host chunk of leaves: each
    chunk call lowers its slice through ``DimmBatch.from_arrays`` (the copy
    to the device is the program's, inside the window)."""
    from repro_torch.core.geometry import DimmGeometry
    from repro_torch.core.streaming import PopulationStream
    from repro_torch.core.substrate import DimmBatch
    n = len(leaves["serial"])

    def chunk_fn(lo: int, hi: int):
        return DimmBatch.from_arrays(geom_fields, take(leaves, slice(lo, hi)),
                                     device)

    return PopulationStream(n_dimms=n, geom=DimmGeometry(**geom_fields),
                            chunk_fn=chunk_fn, device=device)


def rel_err(got, want, axis=None) -> float:
    """The largest |got - want| over the largest |want|, along ``axis`` (per
    DIMM with ``axis`` the non-DIMM axes), the worst of them."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.max(np.abs(want), axis=axis, keepdims=axis is not None)
    err = np.max(np.abs(got - want), axis=axis, keepdims=axis is not None)
    return float(np.max(err / np.maximum(scale, 1e-30)))
