"""Batched per-address-bit error signatures for the whole population.

The signature of address bit b in an error-count vector is the mean count
difference between rows with b set and rows with b clear — the single-bit
statistic Sec 5.3's mapping recovery ranks and sign-tests.  This module runs
the masked row-reduction for every (DIMM, subarray) profile in one
``bit_signature`` call (kernels/bit_signature.py: the CUDA kernel on a card,
its plain version on the CPU), shardable over the DIMM axis with ``mesh=``
like every other population entry point.

Values are identical to the per-subarray numpy reference
(``core.mapping._bit_signature``): the reduction is exact integer arithmetic
and the only float operations are one int->f32 convert and one power-of-two
divide.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.substrate import _dispatch
from repro_torch.kernels.bit_signature import bit_signature
from repro_torch.sharding import DimmMesh, mesh_device


def _signature_impl(counts, *, nbits: int):
    """(D, S, R) int32 tensor -> (D, S, nbits) f32 signatures (mean
    set-clear difference): integer kernel reduction, then the exact f32
    fold."""
    D, S, R = counts.shape
    sums = bit_signature(counts.reshape(D * S, R), nbits=nbits)
    return sums.reshape(D, S, nbits).to(torch.float32) \
        / torch.tensor(R // 2, dtype=torch.float32, device=counts.device)


def _nbits(R: int) -> int:
    nbits = int(np.log2(R))
    if 2 ** nbits != R:
        raise ValueError(f"rows per subarray must be a power of two; got {R}")
    return nbits


def bit_signature_population(counts, *, device=None,
                             mesh: DimmMesh | None = None) -> np.ndarray:
    """(D, S, nbits) f32 per-address-bit signatures for (D, S, R) (or
    (D, R)) integer error counts, on ``device`` (default: the CUDA device).
    ``mesh`` shards the DIMM axis instead (a pure per-DIMM map: the split
    cannot change a value).  R must be a power of two; nbits = log2(R)."""
    dev = mesh_device(mesh, device)
    counts = np.asarray(counts)
    if counts.ndim == 2:
        counts = counts[:, None, :]
    nbits = _nbits(counts.shape[2])
    t = torch.as_tensor(np.ascontiguousarray(counts, np.int32), device=dev)
    return _dispatch(mesh, _signature_impl, (t,), dict(nbits=nbits),
                     (0,)).cpu().numpy()


def signature_features(sigs: np.ndarray) -> np.ndarray:
    """(D, nbits) L2-normalized per-DIMM feature vectors for generation
    clustering: the subarray-MEAN signature (same design => same scramble =>
    aligned signature layout, so same-generation DIMMs point the same way).
    Averaging over subarrays first washes out the per-subarray offset noise
    that perturbs each subarray's signature scale.  All-zero signatures (the
    "no observed variation" DIMMs) stay zero vectors — the clusterer groups
    those together explicitly."""
    sigs = np.asarray(sigs, np.float64)
    feats = sigs.mean(axis=1) if sigs.ndim == 3 else sigs
    norm = np.linalg.norm(feats, axis=1, keepdims=True)
    return np.where(norm > 0, feats / np.maximum(norm, 1e-30), 0.0)
