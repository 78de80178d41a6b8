"""576-lane burst permutations (DIVA Shuffling): plain version and CUDA kernel.

``apply_shuffle`` replaces the Pallas TPU kernel
``repro/kernels/shuffle.py::_permute`` (``:64``) behind its ``apply_shuffle``
(``:90``): (N, 576) int32 burst lanes -> (N, 576) int32 with
``out[:, i] = x[:, perm[i]]``.  ``perm`` defaults to
``shuffle_permutation(shuffle)`` (the DIVA Shuffling layout, or the
unshuffled one); any permutation of 0..575 is taken (the memsys codec passes
its interleave), and ``inverse=True`` applies the inverse permutation, which
is what the reference's transposed matrix computes.  The TPU kernel
multiplies by a 576x576 permutation matrix because the TPU avoids gathers;
on Hopper the permutation is a gather, so the port carries no matrix.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version ``apply_shuffle_ref`` (``x[:, perm]``), a CUDA tensor to the kernel
in ``csrc/shuffle.cu``; anything else raises.  ``apply_shuffle.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.shuffling import N_DQ, beat_of_bit

LANES = 9 * 64


@functools.lru_cache(maxsize=None)
def shuffle_permutation(shuffle: bool = True) -> np.ndarray:
    """perm[i] = source lane for output lane i (output = burst laid out as
    (beat, chip, dq); chip beats rotated when ``shuffle``, identity layout —
    beat = bit // 8 for every chip — when not).  Cached; treat as read-only."""
    perm = np.zeros(LANES, np.int32)
    for chip in range(9):
        for bit in range(64):
            beat = int(beat_of_bit(bit, chip, shuffle and chip < 8))
            dq = bit % N_DQ
            perm[beat * 72 + chip * N_DQ + dq] = chip * 64 + bit
    return perm


@functools.lru_cache(maxsize=None)
def _perm_tensor(perm_bytes: bytes, inverse: bool,
                 device: torch.device) -> torch.Tensor:
    """The (576,) int64 gather index on ``device``, once per distinct
    (permutation, direction, device)."""
    perm = np.frombuffer(perm_bytes, np.int32)
    if not np.array_equal(np.sort(perm), np.arange(LANES)):
        raise ValueError(f"perm must be a permutation of 0..{LANES - 1}")
    if inverse:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(LANES, dtype=np.int32)
        perm = inv
    return torch.as_tensor(perm.astype(np.int64), device=device)


def apply_shuffle_ref(bursts, perm):
    """Plain PyTorch version of the kernel: ``perm`` is the (576,) int64
    gather index, on ``bursts``' device."""
    return bursts[:, perm]


def _launch(bursts, perm):
    """Launch the kernel; returns the permuted bursts."""
    from repro_torch.kernels.build import LaunchError, load
    if not bursts.is_contiguous():
        raise ValueError("diva_shuffle: the bursts must be contiguous")
    out = torch.empty_like(bursts)
    if bursts.shape[0]:
        fn = load("shuffle").diva_shuffle_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
        with torch.cuda.device(bursts.device):
            stream = torch.cuda.current_stream(bursts.device).cuda_stream
            err = fn(bursts.data_ptr(), perm.data_ptr(), out.data_ptr(),
                     bursts.shape[0], stream)
        if err != 0:
            raise LaunchError(f"diva_shuffle failed: CUDA error {err}")
    return out


def apply_shuffle(bursts, *, inverse: bool = False, shuffle: bool = True,
                  perm=None):
    """bursts: (N, 576) int32 lanes -> permuted (or, with ``inverse``,
    un-permuted) lanes.  ``perm`` overrides the permutation (default:
    ``shuffle_permutation(shuffle)``); one that is not a permutation of
    0..575 raises."""
    if not isinstance(bursts, torch.Tensor):
        raise TypeError(f"apply_shuffle takes a torch tensor, got "
                        f"{type(bursts).__name__}")
    if bursts.dim() != 2 or bursts.shape[1] != LANES:
        raise ValueError(f"apply_shuffle takes (N, {LANES}) lanes, got "
                         f"{tuple(bursts.shape)}")
    if bursts.dtype != torch.int32:
        raise TypeError(f"apply_shuffle takes int32 lanes, got {bursts.dtype}")
    if perm is None:
        perm = shuffle_permutation(shuffle)
    perm = np.asarray(perm.cpu() if isinstance(perm, torch.Tensor) else perm)
    if perm.shape != (LANES,):
        raise ValueError(f"perm must have shape ({LANES},), got {perm.shape}")
    index = _perm_tensor(perm.astype(np.int32).tobytes(), bool(inverse),
                         bursts.device)
    kind = bursts.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"apply_shuffle runs on cpu or cuda tensors, not {kind}")
    if kind == "cpu":
        return apply_shuffle_ref(bursts, index)
    out = _launch(bursts, index)
    if bursts.shape[0]:
        apply_shuffle.launches += 1
    return out


apply_shuffle.launches = 0
