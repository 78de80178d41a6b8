"""Counter-based hashes for the Monte-Carlo draws: the profiling queries
(``query_uniform``), the Fig 17 burst-error draws (``burst_uniform``), the
memory-system traces and core mixes (``trace_uniform``, ``mix_uniform``) and
the synthetic fleet's leaves (``fleet_uniform``).

A frozen copy of the port's ``core/hashing.py``, kept with the benchmark:
the numpy forms make the synthetic fleet's leaves (``population.py``), the
torch forms draw the reference sweep's decisions (``reference.py``), and
both give the same bits for the same key as the program's.

Torch has no ``>>`` on ``uint32`` tensors, so the torch form carries each
32-bit word in an int64 tensor and masks it back to 32 bits after every
multiply and add.  A multiply is split into two 16-bit halves of the
constant, which keeps every intermediate product below 2**49: int64 never
overflows, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

_GOLD = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _mix32(h):
    """numpy ``uint32`` finalizer (the reference's ``_mix32`` on numpy)."""
    h = h ^ (h >> 16)
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * np.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    return h


def query_uniform(serial, param_idx, t_q, multibit, sub, pat):
    """Deterministic uniform in [0, 1) for one Monte-Carlo profiling query,
    keyed by (DIMM serial, timing parameter, quantized t_op, ECC criterion,
    subarray, pattern index).  Inputs broadcast; pass arrays, not 0-d
    scalars."""
    u32 = lambda v: np.asarray(v, np.uint32)
    h = u32(serial) * np.uint32(_GOLD)
    h = _mix32(h ^ (u32(param_idx) * np.uint32(0x85EBCA6B)))
    h = _mix32(h ^ (u32(t_q) * np.uint32(0xC2B2AE35)))
    h = _mix32(h ^ (u32(multibit) + u32(sub) * np.uint32(0x27D4EB2F)
                    + u32(pat) * np.uint32(0x165667B1)))
    # top 24 bits -> exactly representable float32 in [0, 1)
    return (h >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))


def quantize_t(t_op) -> int:
    """The hash's t_op key: quarter-ns quantization (grid values are exact)."""
    return int(round(float(t_op) * 4))


def _mul32(h, c: int):
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32) and a 32-bit
    constant ``c``, without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32_t(h):
    """Torch twin of ``_mix32`` on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def query_uniform_t(serial, param_idx: int, t_q, multibit: int, sub, pat):
    """Torch twin of ``query_uniform``: ``serial``, ``t_q`` and ``pat`` are
    int64 tensors (any values; taken mod 2**32), the rest Python ints or
    int64 tensors.  Returns float32 on ``serial``'s device."""
    dev = serial.device
    u32 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev) & _M32
    h = _mul32(u32(serial), _GOLD)
    h = _mix32_t(h ^ _mul32(u32(param_idx), 0x85EBCA6B))
    h = _mix32_t(h ^ _mul32(u32(t_q), 0xC2B2AE35))
    h = _mix32_t(h ^ ((u32(multibit) + _mul32(u32(sub), 0x27D4EB2F)
                       + _mul32(u32(pat), 0x165667B1)) & _M32))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def burst_uniform(seed, access, lane):
    """Deterministic uniform in [0, 1) for one (access, burst-lane) error draw
    of the Fig 17 shuffling experiment — a sibling stream of
    ``query_uniform`` with its own mixing constants.  Inputs broadcast; pass
    arrays, not 0-d scalars."""
    u32 = lambda v: np.asarray(v, np.uint32)
    h = u32(seed) * np.uint32(_GOLD)
    h = _mix32(h ^ (u32(access) * np.uint32(0xB5297A4D)))
    h = _mix32(h ^ (u32(lane) * np.uint32(0x68E31DA4)))
    return (h >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))


def burst_uniform_t(seed, access, lane):
    """Torch twin of ``burst_uniform`` on int64 tensors (any values; taken
    mod 2**32).  Returns float32 on ``seed``'s device."""
    dev = seed.device
    u32 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev) & _M32
    h = _mul32(u32(seed), _GOLD)
    h = _mix32_t(h ^ _mul32(u32(access), 0xB5297A4D))
    h = _mix32_t(h ^ _mul32(u32(lane), 0x68E31DA4))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def trace_uniform(seed, idx, lane):
    """Deterministic uniform in [0, 1) for one per-request draw of the memsim
    synthetic workloads, keyed by (workload stream seed, request index, draw
    lane) — never by batch position.  Inputs broadcast; pass arrays, not 0-d
    scalars."""
    u32 = lambda v: np.asarray(v, np.uint32)
    h = u32(seed) * np.uint32(_GOLD)
    h = _mix32(h ^ (u32(idx) * np.uint32(0xBF58476D)))
    h = _mix32(h ^ (u32(lane) * np.uint32(0x94D049BB)))
    return (h >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))


def fleet_uniform(seed, serial, lane):
    """Deterministic uniform in [0, 1) for one synthetic-fleet leaf draw of
    ``population.synthetic_fleet``, keyed by (fleet seed, DIMM serial, leaf
    lane) and never by chunk position: a chunked fleet generator emits the
    same DIMM bits at any chunk size.  Inputs broadcast; pass arrays, not
    0-d scalars."""
    u32 = lambda v: np.asarray(v, np.uint32)
    h = u32(seed) * np.uint32(_GOLD)
    h = _mix32(h ^ (u32(serial) * np.uint32(0x2545F491)))
    h = _mix32(h ^ (u32(lane) * np.uint32(0x9E6D62D9)))
    return (h >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))


def mix_uniform(seed, draw, core):
    """Deterministic uniform in [0, 1) for one multi-core workload-mix pick
    (Sec 6.3's 32 random mixes), keyed by (seed, mix draw, core slot): a
    stream of its own, so the trace configuration cannot move the mixes."""
    u32 = lambda v: np.asarray(v, np.uint32)
    h = u32(seed) * np.uint32(_GOLD)
    h = _mix32(h ^ (u32(draw) * np.uint32(0xA0761D65)))
    h = _mix32(h ^ (u32(core) * np.uint32(0xE7037ED1)))
    return (h >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))
