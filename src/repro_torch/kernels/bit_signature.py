"""Per-address-bit error signatures of count rows: plain version and CUDA
kernel.

``bit_signature`` replaces the Pallas TPU kernel
``repro/kernels/bit_signature.py::bit_signature`` (``:53``): for (N, R) int32
per-row error counts with R = 2**nbits, it returns (N, nbits) int32, per
address bit b the sum over rows with bit b set minus the sum over rows with
it clear.  The sums wrap like the reference's int32 arithmetic.

Dispatch is by the tensor's device alone: CPU tensors go to
``bit_signature_ref``, CUDA tensors to the kernel in ``csrc/bit_signature.cu``
(its header states the bound and the design); anything else raises.
``bit_signature.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

MAX_BITS = 16


def bit_signature_ref(counts, *, nbits: int):
    """Plain PyTorch version of the kernel, on any device: exact int64 sums,
    wrapped to int32 (the same value as int32 arithmetic, whose sums do not
    depend on the order of the adds)."""
    r = torch.arange(counts.shape[1], dtype=torch.int64, device=counts.device)
    wide = counts.to(torch.int64)
    cols = [(wide * (((r >> b) & 1) * 2 - 1)).sum(dim=1) for b in range(nbits)]
    return torch.stack(cols, dim=1).to(torch.int32)


def _check(counts, nbits: int):
    if counts.dim() != 2:
        raise ValueError(f"counts must be (N, R), got {tuple(counts.shape)}")
    if counts.dtype != torch.int32:
        raise TypeError(f"counts must be int32, got {counts.dtype}")
    if not 1 <= nbits <= MAX_BITS or counts.shape[1] != 2 ** nbits:
        raise ValueError(f"counts rows must hold 2**nbits entries with "
                         f"1 <= nbits <= {MAX_BITS}; got R = "
                         f"{counts.shape[1]}, nbits = {nbits}")


def _launch(counts, nbits: int):
    """Launch the kernel; returns the sums."""
    from repro_torch.kernels.build import LaunchError, load
    if not counts.is_contiguous():
        raise ValueError("counts must be contiguous")
    n, R = counts.shape
    out = torch.empty((n, nbits), dtype=torch.int32, device=counts.device)
    if n:
        fn = load("bit_signature").bit_signature_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        vec = R % 4 == 0 and counts.data_ptr() % 16 == 0
        with torch.cuda.device(counts.device):
            stream = torch.cuda.current_stream(counts.device).cuda_stream
            err = fn(counts.data_ptr(), out.data_ptr(), n, R, nbits, int(vec), stream)
        if err != 0:
            raise LaunchError(f"bit_signature kernel launch failed: CUDA "
                              f"error {err}")
    return out


def bit_signature(counts, *, nbits: int):
    """(N, 2**nbits) int32 counts -> (N, nbits) int32 signature sums."""
    _check(counts, nbits)
    kind = counts.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"bit_signature runs on cpu or cuda tensors, not {kind}")
    if kind == "cpu":
        return bit_signature_ref(counts, nbits=nbits)
    out = _launch(counts, nbits)
    if counts.shape[0]:
        bit_signature.launches += 1
    return out


bit_signature.launches = 0
