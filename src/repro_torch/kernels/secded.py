"""SECDED(72,64) check bits and syndromes: plain versions and CUDA kernels.

``encode_checks`` replaces the Pallas TPU kernel
``repro/kernels/secded.py::encode_checks`` (``:56``) and ``syndrome`` replaces
``::syndrome`` (``:73``): (N, 64) or (N, 72) int32 0/1 bits -> (N, 8) int32
parity bits of the Hsiao code (H_DATA / H_FULL of core/ecc.py).  Any N works,
0 included.

Dispatch is by the tensor's device alone: a CPU tensor goes to the plain
version (``encode_checks_ref`` / ``syndrome_ref``, the TPU kernel's own body
``(x @ H) % 2`` — exact in float32, every sum is at most 72), a CUDA tensor
to the kernels of ``csrc/secded.cu`` (its header states the bound and the
design); anything else raises.
``encode_checks.launches`` and ``syndrome.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

DATA_BITS, CODE_BITS, CHECK_BITS = 64, 72, 8


def _parity_ref(x, h_np):
    h = torch.as_tensor(h_np, dtype=torch.float32, device=x.device)
    return (x.float() @ h).to(torch.int32) % 2


def encode_checks_ref(data_bits):
    """Plain PyTorch version of ``encode_checks``, on any device."""
    from repro_torch.core.ecc import H_DATA
    return _parity_ref(data_bits, H_DATA)


def syndrome_ref(code_bits):
    """Plain PyTorch version of ``syndrome``, on any device."""
    from repro_torch.core.ecc import H_FULL
    return _parity_ref(code_bits, H_FULL)


def _check(x, width: int, name: str):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} takes a torch tensor, got {type(x).__name__}")
    if x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"{name} takes (N, {width}) bits, got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 bits, got {x.dtype}")


def _launch(symbol: str, x):
    """Launch ``symbol``; returns the check bits."""
    from repro_torch.kernels.build import LaunchError, load
    if not x.is_contiguous():
        raise ValueError(f"{symbol}: the bits must be contiguous")
    out = torch.empty((x.shape[0], CHECK_BITS), dtype=torch.int32, device=x.device)
    if x.shape[0]:
        entry = getattr(load("secded"), symbol)
        entry.restype = ctypes.c_int
        entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = entry(x.data_ptr(), out.data_ptr(), x.shape[0], stream)
        if err != 0:
            raise LaunchError(f"{symbol} failed: CUDA error {err}")
    return out


def _dispatch(fn, ref, symbol: str, x):
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{fn.__name__} runs on cpu or cuda tensors, not {kind}")
    if kind == "cpu":
        return ref(x)
    out = _launch(symbol, x)
    if x.shape[0]:
        fn.launches += 1
    return out


def encode_checks(data_bits):
    """(N, 64) int32 0/1 data bits -> (N, 8) int32 check bits."""
    _check(data_bits, DATA_BITS, "encode_checks")
    return _dispatch(encode_checks, encode_checks_ref, "secded_encode_launch", data_bits)


def syndrome(code_bits):
    """(N, 72) int32 0/1 codewords -> (N, 8) int32 syndrome bits."""
    _check(code_bits, CODE_BITS, "syndrome")
    return _dispatch(syndrome, syndrome_ref, "secded_syndrome_launch", code_bits)


encode_checks.launches = 0
syndrome.launches = 0
