"""SECDED Hamming(72,64) — the Hsiao code of ``repro.core.ecc`` on PyTorch.

Codewords are (N, 72) 0/1 int32 tensors: 64 data bits + 8 check bits.  The
parity-check matrix H (72x8) uses odd-weight columns (56 weight-3 + 8
weight-5 for data, identity for checks), so:
  syndrome == 0            -> clean
  syndrome == column_i     -> single-bit error at i (correct it)
  otherwise (even weight)  -> double-bit error (detected, uncorrectable)

The constants and the byte helpers are numpy, as in the reference.
``encode`` and ``syndrome`` go through the kernel wrappers of
kernels/secded.py, so on a CUDA tensor they launch the hand-written kernel;
the correction step is plain torch ops on the tensors' device.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.secded import encode_checks
from repro_torch.kernels.secded import syndrome as _syndrome_bits

DATA_BITS = 64
CHECK_BITS = 8
CODE_BITS = DATA_BITS + CHECK_BITS


def _hsiao_columns() -> np.ndarray:
    """64 distinct odd-weight (>=3) 8-bit columns for the data positions."""
    cols = []
    for w in (3, 5):
        for comb in itertools.combinations(range(CHECK_BITS), w):
            v = np.zeros(CHECK_BITS, np.int32)
            v[list(comb)] = 1
            cols.append(v)
            if len(cols) == DATA_BITS:
                return np.stack(cols)
    raise AssertionError


H_DATA = _hsiao_columns()                     # (64, 8)
H_FULL = np.concatenate([H_DATA, np.eye(CHECK_BITS, dtype=np.int32)])  # (72, 8)
# syndrome value -> error position lookup (syndromes as packed ints)
_POW2 = 1 << np.arange(CHECK_BITS)
_SYN_TO_POS = np.full(256, -1, np.int32)
for _i, _c in enumerate(H_FULL):
    _SYN_TO_POS[int((_c * _POW2).sum())] = _i


def _bits(x) -> torch.Tensor:
    """A contiguous int32 tensor of ``x`` (numpy arrays land on the CPU)."""
    return torch.as_tensor(x).to(torch.int32).contiguous()


def encode(data_bits):
    """(N, 64) 0/1 -> (N, 72) codewords."""
    data_bits = _bits(data_bits)
    return torch.cat([data_bits, encode_checks(data_bits)], dim=-1)


def syndrome(code_bits):
    """(N, 72) -> (N, 8)."""
    return _syndrome_bits(_bits(code_bits))


def decode(code_bits):
    """(N, 72) -> (data (N,64), status (N,)) with status:
    0 = clean, 1 = corrected single-bit, 2 = uncorrectable (DED)."""
    code_bits = _bits(code_bits)
    return decode_given_syndrome(code_bits, syndrome(code_bits))


def correct_codewords(code_bits, syn):
    """(N, 72) codewords + precomputed (N, 8) syndrome -> (fixed (N, 72),
    status (N,)): the full corrected codewords (single-bit flips applied at
    data and check positions), status 0/1/2 as in ``decode``."""
    code_bits = torch.as_tensor(code_bits).to(torch.int32)
    dev = code_bits.device
    syn = torch.as_tensor(syn, device=dev).to(torch.int64)
    syn_val = (syn * torch.as_tensor(_POW2, device=dev)).sum(-1)       # (N,)
    pos = torch.as_tensor(_SYN_TO_POS, device=dev)[syn_val]  # -1 if not single
    clean = syn_val == 0
    single = ~clean & (pos >= 0)
    flip = single[:, None] & (torch.arange(CODE_BITS, device=dev)[None, :]
                              == pos[:, None])
    fixed = torch.where(flip, 1 - code_bits, code_bits)
    status = torch.where(clean, 0, torch.where(single, 1, 2)).to(torch.int32)
    return fixed, status


def decode_given_syndrome(code_bits, syn):
    """Correction and classification from a precomputed (N, 8) syndrome —
    shared by ``decode`` and the memsys codec."""
    fixed, status = correct_codewords(code_bits, syn)
    return fixed[:, :DATA_BITS], status


# ----------------------------------------------------------- byte helpers

def bytes_to_bits(b: np.ndarray) -> np.ndarray:
    """uint8 (N, 8) -> (N, 64) bit planes (LSB first)."""
    return np.unpackbits(b, axis=-1, bitorder="little").astype(np.int32)


def bits_to_bytes(bits: np.ndarray) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8), axis=-1, bitorder="little")


def protect_bytes(data: bytes, *, device=None) -> np.ndarray:
    """Encode a byte string into (N, 9) uint8 codeword rows (8 data + 1 ECC);
    the check bits are computed on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    pad = (-len(data)) % 8
    arr = np.frombuffer(data + b"\0" * pad, np.uint8).reshape(-1, 8)
    code = encode(torch.as_tensor(bytes_to_bits(arr), device=dev)).cpu().numpy()
    return np.concatenate([arr, bits_to_bytes(code[:, DATA_BITS:])], axis=1)


def recover_bytes(protected: np.ndarray, n_bytes: int, *, device=None
                  ) -> tuple[bytes, np.ndarray]:
    """Inverse of protect_bytes; returns (data, status per codeword)."""
    dev = resolve_device(device)
    data_bits = bytes_to_bits(np.ascontiguousarray(protected[:, :8]))
    check_bits = bytes_to_bits(np.ascontiguousarray(protected[:, 8:]))[:, :CHECK_BITS]
    code = np.concatenate([data_bits, check_bits], axis=1)
    fixed, status = decode(torch.as_tensor(code, device=dev))
    by = bits_to_bytes(fixed.cpu().numpy()).reshape(-1)
    return by.tobytes()[:n_bytes], status.cpu().numpy()
