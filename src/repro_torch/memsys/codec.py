"""Reliability codec: SECDED(72,64) + DIVA-style shuffling over byte blobs.
The counterpart of ``repro.memsys.codec``.

Each 64-bit word gets an 8-bit Hsiao code; groups of 8 codewords form a
576-bit "burst".  Threat model: spatially correlated corruption — a
contiguous run of bits (bad host-DRAM region, torn write).  In codeword-major
layout any >= 2-bit run lands in one codeword and defeats SECDED; the DIVA
move (Fig 16b) is bit-level round-robin interleaving: stored bit l belongs to
codeword l % 8, so a contiguous run of up to 8 flipped bits puts at most one
error in each codeword — fully correctable.

The bit path runs on the device (default: the CUDA device; ``device="cpu"``
runs the plain versions): bytes unpack to bits there, the check bits come
from the ``secded_encode`` kernel, the interleave and its inverse from the
``diva_shuffle`` kernel, and the decode from the ``secded_syndrome`` kernel
and ``ecc.decode_given_syndrome``.  Lanes return as int8 numpy and data as
``bytes``, as in the reference.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import ecc
from repro_torch.device import resolve_device
from repro_torch.kernels.secded import encode_checks, syndrome
from repro_torch.kernels.shuffle import apply_shuffle

BURST_WORDS = 8          # codewords per interleaved burst
BURST_LANES = BURST_WORDS * ecc.CODE_BITS  # 576 bit lanes


@functools.lru_cache(maxsize=1)
def interleave_permutation() -> np.ndarray:
    """perm[l] = source index (codeword-major w*72+pos) of stored lane l,
    with l = pos*8 + w — the round-robin spread across the burst's 8
    codewords."""
    w, pos = np.meshgrid(np.arange(BURST_WORDS), np.arange(ecc.CODE_BITS),
                         indexing="ij")
    perm = np.zeros(BURST_LANES, np.int32)
    perm[(pos * BURST_WORDS + w).ravel()] = (w * ecc.CODE_BITS + pos).ravel()
    return perm


@dataclass
class CodecStats:
    codewords: int
    corrected: int
    uncorrectable: int

    @property
    def ok(self) -> bool:
        return self.uncorrectable == 0


def _unpack_bits(b):
    """uint8 (N, k) -> (N, 8k) int32 bits, LSB first (``np.unpackbits`` with
    ``bitorder="little"``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device)
    bits = (b[..., None] >> shifts) & 1
    return bits.reshape(b.shape[0], 8 * b.shape[1]).to(torch.int32)


def _pack_bits(bits):
    """(N, 8k) 0/1 bits -> uint8 (N, k), LSB first (``_unpack_bits``'
    inverse)."""
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    grouped = bits.reshape(bits.shape[0], bits.shape[1] // 8, 8)
    return (grouped * weights).sum(-1).to(torch.uint8)


def protect_blob(data: bytes, *, shuffle: bool = True, device=None) -> np.ndarray:
    """bytes -> (G, 576) 0/1 int8 stored burst lanes."""
    dev = resolve_device(device)
    pad = (-len(data)) % (8 * BURST_WORDS)
    buf = np.zeros(len(data) + pad, np.uint8)
    buf[:len(data)] = np.frombuffer(data, np.uint8)
    data_bits = _unpack_bits(torch.as_tensor(buf, device=dev).reshape(-1, 8))
    bits = torch.cat([data_bits, encode_checks(data_bits)], dim=1)  # (N, 72)
    del data_bits
    flat = bits.reshape(-1, BURST_LANES)                     # codeword-major
    if shuffle:  # stored lane l = pos*8 + w (round-robin across codewords)
        flat = apply_shuffle(flat, perm=interleave_permutation())
    return flat.to(torch.int8).cpu().numpy()


def recover_blob(lanes, n_bytes: int, *, shuffle: bool = True,
                 device=None) -> tuple[bytes, CodecStats]:
    """Stored lanes (numpy or a tensor) -> (the first ``n_bytes`` of the
    corrected data, stats)."""
    dev = resolve_device(device)
    lanes = torch.as_tensor(lanes).to(dev, torch.int32).contiguous()
    if shuffle:
        lanes = apply_shuffle(lanes, inverse=True, perm=interleave_permutation())
    code = lanes.reshape(-1, ecc.CODE_BITS)
    fixed, status = ecc.decode_given_syndrome(code, syndrome(code))
    by = _pack_bits(fixed).reshape(-1).cpu().numpy()
    stats = CodecStats(codewords=len(code),
                       corrected=int((status == 1).sum()),
                       uncorrectable=int((status == 2).sum()))
    return by.tobytes()[:n_bytes], stats


def corrupt_run(lanes: np.ndarray, *, burst: int, start_lane: int, n_bits: int) -> np.ndarray:
    """Flip a contiguous run of stored bits — the correlated-corruption model
    (numpy, on the host)."""
    out = np.array(lanes, copy=True)
    sl = slice(start_lane, min(start_lane + n_bits, out.shape[1]))
    out[burst, sl] ^= 1
    return out


def scrub(lanes, n_bytes: int, *, shuffle: bool = True,
          device=None) -> tuple[np.ndarray, CodecStats]:
    """Verify-and-repair pass: decode, re-encode corrected data."""
    data, stats = recover_blob(lanes, n_bytes, shuffle=shuffle, device=device)
    if stats.corrected and not stats.uncorrectable:
        return protect_blob(data, shuffle=shuffle, device=device), stats
    return lanes, stats
