"""DIVA Shuffling (Section 6.2): spread design-correlated error bits across
ECC codewords.  A numpy copy of ``repro.core.shuffling``.

Burst model (Fig 5 / Fig 16): a column command moves 64 bits per chip as 8
beats x 8 DQ pins.  Beat b forms ECC codeword b: the 8 data chips contribute
8 bits each (64 data bits) and the ECC chip contributes the 8 check bits.

Because chips share the same die design, their high-error burst positions
coincide — without shuffling, the error-prone bits of all 8 chips land in
the SAME beat => multi-bit errors in one codeword (SECDED-uncorrectable).
DIVA Shuffling rotates each chip's bit->beat mapping by its chip index, so
coincident positions spread over 8 different codewords.

The per-access numpy walker (``shuffling_gain_loop``) draws its errors with
the counter hash ``hashing.burst_uniform``, the numpy twin of the draws of
the batched ``substrate.shuffling_gain_population``, so the two give the
same counts.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import ecc
from repro_torch.core.hashing import burst_uniform

N_BEATS = 8
N_DQ = 8


def beat_of_bit(bit: np.ndarray, chip: np.ndarray, shuffle: bool) -> np.ndarray:
    """Which beat (codeword) a chip's burst-bit belongs to."""
    beat = np.asarray(bit) // N_DQ
    if shuffle:
        beat = (beat + np.asarray(chip)) % N_BEATS
    return beat


def assemble_error_masks(chip_errors: np.ndarray, shuffle: bool) -> np.ndarray:
    """chip_errors: (9, 64) 0/1 error indicators per chip (8 data + 1 ECC) for
    one column access.  Returns (8, 72) per-codeword error masks."""
    assert chip_errors.shape == (9, 64)
    masks = np.zeros((N_BEATS, ecc.CODE_BITS), np.int32)
    for chip in range(9):
        for bit in range(64):
            if not chip_errors[chip, bit]:
                continue
            b = int(beat_of_bit(bit, chip, shuffle and chip < 8))
            dq = bit % N_DQ
            if chip < 8:
                masks[b, chip * N_DQ + dq] = 1
            else:  # ECC chip: check bits
                masks[b, ecc.DATA_BITS + dq] = 1
    return masks


def correctable_stats(chip_errors: np.ndarray, shuffle: bool) -> dict:
    """SECDED outcome for one access: errors corrected vs escaped."""
    masks = assemble_error_masks(chip_errors, shuffle)
    per_cw = masks.sum(axis=1)
    total = int(per_cw.sum())
    corrected = int(per_cw[per_cw == 1].sum())
    return {"total": total, "corrected": corrected,
            "uncorrectable_words": int((per_cw > 1).sum())}


def design_stripe_profiles(n_dimms: int, *, seed: int = 11,
                           base: float = 2e-5) -> np.ndarray:
    """(n_dimms, 9, 64) Fig 17-style synthetic burst-bit error profiles: per
    DIMM, one design-vulnerable stripe of burst positions (width 4-12, error
    level 0.005-0.04) shared across all chips on a flat ``base`` floor."""
    rng = np.random.default_rng(seed)
    probs = np.full((n_dimms, 9, 64), base, np.float32)
    for d in range(n_dimms):
        start = rng.integers(0, 56)
        width = int(rng.integers(4, 12))
        probs[d, :, start:start + width] = rng.uniform(0.005, 0.04)
    return probs


def sample_chip_errors(bit_error_prob: np.ndarray, seed: int,
                       n_accesses: int) -> np.ndarray:
    """bit_error_prob: (9, 64) per-bit error probability (from the DIMM's
    burst-bit profile, Fig 12).  Returns (n_accesses, 9, 64) 0/1, drawn from
    the counter hash keyed on (seed, access, lane)."""
    acc = np.arange(n_accesses, dtype=np.uint32)[:, None]
    lane = np.arange(9 * 64, dtype=np.uint32)[None, :]
    u = burst_uniform(np.full((1, 1), seed, np.uint32), acc, lane)
    errs = u < np.asarray(bit_error_prob, np.float32).reshape(1, 9 * 64)
    return errs.astype(np.int32).reshape(n_accesses, 9, 64)


def shuffling_gain_loop(bit_error_prob: np.ndarray, *, n_accesses: int = 2000,
                        seed: int = 0) -> dict:
    """Fig 17 experiment, per-access numpy walker: fraction of errors
    correctable with and without DIVA Shuffling under SECDED, for one DIMM's
    burst-bit error profile."""
    errs = sample_chip_errors(bit_error_prob, seed, n_accesses)
    tot = corr_ns = corr_s = 0
    for e in errs:
        if not e.any():
            continue
        s0 = correctable_stats(e, shuffle=False)
        s1 = correctable_stats(e, shuffle=True)
        tot += s0["total"]
        corr_ns += s0["corrected"]
        corr_s += s1["corrected"]
    if tot == 0:
        return {"total": 0, "frac_no_shuffle": 1.0, "frac_shuffle": 1.0, "gain": 0.0}
    return {"total": tot,
            "frac_no_shuffle": corr_ns / tot,
            "frac_shuffle": corr_s / tot,
            "gain": (corr_s - corr_ns) / tot}


def shuffling_gain(bit_error_prob: np.ndarray, *, n_accesses: int = 2000,
                   seed: int = 0, device=None) -> dict:
    """One DIMM's Fig 17 gain through the batched
    ``substrate.shuffling_gain_population`` on ``device`` (default: the CUDA
    device)."""
    from repro_torch.core.substrate import shuffling_gain_population
    out = shuffling_gain_population(np.asarray(bit_error_prob)[None],
                                    seeds=[seed], n_accesses=n_accesses,
                                    device=device)
    return {"total": int(out["total"][0]),
            "frac_no_shuffle": float(out["frac_no_shuffle"][0]),
            "frac_shuffle": float(out["frac_shuffle"][0]),
            "gain": float(out["gain"][0])}
