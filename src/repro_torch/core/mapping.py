"""Reverse-engineering the external->internal row mapping (Section 5.3).

The paper hypothesises the scramble is a bit permutation + XOR and picks the
assignment that makes error counts follow the design-expected profile,
reporting per-bit confidence (Fig 10/11). Our estimator works on single-bit
signatures, which is robust to the open-bitline V-shape:

  * signature of an address bit = the mean error-count difference between
    rows with that bit set vs clear;
  * internal bits are matched to external bits by signature magnitude (each
    internal bit has a distinct magnitude: the MSB splits near/far halves —
    large difference; the LSB splits even/odd neighbours — tiny difference);
  * confidence of a matched pair = the fraction of the 2^(n-1) row pairs
    differing ONLY in that external bit whose observed ordering agrees with
    the design-expected ordering.

Process variation, outlier cells and row repair perturb pair orderings, so
confidence stays below 100% and decays toward the LSBs — Fig 11's shape.

This module is the per-subarray NumPy reference (a copy of
``repro.core.mapping``); the population-scale path is
``repro_torch.discovery.recover.recover_mapping_population``.  To keep the
two decision- and confidence-identical, integer error counts take an *exact*
arithmetic route shared with the device program:

  * per-bit signatures are integer (sum_set - sum_clear) reductions — exact
    and summation-order independent — followed by one float32 convert and one
    power-of-two divide (both exact up to the int->f32 rounding, which is
    identical on every backend);
  * magnitude ranking sorts the integer sums with a STABLE sort (equal
    magnitudes tie-break on bit index, deterministically — ``np.argsort``'s
    default quicksort used to make ties platform-dependent);
  * a zero observed signature carries no ordering information, so its XOR bit
    is pinned to 0 explicitly (``np.sign`` returning 0 used to make the
    sign comparison infer xor=1 spuriously);
  * the expected profile is consumed as float32 and every pair vote is a
    single-op float32 comparison, so numpy and torch agree bit for bit;
  * confidences are assembled from integer vote counts with float64 division
    on the host (the ``condition_adders`` parity-by-construction convention).

Float (non-integer) observed counts keep a float64 signature path — they have
no device sibling, so only internal consistency matters there.
"""
from __future__ import annotations

import numpy as np


def _signature_sums(counts: np.ndarray, nbits: int) -> np.ndarray:
    """Per-address-bit (sum over rows with the bit set) - (sum with it clear).

    Integer counts reduce in int64 — exact, order-independent, and equal to
    the ``kernels/bit_signature`` device reduction value-for-value; float
    counts reduce in float64 (reference-only path).
    """
    counts = np.asarray(counts)
    idx = np.arange(len(counts))
    exact = counts.dtype.kind in "biu"
    work = counts.astype(np.int64 if exact else np.float64)
    out = np.zeros(nbits, work.dtype)
    for b in range(nbits):
        one = (idx >> b) & 1 == 1
        out[b] = work[one].sum() - work[~one].sum()
    return out


def _bit_signature(counts: np.ndarray, nbits: int) -> np.ndarray:
    """Mean error-count difference per address bit (set minus clear).

    For integer counts this is float32(sum_diff) / (n/2) — n/2 is a power of
    two, so the divide is exact and the value matches the batched
    ``discovery.signatures`` path bit-for-bit.
    """
    sums = _signature_sums(counts, nbits)
    half = len(np.asarray(counts)) // 2
    if sums.dtype.kind == "i":
        return sums.astype(np.float32) / np.float32(half)
    return sums / half


def _xor_bit(sig_obs, sig_exp) -> int:
    """XOR decision for one matched (ext, int) bit pair: the observed ordering
    is inverted iff the two signatures disagree in sign.  A zero signature on
    either side carries no ordering information — pin xor to 0 (``np.sign``'s
    0 would otherwise never equal a nonzero sign and silently infer xor=1)."""
    if sig_obs == 0 or sig_exp == 0:
        return 0
    return int((sig_obs < 0) != (sig_exp < 0))


def estimate_row_mapping(counts_ext: np.ndarray, expected_int: np.ndarray):
    """counts_ext: observed per-external-row error counts (one subarray).
    expected_int: model-expected per-internal-row counts (design order).

    Returns a list over internal bits: {int_bit, ext_bit, xor, confidence}.
    """
    counts_ext = np.asarray(counts_ext)
    expected_int = np.asarray(expected_int)
    n = len(counts_ext)
    nbits = int(np.log2(n))
    assert 2 ** nbits == n == len(expected_int)
    sig_obs = _signature_sums(counts_ext, nbits)
    sig_exp = _signature_sums(expected_int, nbits)

    # match by magnitude, strongest first (greedy assignment); stable sorts
    # make equal-magnitude ties deterministic (lowest bit index first)
    order_int = np.argsort(-np.abs(sig_exp), kind="stable")
    order_ext = np.argsort(-np.abs(sig_obs), kind="stable")
    assign = {}
    for rank, i in enumerate(order_int):
        b = order_ext[rank]
        assign[int(i)] = (int(b), _xor_bit(sig_obs[b], sig_exp[i]))

    # estimated ext->int map from the assignment (for expected pair diffs)
    idx = np.arange(n)
    est_int = np.zeros(n, np.int64)
    for i, (b, xor) in assign.items():
        est_int |= ((((idx >> b) & 1) ^ xor) << i)

    # expected profile in float32: each pair vote is then a single-op f32
    # comparison, identical between this reference and the batched recovery
    exp32 = expected_int.astype(np.float32)
    out = [None] * nbits
    for i, (b, xor) in assign.items():
        hi_addr = idx | (1 << b)
        lo_addr = idx & ~(1 << b)
        sel = (idx >> b) & 1 == 0  # each pair once
        obs_diff = (counts_ext[hi_addr] - counts_ext[lo_addr])[sel]
        exp_diff = (exp32[est_int[hi_addr]] - exp32[est_int[lo_addr]])[sel]
        # Poisson noise floor per pair; only design-significant pairs vote
        noise = np.sqrt((counts_ext[hi_addr][sel] + counts_ext[lo_addr][sel]
                         + 1.0).astype(np.float32))
        signif = np.abs(exp_diff) > noise
        agree = np.sign(obs_diff) == np.sign(exp_diff)
        n_sig = int(np.count_nonzero(signif))
        if n_sig >= 4:
            conf = float(np.count_nonzero(agree & signif)) / n_sig
        else:  # bit effect below the noise floor: coin-flip confidence
            frac = np.count_nonzero(agree) / (n // 2)
            conf = 0.5 + 0.5 * max(frac - 0.5, 0.0)
        out[i] = {"int_bit": int(i), "ext_bit": int(b), "xor": xor,
                  "confidence": conf, "n_significant_pairs": n_sig}
    return out


def mapping_confidences(results) -> np.ndarray:
    return np.array([r["confidence"] for r in results])
