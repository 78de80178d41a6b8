"""Population-scale scramble recovery (Sec 5.3, Figs 10-11) as one program.

``recover_mapping_population`` re-expresses ``core.mapping``'s
permutation+XOR estimator as tensor code over every (DIMM, subarray) error
profile at once — signatures through the ``bit_signature`` kernel
(kernels/bit_signature.py), magnitude ranking by stable sort, the greedy
strongest-first assignment as a permutation composition, and the 2^(n-1)
per-bit pair votes as batched gathers — on the chosen device.

Bit-parity contract with the per-subarray reference
(``mapping.estimate_row_mapping``, walked by ``recover_mapping_loop``):

  * the observed side is exact integer arithmetic end to end (signature
    sums, magnitude ranking, pair count differences);
  * the expected side is computed on the host with the very numpy helpers
    the reference uses (``mapping._signature_sums`` ranking + signs) and
    enters the device as float32, where every pair vote is a single-op f32
    comparison — identical under numpy and torch, on any device;
  * confidences leave the device as integer vote counts and are divided on
    the host in float64, so they are identical too.

A copy of ``repro.discovery.recover`` with the jitted program in torch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mapping import estimate_row_mapping
from repro_torch.core.substrate import _dispatch
from repro_torch.discovery.signatures import _nbits
from repro_torch.kernels.bit_signature import bit_signature
from repro_torch.sharding import DimmMesh, mesh_device


# ------------------------------------------------------- expected-side prep

def _broadcast_expected(expected, D: int, S: int, R: int) -> np.ndarray:
    """Expected profiles as (D, S, R) float64: accept (R,) shared, (D, R)
    per DIMM, or (D, S, R) per subarray."""
    expected = np.asarray(expected, np.float64)
    if expected.ndim == 1:
        expected = np.broadcast_to(expected, (D, S, R))
    elif expected.ndim == 2:
        expected = np.broadcast_to(expected[:, None, :], (D, S, R))
    if expected.shape != (D, S, R):
        raise ValueError(f"expected shape {expected.shape} does not "
                         f"broadcast to {(D, S, R)}")
    return np.ascontiguousarray(expected)


def _signature_sums_batch(profiles: np.ndarray, nbits: int) -> np.ndarray:
    """(N, R) float64 profiles -> (N, nbits) per-bit signature sums, the
    batch form of ``mapping._signature_sums``'s float path.  A contiguous
    last-axis reduction applies numpy's pairwise summation per row exactly
    as the 1-D sum does, so the values are bit-identical to the per-row
    helper — which is what keeps the batched recovery's rankings equal to
    the reference's (asserted in tests)."""
    idx = np.arange(profiles.shape[-1])
    out = np.empty(profiles.shape[:-1] + (nbits,), np.float64)
    for b in range(nbits):
        one = (idx >> b) & 1 == 1
        out[..., b] = (np.ascontiguousarray(profiles[..., one]).sum(axis=-1)
                       - np.ascontiguousarray(profiles[..., ~one])
                       .sum(axis=-1))
    return out


def _expected_tables(expected: np.ndarray, nbits: int):
    """Host-side per-(DIMM, subarray) expected-profile tables: float32
    profile, the strongest-first internal-bit order (stable: ties break on
    bit index), its inverse, and the signature signs — the same numpy ops
    the per-subarray reference runs, so both paths rank and sign
    identically."""
    sig = _signature_sums_batch(expected.astype(np.float64), nbits)
    order_int = np.argsort(-np.abs(sig), axis=-1, kind="stable") \
        .astype(np.int32)
    exp_sign = np.sign(sig).astype(np.int32)
    inv_order = np.argsort(order_int, axis=2).astype(np.int32)
    return expected.astype(np.float32), order_int, inv_order, exp_sign


# ------------------------------------------------------------ device program

def _recover_impl(counts, exp32, inv_order, exp_sign, *, nbits: int):
    """counts (D, S, R) int32; exp32 (D, S, R) f32; inv_order / exp_sign
    (D, S, nbits) int64 / int32, all on one device.  Returns the integer
    decision and vote tensors, all (D, S, ...)-leading."""
    D, S, R = counts.shape
    dev = counts.device
    sums = bit_signature(counts.reshape(D * S, R), nbits=nbits) \
        .reshape(D, S, nbits)

    # greedy strongest-first assignment == composing the two stable magnitude
    # rankings: ext bit of internal bit i is order_ext[rank of i in order_int]
    order_ext = torch.argsort(-torch.abs(sums), dim=2, stable=True)
    ext_bit = torch.gather(order_ext, 2, inv_order)              # (D,S,nbits)

    obs_sign = torch.sign(torch.gather(sums, 2, ext_bit))
    # zero signatures carry no ordering information: xor pinned to 0
    xor = torch.where((obs_sign == 0) | (exp_sign == 0), 0,
                      (obs_sign != exp_sign).to(torch.int32))    # (D,S,nbits)
    ext32 = ext_bit.to(torch.int32)

    # estimated ext->int table from the assignment
    r = torch.arange(R, dtype=torch.int32, device=dev)[None, None, None, :]
    bits = ((r >> ext32[..., None]) & 1) ^ xor[..., None]       # (D,S,nbits,R)
    weights = (1 << torch.arange(nbits, dtype=torch.int32,
                                 device=dev))[None, None, :, None]
    est_int = torch.sum(bits * weights, dim=2, dtype=torch.int32)  # (D, S, R)

    # pair votes: the 2^(n-1) row pairs differing only in each ext bit
    bmask = (1 << ext32)[..., None]                              # (D,S,nbits,1)
    hi = (r | bmask).to(torch.int64)
    lo = (r & ~bmask).to(torch.int64)
    sel = (r & bmask) == 0                                       # each pair once
    shape = hi.shape
    gather = lambda tab, idx: torch.gather(
        tab[:, :, None, :].expand(shape), 3, idx)
    c_hi, c_lo = gather(counts, hi), gather(counts, lo)
    e_hi = gather(exp32, gather(est_int, hi).to(torch.int64))
    e_lo = gather(exp32, gather(est_int, lo).to(torch.int64))
    obs_diff = c_hi - c_lo                                       # exact i32
    exp_diff = e_hi - e_lo                                       # single-op f32
    noise = torch.sqrt((c_hi + c_lo + 1).to(torch.float32))
    signif = (torch.abs(exp_diff) > noise) & sel
    agree = torch.sign(obs_diff).to(torch.float32) == torch.sign(exp_diff)
    n_sig = torch.sum(signif, dim=3, dtype=torch.int32)
    n_agree_sig = torch.sum(agree & signif, dim=3, dtype=torch.int32)
    n_agree_all = torch.sum(agree & sel, dim=3, dtype=torch.int32)
    return ext_bit, xor, n_sig, n_agree_sig, n_agree_all, est_int


# ------------------------------------------------------------- entry points

def recover_mapping_population(counts, expected, *, device=None,
                               mesh: DimmMesh | None = None) -> dict:
    """Recover every (DIMM, subarray) scramble in one program on ``device``
    (default: the CUDA device), or split over ``mesh``'s devices by DIMM.

    ``counts``: (D, S, R) — or (D, R) — INTEGER observed per-external-row
    error counts.  ``expected``: model-expected per-internal-row counts (the
    Sec 3.1 'expected characteristics'): (D, S, R) per subarray, or (D, R) /
    (R,) broadcast over subarrays.

    Returns a dict of numpy arrays: ``ext_bit``/``xor``/``confidence``/
    ``n_significant_pairs`` (D, S, nbits) — internal bit i maps from external
    bit ``ext_bit[..., i]`` with inversion ``xor[..., i]`` at
    ``confidence[..., i]`` (Fig 11) — plus ``est_ext_to_int`` (D, S, R), the
    recovered external->internal row tables, and the expected-side
    ``order_int`` (D, S, nbits) strongest-first rankings (what voting
    walks).  Decisions and confidences are identical to
    ``mapping.estimate_row_mapping`` run per subarray.
    """
    dev = mesh_device(mesh, device)
    counts = np.asarray(counts)
    if counts.dtype.kind not in "biu":
        raise ValueError("recover_mapping_population wants integer error "
                         f"counts; got dtype {counts.dtype}")
    if counts.ndim == 2:
        counts = counts[:, None, :]
    D, S, R = counts.shape
    nbits = _nbits(R)
    expected = _broadcast_expected(expected, D, S, R)
    exp32, order_int, inv_order, exp_sign = _expected_tables(expected, nbits)

    as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                         device=dev)
    args = (as_t(counts, np.int32), as_t(exp32, np.float32),
            as_t(inv_order, np.int64), as_t(exp_sign, np.int32))
    out = _dispatch(mesh, _recover_impl, args, dict(nbits=nbits),
                    (0, 1, 2, 3))
    ext_bit, xor, n_sig, n_agree_sig, n_agree_all = (
        v.cpu().numpy().astype(np.int64) for v in out[:5])
    # confidences from integer vote counts, on the host in float64 — the
    # same two branches (and op order) as the per-subarray reference
    conf = np.where(
        n_sig >= 4,
        n_agree_sig / np.maximum(n_sig, 1),
        0.5 + 0.5 * np.maximum(n_agree_all / (R // 2) - 0.5, 0.0))
    return {"ext_bit": ext_bit, "xor": xor,
            "confidence": conf, "n_significant_pairs": n_sig,
            "est_ext_to_int": out[5].cpu().numpy().astype(np.int64),
            "order_int": order_int.astype(np.int64)}


def recover_mapping_loop(counts, expected) -> dict:
    """The Python reference: ``mapping.estimate_row_mapping`` walked over
    every (DIMM, subarray) profile — same dict layout (sans order_int), same
    bits."""
    counts = np.asarray(counts)
    if counts.ndim == 2:
        counts = counts[:, None, :]
    D, S, R = counts.shape
    nbits = int(np.log2(R))
    expected = _broadcast_expected(expected, D, S, R)
    ext_bit = np.zeros((D, S, nbits), np.int64)
    xor = np.zeros((D, S, nbits), np.int64)
    conf = np.zeros((D, S, nbits), np.float64)
    n_sig = np.zeros((D, S, nbits), np.int64)
    est = np.zeros((D, S, R), np.int64)
    idx = np.arange(R)
    for d in range(D):
        for s in range(S):
            res = estimate_row_mapping(counts[d, s], expected[d, s])
            for r_ in res:
                i = r_["int_bit"]
                ext_bit[d, s, i] = r_["ext_bit"]
                xor[d, s, i] = r_["xor"]
                conf[d, s, i] = r_["confidence"]
                n_sig[d, s, i] = r_["n_significant_pairs"]
                est[d, s] |= ((((idx >> r_["ext_bit"]) & 1) ^ r_["xor"]) << i)
    return {"ext_bit": ext_bit, "xor": xor, "confidence": conf,
            "n_significant_pairs": n_sig, "est_ext_to_int": est}


# ----------------------------------------------------------------- voting

def vote_mapping(ext_bit: np.ndarray, xor: np.ndarray, conf: np.ndarray,
                 order_int: np.ndarray):
    """Confidence-weighted consensus over K recoveries of the SAME design
    (a DIMM's subarrays; a generation's members — the paper's cross-DIMM
    consistency lever).  Internal bits claim external bits greedily in
    expected-strength order, so the result stays a permutation even when
    individual voters disagree; all ties break deterministically (lowest
    external bit; xor=0).

    ``ext_bit``/``xor``/``conf``: (K, nbits); ``order_int``: (nbits,).
    Returns (ext_of_int, xor_of_int) int arrays of shape (nbits,).
    """
    ext_bit = np.asarray(ext_bit)
    xor = np.asarray(xor)
    conf = np.asarray(conf)
    nbits = ext_bit.shape[1]
    out_b = np.zeros(nbits, np.int64)
    out_x = np.zeros(nbits, np.int64)
    used = np.zeros(nbits, bool)
    for i in np.asarray(order_int, np.int64):
        w = np.zeros(nbits)
        w1 = np.zeros(nbits)
        for k in range(ext_bit.shape[0]):
            b = int(ext_bit[k, i])
            if used[b]:
                continue  # a stronger bit already claimed this voter's pick
            w[b] += conf[k, i]
            w1[b] += conf[k, i] * xor[k, i]
        if w.max() > 0:
            b = int(np.argmax(w))          # ties -> lowest external bit
        else:
            b = int(np.argmin(used))       # no votes left: first free bit
        out_b[i] = b
        out_x[i] = int(w1[b] > w[b] - w1[b])   # xor majority; tie -> 0
        used[b] = True
    return out_b, out_x


def mapping_tables(ext_of_int: np.ndarray, xor_of_int: np.ndarray,
                   n_rows: int):
    """(ext_to_int, int_to_ext) row tables from per-internal-bit decisions —
    the same bit fold the reference uses, so a voted mapping can profile."""
    idx = np.arange(n_rows)
    est = np.zeros(n_rows, np.int64)
    for i, (b, x) in enumerate(zip(ext_of_int, xor_of_int)):
        est |= ((((idx >> int(b)) & 1) ^ int(x)) << i)
    return est, np.argsort(est, kind="stable")
