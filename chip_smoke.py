"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

At the paper's scale — ``make_population(FULL, 96)``: 96 DIMMs (768 chips)
of 512x512 mats, 16 mats and 8 subarrays — it

  1. prints the card (nvidia-smi name and power limit) and builds every CUDA
     kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
     started together);
  2. holds each kernel against its plain PyTorch version on the card at the
     main path's shapes, a ragged shape and ``open_bitline=False``
     (max |kernel - plain| <= 1e-6), and times both;
  3. characterizes the population (``row_error_lambda``, tRP at 7.5 ns; one
     kernel launch per subarray and pattern) and holds the first 4 DIMMs
     against the port run on the CPU (rtol 1e-5: the card sums in another
     order);
  4. DIVA-profiles all 96 DIMMs and conventionally profiles 8 (at 96 its
     eager temporaries would be ~6.4 GB each), holds the DIVA tables of the
     first 8 DIMMs against the CPU port (identical), and prints the mean
     read/write latency reduction beside the paper's 35.1% / 57.8%;
  5. holds the SECDED encode / syndrome and shuffle kernels against their
     plain versions (``torch.equal``) on seeded 0/1 bits at the DIVA
     Shuffling path's shapes — syndrome (3,072,000, 72), encode (8,388,608,
     64), shuffle (192,000, 576) for the DIVA, unshuffled, inverse and codec
     permutations — and at ragged N in {1, 1000003}, and times kernel, plain
     version and, for the shuffle, ``torch.index_select``;
  6. runs Fig 17 on the profiled population: burst-bit profiles of the 96
     DIMMs (8 ``fail_prob`` launches), then the SECDED outcome with and
     without DIVA Shuffling over 2000 accesses each (2 ``diva_shuffle`` + 1
     ``secded_syndrome`` launches); holds the profiles of 2 DIMMs against the
     CPU port (rtol 1e-5) and the counts of 8 DIMMs against the CPU port fed
     the card's profiles (identical);
  7. runs Fig 17 on the synthetic stripe profiles of the ``fig17_shuffling``
     figure (72 DIMMs, 400 accesses): counts identical to the CPU port's;
  8. protects a 64 MiB blob with the codec, flips 1,000 8-bit runs, recovers
     it: the data must come back exactly with every flipped bit corrected,
     and the first 1 MiB's lanes must equal the CPU port's;
  9. the Fig 19 memory system: holds the ``bank_sched`` walk kernel against
     its plain walk (``torch.equal`` on latency and hit in service order) on
     base + the 96 DIVA tables x 12 workloads at n = 2,000 for four
     configurations, and at n = 1, 5 and Q = 32; times it at n = 20,000;
     then drives Fig 19 at n = 20,000 — FR-FCFS on the whole-DIMM tables,
     FR-FCFS on 4-bank-group tables profiled from the same 96 DIMMs, the
     in-order walker on the whole-DIMM tables, and the in-order grid behind
     ``speedup_summary`` at 1/2/4/8 cores (4 ``bank_sched`` launches) — and
     holds the integer totals of base + 8 whole-DIMM and base + 4 per-bank
     tables, and the in-order grid, against the port run on the CPU.

Every phase prints one JSON line.  The launch counts are set to 0 just before
each path (phases 3-4, 6, 7, 8 and 9) and read just after it; every kernel of
a path must have launched, and the ``kernels`` line sums the paths' counts.
Any failed check raises; the last line is ``{"ok": true, "device": {...}}``
only when all passed.  Exits non-zero, printing no result, when no CUDA
device is available.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.geometry import FULL  # noqa: E402
from repro_torch.core.latency import PATTERN_STRESS  # noqa: E402
from repro_torch.core.population import make_population  # noqa: E402
from repro_torch.core.profiling import latency_reduction  # noqa: E402
from repro_torch.core.shuffling import design_stripe_profiles  # noqa: E402
from repro_torch.core.substrate import (  # noqa: E402
    DimmBatch, _geom_consts, _pack_coeffs, burst_bit_profile_population,
    condition_adders, profile_population_arrays, row_error_lambda,
    shuffling_gain_population)
from repro_torch.core.timing import TimingParams  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.bank_sched import memsim_walk, memsim_walk_ref  # noqa: E402
from repro_torch.kernels.fail_prob import fail_prob, fail_prob_ref  # noqa: E402
from repro_torch.kernels.secded import (  # noqa: E402
    encode_checks, encode_checks_ref, syndrome, syndrome_ref)
from repro_torch.kernels.shuffle import (  # noqa: E402
    _perm_tensor, apply_shuffle, apply_shuffle_ref, shuffle_permutation)
from repro_torch.memsim import sim as memsim  # noqa: E402
from repro_torch.memsys.codec import (  # noqa: E402
    corrupt_run, interleave_permutation, protect_blob, recover_blob)

N_DIMMS = 96
N_CONVENTIONAL = 8
PAPER_READ, PAPER_WRITE = 0.351, 0.578   # Sec 6.1 / Fig 18 (quickstart.py)
KERNEL_ATOL = 1e-6   # tests/test_fail_prob_substrate.py's kernel-vs-oracle bound
LAMBDA_RTOL = 1e-5
# H100 SXM (NVIDIA's data sheet): HBM3 rate, fp32 rate outside the tensor
# cores; int32 rate: 64 int32 lanes per SM per clock x 132 SMs x 1.98 GHz
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, PEAK_INT32_OPS = 3.35e12, 67e12, 16.7e12
FAIL_PROB_FLOPS_PER_CELL = 61   # counted from csrc/fail_prob.cu (exp = 1 op)
# DIVA Shuffling path (Fig 17) and codec
N_ACCESSES = 2000                 # accesses per DIMM, profiled population
PROB_RTOL, PROB_ATOL = 1e-5, 1e-7
N_COUNT_CHECK = 8                 # DIMMs whose counts the CPU port re-derives
PAPER_GAIN, PAPER_RECOVERED = 0.26, 0.925   # benchmarks/paper_figures.py:285,308
SYN_ROWS = 2 * N_DIMMS * N_ACCESSES * 8     # both layouts' codewords: 3,072,000
SHUFFLE_ROWS = N_DIMMS * N_ACCESSES         # bursts per shuffle: 192,000
BLOB_BYTES = 64 << 20             # a checkpoint leaf (checkpoint/manager.py:87)
ENCODE_ROWS = BLOB_BYTES // 8               # its codewords: 8,388,608
CHECK_BYTES = 1 << 20             # prefix whose lanes the CPU port re-derives
N_RUNS, RUN_BITS = 1000, 8
RAGGED = (1, 1000003)
# Fig 19 memory system (memsim)
MEMSIM_N = 20000                  # requests per workload trace (the default)
MEMSIM_PLAIN_N = 2000             # n of the kernel-vs-plain checks and plain time
MEMSIM_CPU_DIMMS, MEMSIM_CPU_BANK_DIMMS = 8, 4   # re-derived on the CPU
PAPER_SPEEDUP = {1: 0.092, 2: 0.147, 4: 0.137, 8: 0.138}   # Sec 6.3, Fig 19
# int32 operations counted from csrc/bank_sched.cu with the bus and the
# activation window on: per queued candidate (21 + 5 for tRRD/tFAW + 2 for the
# bus) and per step (the winner's reductions, the state update, output, refill)
BANK_SCHED_CANDIDATE_OPS, BANK_SCHED_STEP_OPS = 28, 48


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Median milliseconds of ``fn`` on the card over ``reps`` runs (CUDA
    events), after one warm-up run unless the caller has just run it."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(row_src, d_mat, coeffs, cols, open_bitline=True) -> float:
    k = fail_prob(row_src, d_mat, coeffs, cols=cols, open_bitline=open_bitline)
    r = fail_prob_ref(row_src, d_mat, coeffs, cols=cols,
                      open_bitline=open_bitline)
    torch.cuda.synchronize()
    if k.shape != r.shape or not torch.isfinite(k).all():
        raise AssertionError(f"kernel output {tuple(k.shape)} not finite or "
                             f"not of shape {tuple(r.shape)}")
    err = float((k - r).abs().max())
    if err > KERNEL_ATOL:
        raise AssertionError(f"fail_prob differs from fail_prob_ref by {err} "
                             f"at {tuple(k.shape)}, open_bitline={open_bitline}")
    return err


def bits(rows: int, width: int, dev, seed: int) -> torch.Tensor:
    """Seeded 0/1 int32 (rows, width) on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 2, (rows, width), generator=gen, device=dev,
                         dtype=torch.int32)


def exact(kernel_fn, plain_fn, x, what: str) -> float:
    """Kernel against its plain version on ``x``: equal bit for bit, or
    raise.  Returns max |kernel - plain| (0.0)."""
    k, r = kernel_fn(x), plain_fn(x)
    torch.cuda.synchronize()
    if k.shape != r.shape or not torch.equal(k, r):
        raise AssertionError(f"{what} differs from its plain version at "
                             f"{tuple(x.shape)}")
    return float((k - r).abs().max()) if k.numel() else 0.0


def int_kernels_vs_plain(dev) -> dict:
    """Phase 5: the three integer kernels against their plain versions at
    the Fig 17 / codec shapes and ragged N; times of kernel, plain version
    and library call.  Returns {kernel name: its ``kernels``-line fields}."""
    bw, flops = PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
    out = {}
    for name, kern, plain, rows, width in (
            ("secded_syndrome", syndrome, syndrome_ref, SYN_ROWS, 72),
            ("secded_encode", encode_checks, encode_checks_ref, ENCODE_ROWS, 64)):
        x = bits(rows, width, dev, seed=width)
        err = exact(kern, plain, x, name)
        for n in RAGGED:
            exact(kern, plain, bits(n, width, dev, seed=n), name)
        n_bytes = rows * width * 4 + rows * 8 * 4
        n_ops = rows * width * 8 * 2   # the (N, W) @ (W, 8) product it replaces
        fields = dict(ms=cuda_ms(lambda: kern(x), 20),
                      plain_ms=cuda_ms(lambda: plain(x), 20),
                      bytes_ms=n_bytes / bw * 1e3, ops_ms=n_ops / flops * 1e3,
                      library_ms=None, max_abs_err=err)
        emit("kernel_vs_plain", kernel=name, shape=[rows, width],
             ragged=list(RAGGED), equal=True, bytes=n_bytes, operations=n_ops,
             **fields)
        out[name] = fields
        del x

    x = bits(SHUFFLE_ROWS, 576, dev, seed=576)
    perms = {"diva": dict(shuffle=True), "unshuffled": dict(shuffle=False),
             "diva_inverse": dict(shuffle=True, inverse=True),
             "codec": dict(perm=interleave_permutation()),
             "codec_inverse": dict(perm=interleave_permutation(), inverse=True)}
    err = 0.0
    for label, kw in perms.items():
        perm = kw.get("perm", shuffle_permutation(kw.get("shuffle", True)))
        index = _perm_tensor(np.asarray(perm, np.int32).tobytes(),
                             kw.get("inverse", False), x.device)
        plain = lambda t, index=index: apply_shuffle_ref(t, index)
        kern = lambda t, kw=kw: apply_shuffle(t, **kw)
        err = max(err, exact(kern, plain, x, f"diva_shuffle ({label})"))
        for n in RAGGED:
            exact(kern, plain, bits(n, 576, dev, seed=n), f"diva_shuffle ({label})")
    index = _perm_tensor(shuffle_permutation(True).tobytes(), False, x.device)
    n_bytes = 2 * SHUFFLE_ROWS * 576 * 4
    fields = dict(ms=cuda_ms(lambda: apply_shuffle(x, shuffle=True), 20),
                  plain_ms=cuda_ms(lambda: apply_shuffle_ref(x, index), 20),
                  library_ms=cuda_ms(lambda: torch.index_select(x, 1, index), 20),
                  bytes_ms=n_bytes / bw * 1e3, ops_ms=0.0, max_abs_err=err)
    emit("kernel_vs_plain", kernel="diva_shuffle", shape=[SHUFFLE_ROWS, 576],
         permutations=sorted(perms), ragged=list(RAGGED), equal=True,
         bytes=n_bytes, operations=0, **fields)
    out["diva_shuffle"] = fields
    return out


def counted(expected: dict) -> dict:
    """Launch counts since the last reset; raise unless each kernel in
    ``expected`` launched exactly that often and no other kernel did."""
    got = ops.launch_counts()
    want = {name: expected.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    return got


def summary(gain: dict) -> dict:
    """Fig 17 means over the DIMMs that saw errors."""
    active = gain["total"] > 0
    mean = lambda k: float(np.mean(gain[k][active])) if active.any() else 0.0
    unc_ns = int(gain["uncorrectable_no_shuffle"].sum())
    unc_s = int(gain["uncorrectable_shuffle"].sum())
    return dict(dimms_with_errors=int(active.sum()),
                mean_gain=mean("gain"),
                mean_frac_no_shuffle=mean("frac_no_shuffle"),
                mean_frac_shuffle=mean("frac_shuffle"),
                errors=int(gain["total"].sum()),
                uncorrectable_words_no_shuffle=unc_ns,
                uncorrectable_words_shuffle=unc_s,
                uncorrectable_words_recovered=(1 - unc_s / unc_ns) if unc_ns else None,
                undetected_words_no_shuffle=int(gain["undetected_no_shuffle"].sum()),
                undetected_words_shuffle=int(gain["undetected_shuffle"].sum()),
                paper_gain=PAPER_GAIN, paper_recovered=PAPER_RECOVERED)


def same_counts(got: dict, want: dict, what: str) -> None:
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs on the card and the CPU")


def fig17_profiled(batch, pop) -> dict:
    """Phase 6: Fig 17 on the profiled population; returns its launches."""
    g = batch.geom
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = burst_bit_profile_population(batch, "trp", 7.5, refresh_ms=256.0)
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gain = shuffling_gain_population(probs, seeds=batch.serial,
                                     n_accesses=N_ACCESSES, device=batch.device)
    gain_s = time.perf_counter() - t0
    launches = counted({"fail_prob": g.chips, "diva_shuffle": 2,
                        "secded_syndrome": 1})
    if probs.shape != (batch.n_dimms, 9, 64) or not np.isfinite(probs).all():
        raise AssertionError(f"burst-bit profiles {probs.shape}, non-finite?")
    probs_cpu = burst_bit_profile_population(
        DimmBatch.from_population(pop[:2], "cpu"), "trp", 7.5, refresh_ms=256.0)
    np.testing.assert_allclose(probs[:2], probs_cpu, rtol=PROB_RTOL,
                               atol=PROB_ATOL)
    prob_rel = float(np.max(np.abs(probs[:2] - probs_cpu)
                            / np.maximum(np.abs(probs_cpu), 1e-30)))
    k = N_COUNT_CHECK
    gain_cpu = shuffling_gain_population(
        probs[:k], seeds=batch.serial[:k].cpu(), n_accesses=N_ACCESSES,
        device="cpu")
    same_counts({key: v[:k] for key, v in gain.items()}, gain_cpu,
                "Fig 17 (profiled)")
    emit("fig17_profiled", dimms=batch.n_dimms, param="trp", t_op=7.5,
         refresh_ms=256.0, n_accesses=N_ACCESSES, profile_seconds=profile_s,
         shuffling_seconds=gain_s, launches=launches,
         probs_mean=float(probs.mean()), probs_max=float(probs.max()),
         probs_cpu_dimms=2, probs_max_rel_err_vs_cpu=prob_rel,
         probs_rtol=PROB_RTOL, probs_atol=PROB_ATOL,
         counts_equal_cpu_dimms=k, **summary(gain))
    return launches


def fig17_synthetic(dev) -> dict:
    """Phase 7: the fig17_shuffling configuration; returns its launches."""
    probs = design_stripe_profiles(72, seed=7)
    seeds = np.arange(72)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gain = shuffling_gain_population(probs, seeds=seeds, n_accesses=400,
                                     device=dev)
    gain_s = time.perf_counter() - t0
    launches = counted({"diva_shuffle": 2, "secded_syndrome": 1})
    gain_cpu = shuffling_gain_population(probs, seeds=seeds, n_accesses=400,
                                         device="cpu")
    same_counts(gain, gain_cpu, "Fig 17 (synthetic)")
    emit("fig17_synthetic", dimms=72, n_accesses=400, seconds=gain_s,
         launches=launches, counts_equal_cpu_dimms=72, **summary(gain))
    return launches


def codec_blob(dev) -> dict:
    """Phase 8: the codec on a 64 MiB blob; returns its launches."""
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, BLOB_BYTES, dtype=np.uint8).tobytes()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = protect_blob(data, device=dev)
    protect_s = time.perf_counter() - t0
    bursts = rng.choice(lanes.shape[0], N_RUNS, replace=False)
    starts = rng.integers(0, lanes.shape[1], N_RUNS)
    bad = lanes.copy()
    for b, s in zip(bursts, starts):
        bad[b:b + 1] = corrupt_run(bad[b:b + 1], burst=0, start_lane=int(s),
                                   n_bits=RUN_BITS)
    # interleaved: each run puts one error into each of up to 8 codewords
    flipped = int(np.minimum(RUN_BITS, lanes.shape[1] - starts).sum())
    t0 = time.perf_counter()
    out, stats = recover_blob(bad, len(data), device=dev)
    recover_s = time.perf_counter() - t0
    launches = counted({"secded_encode": 1, "diva_shuffle": 2,
                        "secded_syndrome": 1})
    if out != data:
        raise AssertionError("the codec did not give the 64 MiB blob back")
    if stats.corrected != flipped or stats.uncorrectable:
        raise AssertionError(f"codec stats {stats}, expected {flipped} "
                             f"corrected and 0 uncorrectable")
    head = CHECK_BYTES // 64
    if not np.array_equal(lanes[:head], protect_blob(data[:CHECK_BYTES],
                                                     device="cpu")):
        raise AssertionError("codec lanes differ on the card and the CPU")
    emit("codec", blob_bytes=BLOB_BYTES, bursts=int(lanes.shape[0]),
         codewords=stats.codewords, runs=N_RUNS, run_bits=RUN_BITS,
         corrected=stats.corrected, uncorrectable=stats.uncorrectable,
         protect_seconds=protect_s, recover_seconds=recover_s,
         launches=launches, lanes_equal_cpu_bytes=CHECK_BYTES)
    return launches


def walk_vs_plain(traces, tc, cfg, what: str) -> float:
    """The bank_sched kernel against the plain walk: equal, or raise.
    Returns max |kernel - plain| over latency and hit (0.0)."""
    kw = memsim._walk_kw(cfg)
    got, want = memsim_walk(traces, tc, **kw), memsim_walk_ref(traces, tc, **kw)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("latency", "hit")):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"bank_sched {name} differs from the plain "
                                 f"walk ({what}, {tuple(traces.shape)})")
    return max(float((g - w).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def memsim_phase(dev, batch, diva) -> tuple[dict, dict]:
    """Phase 9: the Fig 19 memory system; returns (its launches, the
    bank_sched ``kernels``-line fields)."""
    cfgs = {"default": memsim.MemSimConfig(),
            "one_channel_one_rank": memsim.MemSimConfig(channels=1, ranks=1),
            "queue4_no_bus": memsim.MemSimConfig(queue=4, bus=False),
            "inorder": memsim.inorder_config(16)}
    base = memsim.STANDARD
    tc = torch.as_tensor(np.stack([memsim.timing_cycles_banks(t, 16)
                                   for t in [base, *diva]]), device=dev)
    traces = memsim._stack_traces(MEMSIM_PLAIN_N, 16, 0, dev)
    err = max(walk_vs_plain(traces, tc, cfg, name)
              for name, cfg in cfgs.items())
    kw = memsim._walk_kw(cfgs["default"])
    plain_ms = cuda_ms(lambda: memsim_walk_ref(traces, tc, **kw), 3,
                       warm_up=False)                  # warmed by the check
    kernel_ms_plain_n = cuda_ms(lambda: memsim_walk(traces, tc, **kw), 20)
    for n in (1, 5):
        err = max(err, walk_vs_plain(memsim._stack_traces(n, 16, 0, dev), tc,
                                     cfgs["default"], f"n = {n}"))
    err = max(err, walk_vs_plain(memsim._stack_traces(500, 16, 0, dev), tc,
                                 memsim.MemSimConfig(queue=32), "Q = 32"))
    full = memsim._stack_traces(MEMSIM_N, 16, 0, dev)
    ms = cuda_ms(lambda: memsim_walk(full, tc, **kw), 20)
    T, W = tc.shape[0], full.shape[0]
    Q = cfgs["default"].queue
    n_ops = T * W * MEMSIM_N * (Q * BANK_SCHED_CANDIDATE_OPS
                                + BANK_SCHED_STEP_OPS)
    n_bytes = full.numel() * 4 + tc.numel() * 4 + T * W * MEMSIM_N * 8
    fields = dict(ms=ms, plain_ms=plain_ms, bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
                  ops_ms=n_ops / PEAK_INT32_OPS * 1e3, library_ms=None,
                  max_abs_err=err)
    emit("kernel_vs_plain", kernel="bank_sched", grid=[T, W],
         configurations=sorted(cfgs), n=MEMSIM_PLAIN_N, ragged_n=[1, 5],
         ragged_queue=32, equal=True, kernel_n=MEMSIM_N,
         kernel_ms_at_plain_n=kernel_ms_plain_n, plain_n=MEMSIM_PLAIN_N,
         bytes=n_bytes, operations=n_ops, peak_int32_ops=PEAK_INT32_OPS,
         **fields)

    # ---- the Fig 19 path, counted
    ops.reset_launches()
    torch.cuda.synchronize()
    secs = {}
    t0 = time.perf_counter()
    whole = memsim.system_speedup_population(diva, n_requests=MEMSIM_N,
                                             device=dev)
    secs["frfcfs_whole"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pb = profile_population_arrays(batch, banks=4, multibit_only=True)
    secs["profile_banks4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_bank = memsim.system_speedup_population(pb, n_requests=MEMSIM_N,
                                                device=dev)
    secs["frfcfs_per_bank"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inorder = memsim.system_speedup_population(
        diva, n_requests=MEMSIM_N, scheduler="inorder", device=dev)
    secs["inorder_whole"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ipcs = memsim.evaluate_system_grid([base, diva[0]], n_requests=MEMSIM_N,
                                       device=dev)
    cores = {c: memsim.speedup_summary(TimingParams(*map(float, diva[0])),
                                       base, cores=c, ipcs=ipcs)
             for c in PAPER_SPEEDUP}
    secs["inorder_summary"] = time.perf_counter() - t0
    launches = counted({"bank_sched": 4})

    # ---- checks against the port on the CPU
    D = len(diva)
    for name, res in (("whole", whole), ("per_bank", per_bank),
                      ("inorder", inorder)):
        sp = res["per_dimm_speedup"]
        if sp.shape != (D,) or not np.isfinite(sp).all() \
                or res["total_latency_cycles"].shape != (D + 1, W):
            raise AssertionError(f"Fig 19 {name}: speedups {sp.shape}, "
                                 f"non-finite?")
    if pb.shape != (D, 4, 4) or not np.array_equal(pb.max(axis=1), diva):
        raise AssertionError("per-bank tables are not (D, 4, 4) with the "
                             "whole-DIMM tables as their envelope")
    k, kb = min(MEMSIM_CPU_DIMMS, D), min(MEMSIM_CPU_BANK_DIMMS, D)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the plain walk's tiny ops run best on one
    t0 = time.perf_counter()
    cpu = memsim._grid_totals([base, *diva[:k], *pb[:kb]],
                              memsim.MemSimConfig(), MEMSIM_N, 0, "cpu")
    cpu_ipcs = memsim.evaluate_system_grid([base, diva[0]],
                                           n_requests=MEMSIM_N, device="cpu")
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    if not (np.array_equal(whole["total_latency_cycles"][:k + 1], cpu[:k + 1])
            and np.array_equal(per_bank["total_latency_cycles"][0], cpu[0])
            and np.array_equal(per_bank["total_latency_cycles"][1:kb + 1],
                               cpu[k + 1:])
            and np.array_equal(ipcs, cpu_ipcs)):
        raise AssertionError("Fig 19 latency totals differ on the card and "
                             "the CPU")
    # speedups are scored on the host from the totals: identical to the CPU's
    if not np.array_equal(memsim._speedups(cpu[:k + 1], MEMSIM_N)
                          ["per_dimm_workload_speedup"],
                          whole["per_dimm_workload_speedup"][:k]):
        raise AssertionError("Fig 19 speedups differ on the card and the CPU")
    slack = int((pb < diva[:, None, :]).any(axis=(1, 2)).sum())
    stat = lambda res: {key: res[key] for key in (
        "mean_speedup", "median_speedup", "min_speedup", "max_speedup")}
    emit("fig19_memsim", dimms=D, workloads=W, n_requests=MEMSIM_N,
         config=dataclasses.asdict(cfgs["default"]),
         seconds=secs, launches=launches,
         frfcfs_whole=stat(whole), frfcfs_per_bank=stat(per_bank),
         inorder_whole=stat(inorder),
         per_bank_dimms_with_bank_slack=slack,
         per_bank_at_least_whole_dimms=int(
             (per_bank["per_dimm_speedup"] >= whole["per_dimm_speedup"]).sum()),
         inorder_summary_table=diva[0].tolist(),
         speedup_by_cores={c: (s["mean_singlecore_speedup"] if c == 1
                               else s["mean_weighted_speedup"]) - 1.0
                           for c, s in cores.items()},
         paper_speedup_by_cores=PAPER_SPEEDUP,
         totals_equal_cpu=dict(whole_tables=1 + k, per_bank_tables=1 + kb,
                               inorder_grid=2),
         speedups_equal_cpu_dimms=k, cpu_check_seconds=cpu_s)
    return launches, fields


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    emit("card", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, built=sorted(logs))

    # ---- 2. kernel against its plain version at the main path's shapes
    pop = make_population(FULL, N_DIMMS)
    batch = DimmBatch.from_population(pop, dev)
    g = batch.geom
    adder = torch.as_tensor(condition_adders(batch, 85.0, 64.0), device=dev)
    coeffs = _pack_coeffs(batch, 2, 7.5, PATTERN_STRESS["0101"], adder, 0, 0)
    row_src = batch.row_src[:, 0].contiguous()
    d_mat = torch.as_tensor(_geom_consts(g)[1], device=dev)
    C = g.cols_per_mat
    err_main = max_abs_err(row_src, d_mat, coeffs, C)
    err_closed = max_abs_err(row_src, d_mat, coeffs, C, open_bitline=False)
    rng = np.random.default_rng(0)
    rag_rows = torch.as_tensor(rng.integers(0, 100, (3, 100)), dtype=torch.int32,
                               device=dev)
    rag_cf = torch.as_tensor(
        np.array([3.9, 2.1, 0.4, 0.8, 0.4, 7.5, 0.15, 3e-6, 3.5], np.float32)
        + (rng.normal(0, 0.05, (3, 9)) * (np.arange(9) < 6)).astype(np.float32),
        device=dev)
    err_ragged = max_abs_err(rag_rows, d_mat[:5], rag_cf, 96)
    kernel_ms = cuda_ms(lambda: fail_prob(row_src, d_mat, coeffs, cols=C), 20)
    plain_ms = cuda_ms(lambda: fail_prob_ref(row_src, d_mat, coeffs, cols=C), 5)
    D, M, R = batch.n_dimms, g.mats_x, g.rows_per_mat
    cells = D * M * R * C
    n_bytes = row_src.numel() * 4 + d_mat.numel() * 4 + coeffs.numel() * 4 \
        + cells * 4
    bw, flops = PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
    bytes_ms, ops_ms = n_bytes / bw * 1e3, cells * FAIL_PROB_FLOPS_PER_CELL / flops * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit("kernel_vs_plain", kernel="fail_prob", shape=[D, M, R, C],
         max_abs_err=err_main, max_abs_err_closed_bitline=err_closed,
         max_abs_err_ragged=err_ragged, ragged_shape=[3, 5, 100, 96],
         atol=KERNEL_ATOL, kernel_ms=kernel_ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
         bytes=n_bytes, flops=cells * FAIL_PROB_FLOPS_PER_CELL,
         peak_bytes_per_s=bw, peak_fp32_flops=flops,
         comparison_launches=fail_prob.launches)

    # ---- 3-4. the main path, counted
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam = row_error_lambda(batch, "trp", 7.5)
    char_s = time.perf_counter() - t0
    char_launches = ops.launch_counts()["fail_prob"]
    expected = g.subarrays * 4
    if char_launches != expected:
        raise AssertionError(f"row_error_lambda launched fail_prob "
                             f"{char_launches} times, expected {expected}")
    t0 = time.perf_counter()
    diva = profile_population_arrays(batch, region="worst", multibit_only=True)
    diva_s = time.perf_counter() - t0
    conv_batch = DimmBatch.from_population(pop[:N_CONVENTIONAL], dev)
    t0 = time.perf_counter()
    conv = profile_population_arrays(conv_batch, region="all")
    conv_s = time.perf_counter() - t0
    launches = counted({"fail_prob": expected})   # the sweep runs no kernel

    # ---- checks against the port on the CPU
    if lam.shape != (D, g.subarrays * R) or not np.isfinite(lam).all():
        raise AssertionError(f"row_error_lambda gave {lam.shape}, non-finite?")
    lam_cpu = row_error_lambda(DimmBatch.from_population(pop[:4], "cpu"),
                               "trp", 7.5)
    np.testing.assert_allclose(lam[:4], lam_cpu, rtol=LAMBDA_RTOL, atol=1e-6)
    lam_rel = float(np.max(np.abs(lam[:4] - lam_cpu)
                           / np.maximum(np.abs(lam_cpu), 1e-30)))
    emit("characterization", dimms=D, param="trp", t_op=7.5, seconds=char_s,
         launches=char_launches, lam_shape=list(lam.shape),
         lam_total=float(lam.sum()), cpu_dimms=4, max_rel_err_vs_cpu=lam_rel,
         rtol=LAMBDA_RTOL)

    diva_cpu = profile_population_arrays(
        DimmBatch.from_population(pop[:8], "cpu"), region="worst",
        multibit_only=True)
    if not np.array_equal(diva[:8], diva_cpu):
        raise AssertionError(f"DIVA tables differ on the card and the CPU:\n"
                             f"{diva[:8]}\n{diva_cpu}")

    def mean_reduction(tables):
        lr = [latency_reduction(TimingParams(*map(float, row))) for row in tables]
        return (float(np.mean([x["read_reduction"] for x in lr])),
                float(np.mean([x["write_reduction"] for x in lr])))

    d_read, d_write = mean_reduction(diva)
    c_read, c_write = mean_reduction(conv)
    emit("profiling", diva_dimms=D, diva_seconds=diva_s,
         conventional_dimms=N_CONVENTIONAL, conventional_seconds=conv_s,
         diva_equal_cpu_dimms=8,
         diva_mean_read_reduction=d_read, diva_mean_write_reduction=d_write,
         conventional_mean_read_reduction=c_read,
         conventional_mean_write_reduction=c_write,
         paper_read_reduction=PAPER_READ, paper_write_reduction=PAPER_WRITE,
         diva_first_tables=diva[:4].tolist())

    # ---- 5-8. the DIVA Shuffling path and the codec, each counted
    ints = int_kernels_vs_plain(dev)
    paths = [launches, fig17_profiled(batch, pop), fig17_synthetic(dev),
             codec_blob(dev)]

    # ---- 9. the Fig 19 memory system, counted
    memsim_launches, ints["bank_sched"] = memsim_phase(dev, batch, diva)
    paths.append(memsim_launches)
    total = {name: sum(p[name] for p in paths) for name in ops.KERNELS}

    rows = [dict(name="fail_prob",
                 source="src/repro_torch/kernels/csrc/fail_prob.cu",
                 replaces="src/repro/kernels/fail_prob.py:114",
                 max_abs_err=max(err_main, err_closed, err_ragged),
                 ms=kernel_ms, plain_ms=plain_ms, bytes_ms=bytes_ms,
                 ops_ms=ops_ms, library_ms=None)]
    for name, source, replaces in (
            ("secded_encode", "secded.cu", "secded.py:56"),
            ("secded_syndrome", "secded.cu", "secded.py:73"),
            ("diva_shuffle", "shuffle.cu", "shuffle.py:64"),
            ("bank_sched", "bank_sched.cu", "bank_sched.py:138")):
        rows.append(dict(name=name,
                         source=f"src/repro_torch/kernels/csrc/{source}",
                         replaces=f"src/repro/kernels/{replaces}", **ints[name]))
    print(json.dumps({"kernels": [{
        "name": r["name"], "route": "cuda", "source": r["source"],
        "replaces": r["replaces"], "launches": total[r["name"]],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
        "library_ms": r["library_ms"]} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
