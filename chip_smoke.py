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
     read/write latency reduction beside the paper's 35.1% / 57.8%.

Every phase prints one JSON line.  The launch counts are set to 0 just before
the main path (phases 3-4) and read just after it.  Any failed check raises;
the last line is ``{"ok": true, "device": {...}}`` only when all passed.
Exits non-zero, printing no result, when no CUDA device is available.
"""
from __future__ import annotations

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
from repro_torch.core.substrate import (  # noqa: E402
    DimmBatch, _geom_consts, _pack_coeffs, condition_adders,
    profile_population_arrays, row_error_lambda)
from repro_torch.core.timing import TimingParams  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.fail_prob import fail_prob, fail_prob_ref  # noqa: E402

N_DIMMS = 96
N_CONVENTIONAL = 8
PAPER_READ, PAPER_WRITE = 0.351, 0.578   # Sec 6.1 / Fig 18 (quickstart.py)
KERNEL_ATOL = 1e-6   # tests/test_fail_prob_substrate.py's kernel-vs-oracle bound
LAMBDA_RTOL = 1e-5
# H100 SXM (NVIDIA's data sheet): HBM3 rate, fp32 rate outside the tensor cores
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS = 3.35e12, 67e12
FAIL_PROB_FLOPS_PER_CELL = 61   # counted from csrc/fail_prob.cu (exp = 1 op)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card over ``reps`` runs (CUDA
    events), after one warm-up run."""
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
    launches = ops.launch_counts()
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

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

    print(json.dumps({"kernels": [{
        "name": "fail_prob", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fail_prob.cu",
        "replaces": "src/repro/kernels/fail_prob.py:114",
        "launches": launches["fail_prob"],
        "max_abs_err": max(err_main, err_closed, err_ragged),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
