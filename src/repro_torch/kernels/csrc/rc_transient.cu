// RC-ladder transient integrator of the Appendix B circuit model, for Hopper.
//
// rc_transient_launch replaces the Pallas TPU kernel
// repro/kernels/rc_transient.py::rc_transient (pl.pallas_call at :101).  For
// (N,) cells at normalized bitline distance row_frac and wordline distance
// col_frac it runs every explicit Euler step of core/spice.py's ladder (an
// n_seg-node RC line with the sense amplifier at node 0 and the cell at the
// tap of its row) and writes, per cell, the bitline at the tap and the cell
// after the last step and the first step time at which the tap reached
// v_ready (+inf if it never did).
//
// Per step (repro/core/spice.py:85-111, in its float32 operation order):
//   dv[j]  = ((v[j-1] - 2*v[j]) + v[j+1]) / tau_seg        (reflecting ends)
//   while t < t_pre:  w = 1 / (1 + expf(-((t - t_wl) / 0.3)))   (torch's sigmoid)
//                     dv_cell = (w * (v[tap] - v_cell)) / tau_acc_cell
//                     dv[tap] += (w * (v_cell - v[tap])) / tau_acc_node
//   sa_enable <= t < t_pre: dv[0] += sa_gain * tanhf((v[0] - v_half) * 25)
//   t >= t_pre:       dv[0] += (v_half - v[0]) / tau_pre
//   v = clamp(v + dv*dt, 0, vdd); v_cell likewise while the wordline is open
// with t = float(i) * dt compared in float32.  The TPU kernel's one-hot
// products (sum(v * tap_oh), tap_oh * x) are an indexed read and update of
// the tap here: the other terms are exact zeros added to a finite value, so
// the bits are the same.  A phase that is off adds an exact zero in the
// reference and is skipped.
//
// Bound: HBM sees one read of the two inputs and one write of the three
// outputs, 20 bytes a cell (5.2 MB for a 512x512 mat, 1.6 us at an H100
// SXM's 3.35 TB/s).  The work is float32 arithmetic: per step and cell
// 8*n_seg + 3 operations (the ladder, its update and clamp, the step time,
// the crossing test), + 17 while the wordline is open (sigmoid with its
// expf and two divisions, the two coupling terms, the cell's update), + 5
// while the sense amp is on (tanhf), + 3 while precharging -- each division
// and transcendental counted as one operation.  At n_seg = 8, 4500 steps
// and t_pre 30 ns that is 371,250 a cell, 1.45 ms for a mat at 67 TFLOP/s:
// the kernel is bound by operations, and by the instructions it issues for
// them.
//
// Design: one thread owns one cell, and the whole time loop runs inside the
// kernel with the n_seg ladder voltages, the cell voltage and the crossing
// time in registers (n_seg is a template parameter, so the ladder unrolls
// into registers).  No shared memory and no synchronisation: cells are
// independent, and a warp is 32 consecutive cells in any block, so the
// block's size (kThreads) changes no cell's operations.  What cuts the
// issued instructions a step:
// - Divisions.  Every divisor but the sigmoid's is a constant of the launch
//   (tau_seg, wl_slope, tau_acc_cell, tau_acc_node, tau_pre): its refined
//   reciprocal is computed once and each division is div_fast's three fmas
//   (fast_div.cuh), with the sign of a zero numerator put back (+-0 / d is
//   +-0 for d > 0); the sigmoid's 1 / (1 + e) is recip.  Those are IEEE
//   division's own instructions, and give its bits, inside ranges that
//   rc_transient_div_check proves on the card operand by operand.  Each
//   thread keeps the least nonzero |numerator| it divided (as bits, two
//   integer instructions a division); a cell whose least one fell below
//   2^-100, or whose wordline delay could drive 1 + e past 2^60, is run
//   again with IEEE divisions and counted.  The numerators' upper bound
//   holds by construction (the voltages are clamped to [0, vdd]; the wrapper
//   checks vdd, v_half and the run's last step time, and launches with the
//   fast route off otherwise).
// - The tap.  Where the 32 cells of a warp share a tap (a sense map's row,
//   cells in row-major order), the warp runs a loop instantiated for that
//   tap, which reads and updates v[tap] as a register; otherwise the tap is
//   read and updated through chains of predicated selects.
// - Phases.  t = float(i) * dt is monotone in i, so the wordline-open,
//   sense-amp and precharge phases are index ranges [0, i_sa), [i_sa,
//   i_pre), [i_pre, steps), computed on the host with the same float32
//   compares as core/spice.step_phases; each range has its own loop.
// The build uses -fmad=false and no --use_fast_math, so every other
// operation is the plain PyTorch version's, with the accurate expf and
// tanhf: the outputs equal it bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "fast_div.cuh"

namespace {

using fast_div::Divisor;

constexpr unsigned kFull = 0xffffffffu;
// cells a block (the kernel's kThreads): 32, 64 and 256 ran within 1% of 128
// on the H100
constexpr int kCellThreads = 128;
// the least nonzero |x| a fast division may take, in qdiv's key form
constexpr unsigned kKeyLo = (fast_div::kWideNumLoBits << 1) - 1u;

struct Circuit {
  float vdd, v_half, wl_delay_max, sa_gain, sa_enable, dt;
  float tau_seg, tau_acc_cell, tau_acc_node, tau_pre, wl_slope, sa_steep;
  float t_pre, v_ready, v_cell0;
  int steps, i_sa, i_pre, fast;
};

// the launch's divisors with their refined reciprocals
struct Divisors {
  Divisor seg, slope, acc_cell, acc_node, pre;
};

enum Phase { kOpen, kSense, kPrecharge };
// counters: cells run with IEEE divisions, warps on a shared tap, mixed warps
enum Counter { kIeeeCells, kUniformWarps, kMixedWarps };

template <int kSeg>
__device__ __forceinline__ float at_tap(const float (&v)[kSeg], int tap) {
  float x = v[0];
#pragma unroll
  for (int j = 1; j < kSeg; ++j) x = (j == tap) ? v[j] : x;
  return x;
}

// v[tap]: a register when the warp shares the tap kTap >= 0, else a select chain
template <int kSeg, int kTap>
__device__ __forceinline__ float read_tap(const float (&v)[kSeg], int tap) {
  if constexpr (kTap >= 0) {
    return v[kTap];
  } else {
    return at_tap(v, tap);
  }
}

template <int kSeg, int kTap>
__device__ __forceinline__ void add_tap(float (&dv)[kSeg], int tap, float x) {
  if constexpr (kTap >= 0) {
    dv[kTap] = dv[kTap] + x;
  } else {
#pragma unroll
    for (int j = 0; j < kSeg; ++j)
      if (j == tap) dv[j] = dv[j] + x;
  }
}

// x / d for a launch divisor d > 0.  kFast: div_fast with x's sign on a zero
// quotient, and key = min(key, 2|x|'s bits - 1), where a zero x wraps to the
// largest key; else IEEE division.
template <bool kFast>
__device__ __forceinline__ float qdiv(float x, Divisor d, unsigned& key) {
  if constexpr (kFast) {
    const unsigned b = __float_as_uint(x);
    key = min(key, (b << 1) - 1u);
    const float q = fast_div::div_fast(x, d.y, d.ry);
    return __uint_as_float(__float_as_uint(q) | (b & 0x80000000u));
  } else {
    return x / d.y;
  }
}

template <bool kFast>
__device__ __forceinline__ float reciprocal(float d) {   // 1 / d, d in [1, 2^60] when kFast
  if constexpr (kFast) {
    return fast_div::recip(d);
  } else {
    return 1.0f / d;
  }
}

template <int kSeg, int kTap, Phase kPhase, bool kFast>
__device__ __forceinline__ void step(float (&v)[kSeg], float& v_cell, float& t_sense, int i,
                                     int tap, float t_wl, const Circuit& c, const Divisors& dd,
                                     unsigned& key) {
  const float t = static_cast<float>(i) * c.dt;
  float dv[kSeg];
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
    const float left = v[j > 0 ? j - 1 : 0];
    const float right = v[j < kSeg - 1 ? j + 1 : kSeg - 1];
    dv[j] = qdiv<kFast>((left - 2.0f * v[j]) + right, dd.seg, key);
  }
  const float v0 = v[0];
  float dv_cell = 0.0f;
  if constexpr (kPhase != kPrecharge) {
    const float w = reciprocal<kFast>(1.0f + expf(-qdiv<kFast>(t - t_wl, dd.slope, key)));
    const float v_tap = read_tap<kSeg, kTap>(v, tap);
    dv_cell = qdiv<kFast>(w * (v_tap - v_cell), dd.acc_cell, key);
    add_tap<kSeg, kTap>(dv, tap, qdiv<kFast>(w * (v_cell - v_tap), dd.acc_node, key));
    if constexpr (kPhase == kSense)
      dv[0] = dv[0] + c.sa_gain * tanhf((v0 - c.v_half) * c.sa_steep);
  } else {
    dv[0] = dv[0] + qdiv<kFast>(c.v_half - v0, dd.pre, key);
  }
#pragma unroll
  for (int j = 0; j < kSeg; ++j) v[j] = fminf(fmaxf(v[j] + dv[j] * c.dt, 0.0f), c.vdd);
  if constexpr (kPhase != kPrecharge)
    v_cell = fminf(fmaxf(v_cell + dv_cell * c.dt, 0.0f), c.vdd);
  if (read_tap<kSeg, kTap>(v, tap) >= c.v_ready && isinf(t_sense)) t_sense = t;
}

struct Cell {
  float v_probe, v_cell, sense_t;
  unsigned key;   // the least nonzero |numerator| of a fast run, as qdiv's key
};

// One cell's whole run, phase range by phase range.
template <int kSeg, int kTap, bool kFast>
__device__ __forceinline__ Cell run(int tap, float t_wl, const Circuit& c, const Divisors& dd) {
  float v[kSeg];
#pragma unroll
  for (int j = 0; j < kSeg; ++j) v[j] = c.v_half;
  float v_cell = c.v_cell0;
  float t_sense = INFINITY;
  unsigned key = kFull;
  int i = 0;
  for (; i < c.i_sa; ++i)
    step<kSeg, kTap, kOpen, kFast>(v, v_cell, t_sense, i, tap, t_wl, c, dd, key);
  for (; i < c.i_pre; ++i)
    step<kSeg, kTap, kSense, kFast>(v, v_cell, t_sense, i, tap, t_wl, c, dd, key);
  for (; i < c.steps; ++i)
    step<kSeg, kTap, kPrecharge, kFast>(v, v_cell, t_sense, i, tap, t_wl, c, dd, key);
  return Cell{read_tap<kSeg, kTap>(v, tap), v_cell, t_sense, key};
}

// the fast run instantiated for the warp's shared tap
template <int kSeg, int kTap = 0>
__device__ __forceinline__ Cell run_shared_tap(int tap, float t_wl, const Circuit& c,
                                               const Divisors& dd) {
  if constexpr (kTap == kSeg - 1) {
    return run<kSeg, kTap, true>(tap, t_wl, c, dd);
  } else {
    if (tap == kTap) return run<kSeg, kTap, true>(tap, t_wl, c, dd);
    return run_shared_tap<kSeg, kTap + 1>(tap, t_wl, c, dd);
  }
}

template <int kSeg, int kThreads>
__global__ void __launch_bounds__(kThreads)
rc_transient_kernel(const float* __restrict__ row_frac, const float* __restrict__ col_frac,
                    float* __restrict__ v_probe_out, float* __restrict__ v_cell_out,
                    float* __restrict__ sense_out, int n, Circuit c,
                    unsigned long long* __restrict__ counters) {
  const int k0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int first = k0 - lane;   // the warp's first cell
  if (first >= n) return;        // the whole warp is past the end
  const bool live = k0 < n;
  const int k = live ? k0 : first;   // a lane past the end repeats the warp's first cell
  // tap = clip(round_half_even(row_frac * (n_seg - 1)), 0, n_seg - 1)
  const float r = fminf(fmaxf(rintf(row_frac[k] * static_cast<float>(kSeg - 1)), 0.0f),
                        static_cast<float>(kSeg - 1));
  const int tap = static_cast<int>(r);
  const float t_wl = col_frac[k] * c.wl_delay_max;
  const Divisors dd{fast_div::divisor(c.tau_seg), fast_div::divisor(c.wl_slope),
                    fast_div::divisor(c.tau_acc_cell), fast_div::divisor(c.tau_acc_node),
                    fast_div::divisor(c.tau_pre)};

  Cell out{0.0f, 0.0f, 0.0f, 0u};
  // the sigmoid's exponent is at most t_wl / wl_slope <= 32, so 1 + e < 2^60;
  // |t - t_wl| stays below 2^40 (the wrapper bounds t)
  bool ok = c.fast && t_wl <= 32.0f * c.wl_slope && t_wl >= -0x1p36f;
  if (c.fast) {
    const bool shared = __all_sync(kFull, tap == __shfl_sync(kFull, tap, 0));
    out = shared ? run_shared_tap<kSeg>(tap, t_wl, c, dd) : run<kSeg, -1, true>(tap, t_wl, c, dd);
    ok = ok && out.key >= kKeyLo;
    if (lane == 0) atomicAdd(counters + (shared ? kUniformWarps : kMixedWarps), 1ull);
  }
  if (!ok) {   // an operand outside the fast divisions' ranges: the cell again
    out = run<kSeg, -1, false>(tap, t_wl, c, dd);
    if (live) atomicAdd(counters + kIeeeCells, 1ull);
  }
  if (live) {
    v_probe_out[k] = out.v_probe;
    v_cell_out[k] = out.v_cell;
    sense_out[k] = out.sense_t;
  }
}

template <int kSeg, int kThreads>
int launch(const float* row_frac, const float* col_frac, float* v_probe, float* v_cell,
           float* sense, int n, const Circuit& c, unsigned long long* counters, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  rc_transient_kernel<kSeg, kThreads>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(row_frac, col_frac, v_probe,
                                                                   v_cell, sense, n, c, counters);
  return static_cast<int>(cudaGetLastError());
}

// The fast divisions against "/" on every float32 operand of their ranges:
// mode 0, qdiv's x / y (sign of zero included) for |x| in [2^-100, 2^40],
// both signs, and each divisor; mode 1, recip's 1 / d for d in [1, 2^60].
// Counts the operands whose bits differ into *bad.
constexpr int kMaxDivisors = 64;

__global__ void div_check_kernel(const float* __restrict__ divisors, int n, int mode,
                                 unsigned lo, unsigned hi, unsigned long long* bad) {
  __shared__ Divisor s_d[kMaxDivisors];
  for (int k = threadIdx.x; k < n; k += blockDim.x) s_d[k] = fast_div::divisor(divisors[k]);
  __syncthreads();
  unsigned count = 0;
  if (mode == 0 && blockIdx.x == 0 && threadIdx.x == 0) {   // +-0
    for (int k = 0; k < n; ++k) {
      unsigned key = kFull;
      for (const float x : {0.0f, -0.0f})
        count += __float_as_uint(qdiv<true>(x, s_d[k], key)) != __float_as_uint(x / s_d[k].y);
    }
  }
  for (unsigned mag = lo + blockIdx.x * blockDim.x + threadIdx.x; mag <= hi;
       mag += gridDim.x * blockDim.x) {
    if (mode == 1) {
      const float d = __uint_as_float(mag);
      count += __float_as_uint(reciprocal<true>(d)) != __float_as_uint(1.0f / d);
      continue;
    }
    for (int neg = 0; neg < 2; ++neg) {
      const float x = __uint_as_float(neg ? (mag | 0x80000000u) : mag);
      for (int k = 0; k < n; ++k) {
        unsigned key = kFull;
        count += __float_as_uint(qdiv<true>(x, s_d[k], key)) != __float_as_uint(x / s_d[k].y);
      }
    }
  }
  if (count) atomicAdd(bad, static_cast<unsigned long long>(count));
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` (PyTorch's
// current stream) and returns cudaGetLastError() as an int: non-zero means the
// launch was refused and nothing ran (cudaErrorInvalidValue for an n_seg
// without an instantiation or phase bounds out of order).
//
// i_sa and i_pre are the first steps of the sense-amp and precharge phases
// (0 <= i_sa <= i_pre <= steps); fast = 0 runs every cell with IEEE
// divisions.  counters: 3 int64 that the kernel adds to -- cells run with
// IEEE divisions, warps on a shared tap, warps of mixed taps (the last two
// on the fast route only).
extern "C" int rc_transient_launch(const float* row_frac, const float* col_frac,
                                   float* v_probe, float* v_cell, float* sense, int n,
                                   int n_seg, int steps, int i_sa, int i_pre, int fast,
                                   float vdd, float v_half, float wl_delay_max, float sa_gain,
                                   float sa_enable, float dt, float tau_seg,
                                   float tau_acc_cell, float tau_acc_node, float tau_pre,
                                   float wl_slope, float sa_steep, float t_pre, float v_ready,
                                   float v_cell0, unsigned long long* counters, void* stream) {
  if (!(0 <= i_sa && i_sa <= i_pre && i_pre <= steps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Circuit c{vdd,      v_half,   wl_delay_max, sa_gain,      sa_enable,
                  dt,       tau_seg,  tau_acc_cell, tau_acc_node, tau_pre,
                  wl_slope, sa_steep, t_pre,        v_ready,      v_cell0,
                  steps,    i_sa,     i_pre,        fast};
  switch (n_seg) {
    case 4: return launch<4, kCellThreads>(row_frac, col_frac, v_probe, v_cell, sense, n, c,
                                           counters, stream);
    case 8: return launch<8, kCellThreads>(row_frac, col_frac, v_probe, v_cell, sense, n, c,
                                           counters, stream);
    case 16: return launch<16, kCellThreads>(row_frac, col_frac, v_probe, v_cell, sense, n, c,
                                             counters, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Runs div_check_kernel's two modes; divisors: (n,) positive float32 in
// [2^-20, 2^20], n <= 64; bad: 2 zeroed counters.
extern "C" int rc_transient_div_check(const float* divisors, int n, unsigned long long* bad,
                                      void* stream) {
  if (n < 0 || n > kMaxDivisors) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned ranges[2][2] = {{fast_div::kWideNumLoBits, fast_div::kNumHiBits},
                                 {fast_div::kOneBits, fast_div::kZHiBits}};
  for (int mode = 0; mode < 2; ++mode) {
    div_check_kernel<<<4096, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        divisors, n, mode, ranges[mode][0], ranges[mode][1], bad + mode);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
