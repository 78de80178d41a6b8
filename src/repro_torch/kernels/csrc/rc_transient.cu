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
// while the sense amp is on (tanhf), + 3 while precharging -- each IEEE
// division and transcendental counted as one operation.  At n_seg = 8,
// 4500 steps and t_pre = 30 ns that is 371,250 a cell, 1.45 ms for a mat at
// 67 TFLOP/s: the kernel is bound by operations, and the divisions (5 + n_seg
// a step, each a multi-instruction IEEE sequence under -fmad=false) are
// most of its issue slots.
//
// Design: one thread owns one cell, and the whole time loop runs inside the
// kernel with the n_seg ladder voltages, the cell voltage and the crossing
// time in registers (n_seg is a template parameter, so the ladder unrolls
// into registers; the tap is selected by predicated moves, not an indexed
// local array).  No shared memory and no synchronisation: cells are
// independent.  The build uses -fmad=false and no --use_fast_math, so each
// operation is the plain PyTorch version's: IEEE division, the accurate
// expf and tanhf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Circuit {
  float vdd, v_half, wl_delay_max, sa_gain, sa_enable, dt;
  float tau_seg, tau_acc_cell, tau_acc_node, tau_pre, wl_slope, sa_steep;
  float t_pre, v_ready, v_cell0;
  int steps;
};

template <int kSeg>
__device__ __forceinline__ float at_tap(const float (&v)[kSeg], int tap) {
  float x = v[0];
#pragma unroll
  for (int j = 1; j < kSeg; ++j) x = (j == tap) ? v[j] : x;
  return x;
}

template <int kSeg>
__global__ void rc_transient_kernel(const float* __restrict__ row_frac,
                                    const float* __restrict__ col_frac,
                                    float* __restrict__ v_probe_out,
                                    float* __restrict__ v_cell_out,
                                    float* __restrict__ sense_out, int n, Circuit c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  // tap = clip(round_half_even(row_frac * (n_seg - 1)), 0, n_seg - 1)
  const float r = fminf(fmaxf(rintf(row_frac[k] * static_cast<float>(kSeg - 1)), 0.0f),
                        static_cast<float>(kSeg - 1));
  const int tap = static_cast<int>(r);
  const float t_wl = col_frac[k] * c.wl_delay_max;

  float v[kSeg];
#pragma unroll
  for (int j = 0; j < kSeg; ++j) v[j] = c.v_half;
  float v_cell = c.v_cell0;
  float v_probe = c.v_half;
  float t_sense = INFINITY;

  for (int i = 0; i < c.steps; ++i) {
    const float t = static_cast<float>(i) * c.dt;
    const bool wl_open = t < c.t_pre;
    float dv[kSeg];
#pragma unroll
    for (int j = 0; j < kSeg; ++j) {
      const float left = v[j > 0 ? j - 1 : 0];
      const float right = v[j < kSeg - 1 ? j + 1 : kSeg - 1];
      dv[j] = ((left - 2.0f * v[j]) + right) / c.tau_seg;
    }
    const float v0 = v[0];
    float dv_cell = 0.0f;
    if (wl_open) {
      const float w = 1.0f / (1.0f + expf(-((t - t_wl) / c.wl_slope)));
      const float v_tap = at_tap(v, tap);
      dv_cell = (w * (v_tap - v_cell)) / c.tau_acc_cell;
      const float x = (w * (v_cell - v_tap)) / c.tau_acc_node;
#pragma unroll
      for (int j = 0; j < kSeg; ++j)
        if (j == tap) dv[j] = dv[j] + x;
      if (t >= c.sa_enable) dv[0] = dv[0] + c.sa_gain * tanhf((v0 - c.v_half) * c.sa_steep);
    } else {
      dv[0] = dv[0] + (c.v_half - v0) / c.tau_pre;
    }
#pragma unroll
    for (int j = 0; j < kSeg; ++j) v[j] = fminf(fmaxf(v[j] + dv[j] * c.dt, 0.0f), c.vdd);
    if (wl_open) v_cell = fminf(fmaxf(v_cell + dv_cell * c.dt, 0.0f), c.vdd);
    v_probe = at_tap(v, tap);
    if (v_probe >= c.v_ready && isinf(t_sense)) t_sense = t;
  }
  v_probe_out[k] = v_probe;
  v_cell_out[k] = v_cell;
  sense_out[k] = t_sense;
}

template <int kSeg>
int launch(const float* row_frac, const float* col_frac, float* v_probe, float* v_cell,
           float* sense, int n, const Circuit& c, void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  rc_transient_kernel<kSeg><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      row_frac, col_frac, v_probe, v_cell, sense, n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` (PyTorch's current
// stream) and returns cudaGetLastError() as an int: non-zero means the launch
// was refused and nothing ran (cudaErrorInvalidValue for an n_seg without an
// instantiation).
extern "C" int rc_transient_launch(const float* row_frac, const float* col_frac,
                                   float* v_probe, float* v_cell, float* sense, int n,
                                   int n_seg, int steps, float vdd, float v_half,
                                   float wl_delay_max, float sa_gain, float sa_enable,
                                   float dt, float tau_seg, float tau_acc_cell,
                                   float tau_acc_node, float tau_pre, float wl_slope,
                                   float sa_steep, float t_pre, float v_ready,
                                   float v_cell0, void* stream) {
  const Circuit c{vdd,      v_half,       wl_delay_max, sa_gain,  sa_enable,
                  dt,       tau_seg,      tau_acc_cell, tau_acc_node, tau_pre,
                  wl_slope, sa_steep,     t_pre,        v_ready,  v_cell0,
                  steps};
  switch (n_seg) {
    case 4: return launch<4>(row_frac, col_frac, v_probe, v_cell, sense, n, c, stream);
    case 8: return launch<8>(row_frac, col_frac, v_probe, v_cell, sense, n, c, stream);
    case 16: return launch<16>(row_frac, col_frac, v_probe, v_cell, sense, n, c, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
