// RWKV-6 WKV recurrence (rwkv6's time-mix hot loop), for Hopper.
//
// wkv6_launch replaces the Pallas TPU kernel repro/kernels/wkv6.py::wkv6
// (pl.pallas_call at :91).  For r, k, v, wlog of shape (B, S, H, dh) and u
// (H, dh) it runs per (b, h), with the float32 state S (dh x dh):
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * (k_t[i] * v_t[j]))
//   S[i][j] = exp(-exp(wlog_t[i])) * S[i][j] + k_t[i] * v_t[j]
// the recurrence of repro/models/rwkv6.py::wkv6_scan (:54-73), in the form
// the model consumes: S starts from init_state (or zeros) and the final state
// is written out, so that prefill can store it and a decode step (S = 1)
// continue from it.  Each of r, k, v and wlog is read in its own dtype
// (float32, float16 or bfloat16) and widened to float32 in registers, which
// is exact, so the values are the plain version's .float(); u and the states
// are float32, and so is all arithmetic.  The sums run in another order than
// the plain version's einsum, and the kernel contracts products and sums into
// explicit fmaf, so the two agree to a tolerance, not bit for bit.
//
// Bound: HBM sees one read of r, k, v, wlog, of u and of the start state, and
// one write of y and of the final state: at the prefill shape (8, 512, 32,
// 64) in float32 that is 172.0 MB, 0.0513 ms at an H100 SXM's 3.35 TB/s.  The
// function needs 5 fp32 operations per (i, j) and step (r.S: a product and its
// sum; the decay product, the k*v product and the add to S) and 8 per i: the u
// term is rank one, y_t[j] += v_t[j] * sum_i r_t[i] u[i] k_t[i], and the decay
// costs a negation and two expf.  That is 5*dh^2 + 8*dh per (b, h, t), 2.75
// GFLOP at the prefill shape, 0.0411 ms at 67 TFLOP/s, so the bound is by
// bytes.
//
// Design: one block per (b, h) (dh is a template parameter: 8, 16, 32, 64).
// Each thread keeps a tile of the state in registers for the whole sequence:
// at dh = 64, 8 rows by 4 columns, 16 threads across the columns and 8 row
// groups, 128 threads.  A step is then, per state element, three
// instructions (an fmaf into the thread's partial r.S of the column, the
// k*v product and the fmaf of the decayed update).  The tile's shape sets
// how many floats shared memory must deliver into registers a step, which on
// this card (32 floats a clock per SM) would otherwise bound the kernel:
// 3 kRows + kCols per thread (r, k, decay of its rows; v of its columns)
// for kRows * kCols elements.  No step waits on another thread: each row
// group writes its partial sums to shared memory, and only at the end of a
// chunk of kT steps (kChunk, 12) does the block add the row groups'
// partials and v_j times the step's rank-one sum, and write the chunk's y as
// one coalesced tile.  While a chunk computes, the next chunk's r, k, v, wlog are already
// loading into registers (raw 16- or 32-bit words, so no wait); between
// chunks the block widens them into shared memory and computes the chunk's
// decays exp(-exp(wlog)) and rank-one sums sum_i r u k in parallel.  Three
// barriers close a chunk, none is inside it.  The start state is read and
// the final state written by the threads that hold it, 16 bytes a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_io.cuh"

namespace {

using wkv6io::load_raw;
using wkv6io::widen;

// steps a chunk (the kernel's kT): whole steps must tile the block at every
// head width, so a multiple of 4; 16 and 24 would pass the 48 KB of static
// shared memory at dh = 64 (49,280 and 73,920 bytes of staged steps and
// partial sums), and 8 and 4 ran 7% and 15% slower at the prefill shape
// (8, 512, 32, 64) on the H100
constexpr int kChunk = 12;

// A thread's tile of the state: kRows x kCols, by head width
template <int kDh> struct Tile;
template <> struct Tile<64> { static constexpr int kRows = 8, kCols = 4; };
template <> struct Tile<32> { static constexpr int kRows = 4, kCols = 4; };
template <> struct Tile<16> { static constexpr int kRows = 4, kCols = 2; };
template <> struct Tile<8> { static constexpr int kRows = 2, kCols = 1; };

// the block's roles at head width kDh and kT steps a chunk
template <int kDh, int kT>
struct Shape {
  static constexpr int kRows = Tile<kDh>::kRows, kCols = Tile<kDh>::kCols;
  static constexpr int kColThreads = kDh / kCols;          // threads across the columns
  static constexpr int kGroups = kDh / kRows;              // row groups
  static constexpr int kThreads = kColThreads * kGroups;
  static constexpr int kPer = kT * kDh / kThreads;         // staged values per thread
  static constexpr int kStep = kThreads / kDh;             // steps between them
  static constexpr int kSegLanes = kDh < 32 ? kDh : 32;    // lanes of a rank-one partial sum
  static constexpr int kSegs = kDh / kSegLanes;            // partial sums per step
  static_assert(kThreads % 32 == 0 && kThreads % kDh == 0, "block shape");
  static_assert(kPer * kThreads == kT * kDh, "chunk does not tile");
};

// n consecutive floats at p (16-byte aligned for n = 4, 8 for n = 2) into x
template <int n>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (n == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (n == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = *p;
  }
}

template <int n>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (n == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

template <int kDh, int kT>
__global__ void __launch_bounds__(Shape<kDh, kT>::kThreads, 2)
wkv6_kernel(const void* __restrict__ r, const void* __restrict__ k,
            const void* __restrict__ v, const void* __restrict__ wlog, int cr, int ck,
            int cv, int cw, const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  using Sh = Shape<kDh, kT>;
  constexpr int kRows = Sh::kRows, kCols = Sh::kCols;
  constexpr int kVec = kRows < 4 ? kRows : 4;   // floats per shared load of r, k, decay
  __shared__ __align__(16) float s_r[kT][kDh];
  __shared__ __align__(16) float s_k[kT][kDh];
  __shared__ __align__(16) float s_d[kT][kDh];
  __shared__ __align__(16) float s_v[kT][kDh];
  __shared__ __align__(16) float s_part[kT][Sh::kGroups][kDh];   // r.S over a row group
  __shared__ float s_ruk[kT][Sh::kSegs];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  // the step role: rows g*kRows.. and columns c*kCols.. of S
  const int g = tid / Sh::kColThreads, c = tid % Sh::kColThreads;
  // the staging role: element si of steps st0 + kStep*n
  const int si = tid % kDh, st0 = tid / kDh;
  const float u_si = u[h * kDh + si];

  float state[kRows][kCols];   // state[ii][cc] = S[g*kRows + ii][c*kCols + cc]
  float* const s_here = s_out + static_cast<size_t>(bh) * kDh * kDh + c * kCols;
  const float* const s0_here = s0 ? s0 + (s_here - s_out) : nullptr;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    if (s0_here) {
      load_vec<kCols>(s0_here + (g * kRows + ii) * kDh, state[ii]);
    } else {
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) state[ii][cc] = 0.0f;
    }
  }

  // element (b, t, h, i) of a (B, S, H, dh) tensor
  const size_t row = static_cast<size_t>(H) * kDh;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * kDh;
  // a chunk's r, k, v, wlog as loaded: raw 16- or 32-bit words
  struct Raw {
    uint32_t r[Sh::kPer], k[Sh::kPer], v[Sh::kPer], w[Sh::kPer];
  };
  auto prefetch = [&](Raw& p, int t0) {
#pragma unroll
    for (int n = 0; n < Sh::kPer; ++n) {
      const int t = t0 + st0 + Sh::kStep * n;
      const size_t at = base + static_cast<size_t>(t) * row + si;
      const bool in = t < S;
      p.r[n] = in ? load_raw(r, cr, at) : 0u;
      p.k[n] = in ? load_raw(k, ck, at) : 0u;
      p.v[n] = in ? load_raw(v, cv, at) : 0u;
      p.w[n] = in ? load_raw(wlog, cw, at) : 0u;
    }
  };

  Raw p;
  prefetch(p, 0);
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int steps = min(kT, S - t0);
    // widen the chunk into shared memory, with its decays and the partial
    // sums of its rank-one terms sum_i r_i u_i k_i
#pragma unroll
    for (int n = 0; n < Sh::kPer; ++n) {
      const int t = st0 + Sh::kStep * n;
      const float rv = widen(p.r[n], cr), kv = widen(p.k[n], ck);
      s_r[t][si] = rv;
      s_k[t][si] = kv;
      s_d[t][si] = expf(-expf(widen(p.w[n], cw)));
      s_v[t][si] = widen(p.v[n], cv);
      float ruk = rv * u_si * kv;
#pragma unroll
      for (int off = Sh::kSegLanes / 2; off > 0; off /= 2)
        ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
      if (si % Sh::kSegLanes == 0) s_ruk[t][si / Sh::kSegLanes] = ruk;
    }
    if (t0 + kT < S) prefetch(p, t0 + kT);   // in flight while this chunk computes
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      float vj[kCols], acc[kCols];
      load_vec<kCols>(&s_v[t][c * kCols], vj);
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) acc[cc] = 0.0f;
#pragma unroll
      for (int ii = 0; ii < kRows; ii += kVec) {
        float rv[kVec], kv[kVec], dv[kVec];
        load_vec<kVec>(&s_r[t][g * kRows + ii], rv);
        load_vec<kVec>(&s_k[t][g * kRows + ii], kv);
        load_vec<kVec>(&s_d[t][g * kRows + ii], dv);
#pragma unroll
        for (int x = 0; x < kVec; ++x)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc) {
            float& st = state[ii + x][cc];
            acc[cc] = fmaf(rv[x], st, acc[cc]);
            st = fmaf(dv[x], st, kv[x] * vj[cc]);
          }
      }
      store_vec<kCols>(&s_part[t][g][c * kCols], acc);
    }
    __syncthreads();
    // the chunk's y: the row groups' sums plus v_j times the rank-one sum,
    // written as one coalesced tile
#pragma unroll
    for (int n = 0; n < Sh::kPer; ++n) {
      const int t = st0 + Sh::kStep * n;
      if (t < steps) {
        float acc = s_part[t][0][si];
#pragma unroll
        for (int gg = 1; gg < Sh::kGroups; ++gg) acc += s_part[t][gg][si];
        float ruk = s_ruk[t][0];
#pragma unroll
        for (int sg = 1; sg < Sh::kSegs; ++sg) ruk += s_ruk[t][sg];
        y[base + static_cast<size_t>(t0 + t) * row + si] = fmaf(s_v[t][si], ruk, acc);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) store_vec<kCols>(s_here + (g * kRows + ii) * kDh, state[ii]);
}

template <int kDh>
int launch(const void* r, const void* k, const void* v, const void* wlog, int cr, int ck,
           int cv, int cw, const float* u, const float* s0, float* y, float* s_out, int B,
           int S, int H, cudaStream_t stream) {
  wkv6_kernel<kDh, kChunk><<<B * H, Shape<kDh, kChunk>::kThreads, 0, stream>>>(
      r, k, v, wlog, cr, ck, cv, cw, u, s0, y, s_out, S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, wlog, y: (B, S, H, dh), contiguous; r..wlog each float32 (dtype
// code 0), float16 (1) or bfloat16 (2), y float32; u: (H, dh) float32; s0 (or
// null for zeros) and s_out: (B, H, dh, dh) float32, 16-byte aligned.  S >= 1 and B*H >= 1.
// Returns the CUDA error of the launch (0 on success).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* wlog,
                           int r_dtype, int k_dtype, int v_dtype, int w_dtype,
                           const float* u, const float* s0, float* y, float* s_out, int B,
                           int S, int H, int dh, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int codes[4] = {r_dtype, k_dtype, v_dtype, w_dtype};
  for (int c : codes)
    if (!wkv6io::valid(c)) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 8: return launch<8>(r, k, v, wlog, r_dtype, k_dtype, v_dtype, w_dtype, u, s0, y,
                             s_out, B, S, H, stream);
    case 16: return launch<16>(r, k, v, wlog, r_dtype, k_dtype, v_dtype, w_dtype, u, s0, y,
                               s_out, B, S, H, stream);
    case 32: return launch<32>(r, k, v, wlog, r_dtype, k_dtype, v_dtype, w_dtype, u, s0, y,
                               s_out, B, S, H, stream);
    case 64: return launch<64>(r, k, v, wlog, r_dtype, k_dtype, v_dtype, w_dtype, u, s0, y,
                               s_out, B, S, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
