// RWKV-6 WKV recurrence, backward: the vector-Jacobian product of wkv6, for
// Hopper.
//
// wkv6_bwd_launch is the port's counterpart of XLA's autodiff of
// repro/models/rwkv6.py::wkv6_scan (:54, the scan the reference trains
// through; the Pallas kernel repro/kernels/wkv6.py has no VJP).  Per (b, h),
// with w_t = exp(-exp(wlog_t)), the states S_t = diag(w_t) S_{t-1} + k_t^T
// v_t (S_{-1} the start state or zeros) and G_t = dL/dS_t (G_{S-1} the final
// state's cotangent, or zeros), it computes
//   dr_t[i]    = sum_j dy_t[j] S_{t-1}[i][j] + u[i] k_t[i] (dy_t . v_t)
//   dk_t[i]    = sum_j G_t[i][j] v_t[j]      + r_t[i] u[i] (dy_t . v_t)
//   dv_t[j]    = sum_i k_t[i] G_t[i][j]      + dy_t[j] (sum_i r_t[i] u[i] k_t[i])
//   dwlog_t[i] = -(exp(wlog_t[i]) w_t[i]) sum_j G_t[i][j] S_{t-1}[i][j]
//   du[i]      = sum over b and t of r_t[i] k_t[i] (dy_t . v_t)
//   G_{t-1}    = diag(w_t) G_t + r_t^T dy_t,   d init_state = G_{-1}.
// r, k, v and wlog are read in their own dtypes (float32, float16 or
// bfloat16) and each gradient is written in its input's dtype, rounded to
// nearest even; dy, the states and all arithmetic are float32.  The sums run
// in another order than the plain version's (kernels/wkv6.py::wkv6_bwd_ref),
// so the two agree to a tolerance, not bit for bit; the order is fixed, so a
// second run gives the same bits.
//
// Bound, at the training shape (B, S, H, dh) = (8, 512, 32, 64): the function
// needs 14 fp32 operations per (i, j) and step (the state's recompute k*v,
// w*S and the add; the sums of dr, dk, dv and dwlog, a product and an add
// each; the update of G, two products and an add) and 21 per i (the decay
// and its derivative, dy.v, r u k, the rank-one terms of dr, dk, dv, dwlog's
// scale, du): 58,688 per (b, h, t), 7.69 GFLOP, 0.1148 ms at 67 TFLOP/s.  HBM
// sees one read of r, k, v, wlog and dy and one write of the four gradients:
// 302.0 MB in float32, 0.0902 ms at 3.35 TB/s (235 MB, 0.0701 ms, with the
// training path's bfloat16 k and v).  So the bound is by operations.
//
// What held the first design back (one block per (b, h), 512 threads; 0.89
// ms in float32, 1.14 ms with bfloat16 k/v on an H100), and what this one
// does about it:
// 1. Too few blocks: 256 blocks of 512 threads, 166 KB of shared memory, one
//    block an SM, two waves (132 + 124) of serial steps.  Every element
//    (i, j) of S and of G evolves on its own: rows meet only in dv (a sum
//    over i), columns only in dr, dk and dwlog (sums over j).  So here a block
//    owns kR rows of one (b, h) and all dh columns, and the kCluster = dh / kR
//    blocks of a (b, h) are one thread-block cluster.  At dh = 64, kR = 32:
//    512 blocks of 256 threads, 2 an SM, 132 clusters resident, so 1.94
//    waves (16-row blocks in clusters of 4 gave 1,024 blocks of 128 threads,
//    4 an SM, but only 124 clusters resident: 3 waves).  Within a block dr,
//    dk, dwlog and du are complete and dv is a partial sum over its rows: at
//    each chunk's end every block leaves its dv partial in shared memory, and
//    after a cluster barrier block rank q adds the ranks' partials, in rank
//    order, for columns [q kR, q kR + kR), through distributed shared memory:
//    no atomics, no second pass over HBM, the same bits every run.  The
//    checkpoint sweep is split the same way, each block recomputing only its
//    own rows.
// 2. G held twice, by a row group and a column group with unequal work.
//    Here each thread holds one kTR x kTC tile of G and the same tile of S
//    (2 x 4 at dh = 64) and one role: per step and element it updates S (in
//    the recompute) and G once and adds its part of the four sums, 8 fp32
//    instructions for the function's 7 FMA-equivalents.
// 3. Thread-private history in shared memory.  Here the chunk's recomputed
//    states S_{t0-1} .. S_{t0+kC-2} of the thread's tile stay in registers
//    (kC x 8 floats, the chunk fully unrolled): 128 registers a thread, no
//    spill.
// 4. Reductions inside the step (shuffles every step).  No gradient feeds the
//    recurrence, so a step here only writes the thread's partial sums (its
//    part of dy.S, G.v, G.S for its rows and of k.G for its columns) to
//    per-step slots in shared memory, laid out so that a warp's stores and the
//    block's later reads are free of bank conflicts.  At the chunk's end the
//    block adds the partials in a fixed order, with the rank-one terms (u k
//    (dy.v), r u (dy.v), dy (r.u k) over the block's rows).  No shuffle and
//    no barrier inside a chunk.  (Summing the partials within the warp by
//    shuffles instead cut this pass but cost the step more: shuffles use the
//    same pipe as shared memory.)
// 5. Scattered stores (one 2- or 4-byte value a thread and step, 4-way
//    divergent).  Here a thread writes 4 consecutive values of one gradient
//    and step: 16 bytes in float32, 8 in a 16-bit dtype, so a warp fills
//    whole 32-byte sectors, and the training dtypes are no slower than
//    float32.
// What bounds it now: shared memory's 32 lanes a clock per SM, which the
// step's operands (v, dy of the thread's columns; r, k, w of its rows) and
// partial sums cross at ~3 words per element and step against 6 fp32
// instructions on 128 lanes; and HBM in the checkpoint sweep, which writes
// 268 MB of saved states (a chunk of kC = 8 steps each, interleaved by thread
// so that a warp's store or load is one contiguous 512-byte run; read back
// by the thread that wrote it), staging kF steps between two barriers.  The
// next chunk's inputs load into registers while a chunk computes; du is
// summed over t in a fixed order per block and over b by a second kernel.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_io.cuh"

namespace cgr = cooperative_groups;

namespace {

using wkv6io::load_raw;
using wkv6io::store4;
using wkv6io::widen;

// steps per chunk: one saved state a chunk.  du sums each (b, h)'s steps by
// their residue mod kC and then the residues in order, so another kC would
// add du's terms in another order (other bits); and at dh = 64, kC = 4 would
// stage fewer row values (4 x 32) than the block has threads (256)
constexpr int kC = 8;

// rows a block owns (kR), a thread's tile of them (kTR rows x kTC columns),
// the steps the checkpoint sweep stages at once (kF) and the blocks an SM
// is to hold (kBlocks: registers a thread <= 65536 / (threads x kBlocks);
// at dh = 32 shared memory allows 7, so the registers need not stop at 128)
template <int kDh> struct Split;
template <> struct Split<64> {
  static constexpr int kR = 32, kTR = 2, kTC = 4, kF = 32, kBlocks = 2;
};
template <> struct Split<32> {
  static constexpr int kR = 16, kTR = 2, kTC = 4, kF = 16, kBlocks = 6;
};
template <> struct Split<16> {
  static constexpr int kR = 16, kTR = 2, kTC = 2, kF = 32, kBlocks = 8;
};
template <> struct Split<8> {
  static constexpr int kR = 8, kTR = 1, kTC = 2, kF = 32, kBlocks = 16;
};

template <int kDh>
struct Bwd {
  static constexpr int kR = Split<kDh>::kR, kTR = Split<kDh>::kTR, kTC = Split<kDh>::kTC;
  static constexpr int kCluster = kDh / kR;             // blocks a (b, h)
  static constexpr int kRG = kR / kTR;                  // row groups
  static constexpr int kCG = kDh / kTC;                 // column groups
  static constexpr int kThreads = kRG * kCG;
  static constexpr int kRowPer = kC * kR / kThreads;    // staged row values a thread
  static constexpr int kColPer = kC * kDh / kThreads;   // staged column values a thread
  static constexpr int kSegLanes = kDh < 32 ? kDh : 32; // lanes of a partial dy.v
  static constexpr int kSegs = kDh / kSegLanes;
  static constexpr int kQuads = kR / 4;                 // 4-row groups of the block's rows
  static constexpr int kRowUnits = 4 * kC * kQuads;     // (dr | dk | dwlog | du, step, quad)
  static constexpr int kColUnits = kC * kDh / 4;        // (step, column quad) of the dv partial
  static constexpr int kOwnUnits = kC * kQuads;         // (step, quad) of the block's dv columns
  // the first thread of the dv partial's units (after the row units' owners)
  static constexpr int kFirstCol = kRowUnits == kThreads ? 3 * kThreads / 4 : 0;
  // a column group's row partials of all steps: + 16 so that the two column
  // groups of a half-warp's stores fall in the two halves of the banks
  static constexpr int kPartRow = kC * kR + 16;
  // a row group's column partials of one step: + 4 so that the 8 row groups
  // of a quarter-warp's 16-byte stores fall in 8 distinct bank quads
  static constexpr int kPartCol = kDh + 4;
  // shared memory, in floats
  static constexpr int oU = 0;                          // u of the block's rows
  static constexpr int oR = oU + kR;                    // [kC][kR]: r
  static constexpr int oK = oR + kC * kR;               //           k
  static constexpr int oD = oK + kC * kR;               //           w = exp(-exp(wlog))
  static constexpr int oND = oD + kC * kR;              //           dw/dwlog = -exp(wlog) w
  static constexpr int oV = oND + kC * kR;              // [kC][kDh]: v
  static constexpr int oDY = oV + kC * kDh;             //            dy
  static constexpr int oRUK = oDY + kC * kDh;           // [kC]: sum of r u k over the block's rows
  static constexpr int oDYV = oRUK + kC;                // [kC][kSegs]: partial sums of dy.v
  static constexpr int oDU = oDYV + kC * kSegs;         // [kC][kR]: du by step residue
  static constexpr int oPR = oDU + kC * kR;             // [3][kCG][kPartRow]: dr, dk, dwlog
  static constexpr int oPC = oPR + 3 * kCG * kPartRow;  // [kC][kRG][kPartCol]: dv partials
  static constexpr int oDV = oPC + kC * kRG * kPartCol; // [2][kC][kDh]: dv, by chunk parity
  static constexpr int kFloats = oDV + 2 * kC * kDh;
  static constexpr size_t kSmem = kFloats * sizeof(float);
  // the checkpoint sweep stages kF steps of k, w and v, in the partials' room
  static constexpr int kF = Split<kDh>::kF;
  static constexpr int kFRowPer = kF * kR / kThreads;
  static constexpr int kFColPer = kF * kDh / kThreads;
  static_assert(kF % kC == 0 && kF * (2 * kR + kDh) <= 3 * kCG * kPartRow,
                "the sweep stages whole chunks, in the partials' room");
  static_assert(kThreads % 32 == 0 && 32 % kR == 0,
                "whole warps; a warp stages whole steps of rows");
  static_assert(kRowUnits % kThreads == 0 && kC * kR % kThreads == 0 &&
                kC * kDh % kThreads == 0, "the staging and the row outputs tile the block");
  static_assert(oDU % 4 == 0 && oPR % 4 == 0 && oPC % 4 == 0 && oDV % 4 == 0 &&
                kPartRow % 4 == 0 && kPartCol % 4 == 0, "16-byte aligned arrays");
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

template <int kDh>
__global__ void __launch_bounds__(Bwd<kDh>::kThreads, Split<kDh>::kBlocks)
wkv6_bwd_kernel(const void* __restrict__ r, const void* __restrict__ k,
                const void* __restrict__ v, const void* __restrict__ wlog, int code_r,
                int code_k, int code_v, int code_w, const float* __restrict__ u,
                const float* __restrict__ s0, const float* __restrict__ dy,
                const float* __restrict__ ds_final, void* __restrict__ dr,
                void* __restrict__ dk, void* __restrict__ dv, void* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ ds0,
                float* __restrict__ ckpt, int S, int H) {
  using Sh = Bwd<kDh>;
  constexpr int kR = Sh::kR, kTR = Sh::kTR, kTC = Sh::kTC, kThreads = Sh::kThreads;
  constexpr int kQuads = Sh::kQuads;
  extern __shared__ __align__(16) float smem[];
  float* const s_u = smem + Sh::oU;
  float* const s_r = smem + Sh::oR;
  float* const s_k = smem + Sh::oK;
  float* const s_d = smem + Sh::oD;
  float* const s_nd = smem + Sh::oND;
  float* const s_v = smem + Sh::oV;
  float* const s_dy = smem + Sh::oDY;
  float* const s_ruk = smem + Sh::oRUK;
  float* const s_dyv = smem + Sh::oDYV;
  float* const s_du = smem + Sh::oDU;
  float* const s_pr = smem + Sh::oPR;
  float* const s_pc = smem + Sh::oPC;
  float* const s_dvb = smem + Sh::oDV;

  const int tid = threadIdx.x;
  // a 1-D grid of 1-D clusters: block rank q of cluster bh owns rows q kR ..
  const int rank = blockIdx.x % Sh::kCluster;
  const int bh = blockIdx.x / Sh::kCluster;
  const int b = bh / H, h = bh - b * H;
  const int i0 = rank * kR;
  const int n_chunks = (S + kC - 1) / kC;
  // element (b, t, h, i) of a (B, S, H, dh) tensor: base + t * row + i
  const size_t row = static_cast<size_t>(H) * kDh;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * kDh;
  const size_t mat = static_cast<size_t>(bh) * kDh * kDh;
  // the step role: rows i0 + r0 .. r0 + kTR - 1, columns c0 .. c0 + kTC - 1
  const int rg = tid % Sh::kRG, cg = tid / Sh::kRG;
  const int r0 = rg * kTR, c0 = cg * kTC;
  // the thread's saved states: tile row p of chunk c at + c kR dh + p kThreads kTC
  float* const ck = ckpt + static_cast<size_t>(blockIdx.x) * n_chunks * (kR * kDh) + tid * kTC;

  if (tid < kR) s_u[tid] = u[h * kDh + i0 + tid];
  for (int e = tid; e < kC * kR; e += kThreads) s_du[e] = 0.0f;

  // the staging role: row value n is e = tid + n kThreads of a chunk's
  // [kC][kR] rows, column value n of its [kC][kDh] columns
  struct Raw {
    uint32_t r[Sh::kRowPer], k[Sh::kRowPer], w[Sh::kRowPer], v[Sh::kColPer];
    float dy[Sh::kColPer];
  };
  auto fetch = [&](Raw& p, int c) {
#pragma unroll
    for (int n = 0; n < Sh::kRowPer; ++n) {
      const int e = tid + n * kThreads, t = c * kC + e / kR;
      const bool in = t < S;
      const size_t at = base + static_cast<size_t>(t) * row + i0 + e % kR;
      p.k[n] = in ? load_raw(k, code_k, at) : 0u;
      p.w[n] = in ? load_raw(wlog, code_w, at) : 0u;
      p.r[n] = in ? load_raw(r, code_r, at) : 0u;
    }
#pragma unroll
    for (int n = 0; n < Sh::kColPer; ++n) {
      const int e = tid + n * kThreads, t = c * kC + e / kDh;
      const bool in = t < S;
      const size_t at = base + static_cast<size_t>(t) * row + e % kDh;
      p.v[n] = in ? load_raw(v, code_v, at) : 0u;
      p.dy[n] = in ? __ldg(dy + at) : 0.0f;
    }
  };

  // ---- forward: the state before each chunk but the last into the scratch,
  // kF steps staged at once (k, w, v in the partials' room)
  float s[kTR][kTC];
#pragma unroll
  for (int p = 0; p < kTR; ++p) {
    if (s0) {
      load_vec<kTC>(s0 + mat + static_cast<size_t>(i0 + r0 + p) * kDh + c0, s[p]);
    } else {
#pragma unroll
      for (int x = 0; x < kTC; ++x) s[p][x] = 0.0f;
    }
  }
  {
    constexpr int kF = Sh::kF;
    float* const f_k = s_pr;                 // [kF][kR]
    float* const f_d = f_k + kF * kR;        // [kF][kR]
    float* const f_v = f_d + kF * kR;        // [kF][kDh]
    uint32_t fk[Sh::kFRowPer], fw[Sh::kFRowPer], fv[Sh::kFColPer];
    auto fetch_fwd = [&](int t0) {
#pragma unroll
      for (int n = 0; n < Sh::kFRowPer; ++n) {
        const int e = tid + n * kThreads, t = t0 + e / kR;
        const size_t at = base + static_cast<size_t>(t) * row + i0 + e % kR;
        fk[n] = t < S ? load_raw(k, code_k, at) : 0u;
        fw[n] = t < S ? load_raw(wlog, code_w, at) : 0u;
      }
#pragma unroll
      for (int n = 0; n < Sh::kFColPer; ++n) {
        const int e = tid + n * kThreads, t = t0 + e / kDh;
        fv[n] = t < S ? load_raw(v, code_v, base + static_cast<size_t>(t) * row + e % kDh) : 0u;
      }
    };
    const int swept = (n_chunks - 1) * kC;   // steps before the last chunk
    if (swept > 0) fetch_fwd(0);
    for (int f0 = 0; f0 < swept; f0 += kF) {
      __syncthreads();   // the previous block of steps' reads are done
#pragma unroll
      for (int n = 0; n < Sh::kFRowPer; ++n) {
        const int e = tid + n * kThreads;
        f_k[e] = widen(fk[n], code_k);
        f_d[e] = expf(-expf(widen(fw[n], code_w)));
      }
#pragma unroll
      for (int n = 0; n < Sh::kFColPer; ++n) f_v[tid + n * kThreads] = widen(fv[n], code_v);
      if (f0 + kF < swept) fetch_fwd(f0 + kF);   // in flight while these steps compute
      __syncthreads();
      for (int cc = 0; cc < kF / kC && f0 + cc * kC < swept; ++cc) {
        const int c = f0 / kC + cc;
#pragma unroll
        for (int p = 0; p < kTR; ++p)
          store_vec<kTC>(ck + static_cast<size_t>(c) * (kR * kDh) + p * kThreads * kTC, s[p]);
#pragma unroll
        for (int tau = cc * kC; tau < cc * kC + kC; ++tau) {
          float vv[kTC], kk[kTR], dd[kTR];
          load_vec<kTC>(f_v + tau * kDh + c0, vv);
          load_vec<kTR>(f_k + tau * kR + r0, kk);
          load_vec<kTR>(f_d + tau * kR + r0, dd);
#pragma unroll
          for (int p = 0; p < kTR; ++p)
#pragma unroll
            for (int x = 0; x < kTC; ++x) s[p][x] = fmaf(dd[p], s[p][x], kk[p] * vv[x]);
        }
      }
    }
  }
  // s is now the state before the last chunk

  // ---- reverse, a chunk at a time from the last
  float g[kTR][kTC];
#pragma unroll
  for (int p = 0; p < kTR; ++p) {
    if (ds_final) {
      load_vec<kTC>(ds_final + mat + static_cast<size_t>(i0 + r0 + p) * kDh + c0, g[p]);
    } else {
#pragma unroll
      for (int x = 0; x < kTC; ++x) g[p][x] = 0.0f;
    }
  }
  float* const pr_mine = s_pr + cg * Sh::kPartRow + r0;   // + q * kCG * kPartRow + tau * kR
  float* const pc_mine = s_pc + rg * Sh::kPartCol + c0;   // + tau * kRG * kPartCol
  Raw pre;
  fetch(pre, n_chunks - 1);
  __syncthreads();   // the forward sweep's reads of the staged values are done
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kC;
    float* const dvb = s_dvb + (c & 1) * (kC * kDh);
    // stage the chunk: steps past the sequence get zeros and a decay of 1,
    // so that G passes through them unchanged
#pragma unroll
    for (int n = 0; n < Sh::kRowPer; ++n) {
      const int e = tid + n * kThreads, st = e / kR, si = e % kR;
      const bool in = t0 + st < S;
      const float rv = widen(pre.r[n], code_r), kv = widen(pre.k[n], code_k);
      const float ex = expf(widen(pre.w[n], code_w)), d = expf(-ex);
      s_r[e] = rv;
      s_k[e] = kv;
      s_d[e] = in ? d : 1.0f;
      s_nd[e] = in ? -(ex * d) : 0.0f;
      float ruk = rv * s_u[si] * kv;
#pragma unroll
      for (int off = kR / 2; off > 0; off /= 2) ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
      if (si == 0) s_ruk[st] = ruk;
    }
#pragma unroll
    for (int n = 0; n < Sh::kColPer; ++n) {
      const int e = tid + n * kThreads, st = e / kDh, sj = e % kDh;
      const float vv = widen(pre.v[n], code_v), gy = pre.dy[n];
      s_v[e] = vv;
      s_dy[e] = gy;
      float dyv = gy * vv;
#pragma unroll
      for (int off = Sh::kSegLanes / 2; off > 0; off /= 2)
        dyv += __shfl_xor_sync(0xffffffffu, dyv, off);
      if (sj % Sh::kSegLanes == 0) s_dyv[st * Sh::kSegs + sj / Sh::kSegLanes] = dyv;
    }
    if (c > 0) fetch(pre, c - 1);   // in flight while this chunk computes
    __syncthreads();

    // S_{t0-1} .. S_{t0+kC-2} of the tile, recomputed from the saved state
    float hist[kC][kTR][kTC];
#pragma unroll
    for (int tau = 0; tau < kC; ++tau) {
#pragma unroll
      for (int p = 0; p < kTR; ++p)
#pragma unroll
        for (int x = 0; x < kTC; ++x) hist[tau][p][x] = s[p][x];
      if (tau + 1 < kC) {
        float vv[kTC], kk[kTR], dd[kTR];
        load_vec<kTC>(s_v + tau * kDh + c0, vv);
        load_vec<kTR>(s_k + tau * kR + r0, kk);
        load_vec<kTR>(s_d + tau * kR + r0, dd);
#pragma unroll
        for (int p = 0; p < kTR; ++p)
#pragma unroll
          for (int x = 0; x < kTC; ++x) s[p][x] = fmaf(dd[p], s[p][x], kk[p] * vv[x]);
      }
    }
    // the steps in reverse: the tile's partial sums into the step's slots,
    // then G_{t-1} = w_t G_t + r_t^T dy_t
#pragma unroll
    for (int tau = kC - 1; tau >= 0; --tau) {
      float vv[kTC], gy[kTC], rr[kTR], kk[kTR], dd[kTR];
      load_vec<kTC>(s_v + tau * kDh + c0, vv);
      load_vec<kTC>(s_dy + tau * kDh + c0, gy);
      load_vec<kTR>(s_r + tau * kR + r0, rr);
      load_vec<kTR>(s_k + tau * kR + r0, kk);
      load_vec<kTR>(s_d + tau * kR + r0, dd);
      float a[kTR], bs[kTR], cs[kTR], dvp[kTC];   // dy.S_{t-1}, G.v, G.S_{t-1}; k.G
#pragma unroll
      for (int p = 0; p < kTR; ++p) {
        a[p] = gy[0] * hist[tau][p][0];
        bs[p] = g[p][0] * vv[0];
        cs[p] = g[p][0] * hist[tau][p][0];
#pragma unroll
        for (int x = 1; x < kTC; ++x) {
          a[p] = fmaf(gy[x], hist[tau][p][x], a[p]);
          bs[p] = fmaf(g[p][x], vv[x], bs[p]);
          cs[p] = fmaf(g[p][x], hist[tau][p][x], cs[p]);
        }
      }
#pragma unroll
      for (int x = 0; x < kTC; ++x) {
        dvp[x] = kk[0] * g[0][x];
#pragma unroll
        for (int p = 1; p < kTR; ++p) dvp[x] = fmaf(kk[p], g[p][x], dvp[x]);
      }
      store_vec<kTR>(pr_mine + tau * kR, a);
      store_vec<kTR>(pr_mine + Sh::kCG * Sh::kPartRow + tau * kR, bs);
      store_vec<kTR>(pr_mine + 2 * Sh::kCG * Sh::kPartRow + tau * kR, cs);
      store_vec<kTC>(pc_mine + tau * Sh::kRG * Sh::kPartCol, dvp);
#pragma unroll
      for (int p = 0; p < kTR; ++p)
#pragma unroll
        for (int x = 0; x < kTC; ++x) g[p][x] = fmaf(dd[p], g[p][x], rr[p] * gy[x]);
    }
    if (c > 0) {   // the previous chunk's saved state, loading through the reduction
#pragma unroll
      for (int p = 0; p < kTR; ++p)
        load_vec<kTC>(ck + static_cast<size_t>(c - 1) * (kR * kDh) + p * kThreads * kTC, s[p]);
    }
    __syncthreads();

    // the chunk's dr, dk, dwlog (and du's terms) of the block's rows: 4 rows
    // of one gradient and step a unit, the partials added in column order
#pragma unroll
    for (int m = 0; m < Sh::kRowUnits / kThreads; ++m) {
      const int n = tid + m * kThreads;
      const int q = n / (kC * kQuads), tau = n / kQuads % kC, quad = n % kQuads;
      const int at = tau * kR + 4 * quad;
      float dyv = s_dyv[tau * Sh::kSegs];
#pragma unroll
      for (int sg = 1; sg < Sh::kSegs; ++sg) dyv += s_dyv[tau * Sh::kSegs + sg];
      float out[4];
      if (q < 3) {
        const float* const part = s_pr + q * Sh::kCG * Sh::kPartRow + at;
        load_vec<4>(part, out);
#pragma unroll 4
        for (int j = 1; j < Sh::kCG; ++j) {
          float x4[4];
          load_vec<4>(part + j * Sh::kPartRow, x4);
#pragma unroll
          for (int x = 0; x < 4; ++x) out[x] += x4[x];
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float uu = s_u[4 * quad + x];
          out[x] = q == 0 ? fmaf(uu * s_k[at + x], dyv, out[x])
                 : q == 1 ? fmaf(s_r[at + x] * uu, dyv, out[x])
                          : s_nd[at + x] * out[x];
        }
        if (t0 + tau < S) {
          void* const dst = q == 0 ? dr : q == 1 ? dk : dw;
          const int code = q == 0 ? code_r : q == 1 ? code_k : code_w;
          store4(dst, code, base + static_cast<size_t>(t0 + tau) * row + i0 + 4 * quad, out);
        }
      } else {   // du: this unit's running sum over the steps tau of every chunk
#pragma unroll
        for (int x = 0; x < 4; ++x)
          s_du[at + x] = fmaf(s_r[at + x] * s_k[at + x], dyv, s_du[at + x]);
      }
    }
    // the block's dv partial: its row groups' partials in order, plus dy
    // times the block's share of r.u k; where a thread has one row unit, on
    // the du threads, which have no partials to add
    for (int n = tid - Sh::kFirstCol; n >= 0 && n < Sh::kColUnits;
         n += kThreads - Sh::kFirstCol) {
      const int tau = n / (kDh / 4), col = 4 * (n % (kDh / 4));
      const float* const part = s_pc + tau * Sh::kRG * Sh::kPartCol + col;
      float sum[4], gy[4];
      load_vec<4>(part, sum);
#pragma unroll
      for (int j = 1; j < Sh::kRG; ++j) {
        float x4[4];
        load_vec<4>(part + j * Sh::kPartCol, x4);
#pragma unroll
        for (int x = 0; x < 4; ++x) sum[x] += x4[x];
      }
      load_vec<4>(s_dy + tau * kDh + col, gy);
      const float ruk = s_ruk[tau];
#pragma unroll
      for (int x = 0; x < 4; ++x) sum[x] = fmaf(gy[x], ruk, sum[x]);
      store_vec<4>(dvb + tau * kDh + col, sum);
    }
    // every block's dv partial of the chunk is in place (and, until the next
    // chunk, this barrier also keeps the staged values and partials)
    if constexpr (Sh::kCluster > 1) {
      cgr::this_cluster().sync();
    } else {
      __syncthreads();
    }
    // dv of the block's columns i0 .., the ranks' partials added in rank order
    for (int n = tid; n < Sh::kOwnUnits; n += kThreads) {
      const int tau = n / kQuads, col = i0 + 4 * (n % kQuads);
      float sum[4];
      if constexpr (Sh::kCluster > 1) {
        cgr::cluster_group cluster = cgr::this_cluster();
        load_vec<4>(cluster.map_shared_rank(dvb, 0) + tau * kDh + col, sum);
#pragma unroll
        for (int q = 1; q < Sh::kCluster; ++q) {
          float x4[4];
          load_vec<4>(cluster.map_shared_rank(dvb, q) + tau * kDh + col, x4);
#pragma unroll
          for (int x = 0; x < 4; ++x) sum[x] += x4[x];
        }
      } else {
        load_vec<4>(dvb + tau * kDh + col, sum);
      }
      if (t0 + tau < S)
        store4(dv, code_v, base + static_cast<size_t>(t0 + tau) * row + col, sum);
    }
  }

  if (ds0) {
#pragma unroll
    for (int p = 0; p < kTR; ++p)
      store_vec<kTC>(ds0 + mat + static_cast<size_t>(i0 + r0 + p) * kDh + c0, g[p]);
  }
  // du of the block's rows over this batch entry: the step residues in order
  // (the last chunk's barrier ordered their sums before these reads)
  if (tid < kR) {
    float acc = s_du[tid];
#pragma unroll
    for (int tau = 1; tau < kC; ++tau) acc += s_du[tau * kR + tid];
    du_part[static_cast<size_t>(bh) * kDh + i0 + tid] = acc;
  }
  // no block leaves while another may still read its dv partial
  if constexpr (Sh::kCluster > 1) cgr::this_cluster().sync();
}

// du[n] = sum over b of du_part[b][n], b in order, n = h * dh + i
__global__ void wkv6_du_kernel(const float* __restrict__ du_part, void* __restrict__ du,
                               int code_u, int B, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<size_t>(b) * n + idx];
  wkv6io::store(du, code_u, idx, acc);
}

// the launch of wkv6_bwd_kernel<kDh> over B*H clusters of kCluster blocks
template <int kDh>
cudaLaunchConfig_t config(int BH, cudaStream_t stream, cudaLaunchAttribute* attr) {
  using Sh = Bwd<kDh>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH * Sh::kCluster);
  cfg.blockDim = dim3(Sh::kThreads);
  cfg.dynamicSmemBytes = Sh::kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = Sh::kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = Sh::kCluster > 1 ? 1 : 0;
  return cfg;
}

template <int kDh>
cudaError_t launch(const void* r, const void* k, const void* v, const void* wlog, int cr,
                   int ck, int cv, int cw, int cu, const float* u, const float* s0,
                   const float* dy, const float* ds_final, void* dr, void* dk, void* dv,
                   void* dw, void* du, float* du_part, float* ds0, float* ckpt, int B, int S,
                   int H, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<kDh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Bwd<kDh>::kSmem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<kDh>(B * H, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<kDh>, r, k, v, wlog, cr, ck, cv, cw, u, s0,
                           dy, ds_final, dr, dk, dv, dw, du_part, ds0, ckpt, S, H);
  if (err != cudaSuccess) return err;
  const int n = H * kDh;
  wkv6_du_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, cu, B, n);
  return cudaGetLastError();
}

template <int kDh>
cudaError_t occupancy(int BH, int* out) {
  using Sh = Bwd<kDh>;
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<kDh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Sh::kSmem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, wkv6_bwd_kernel<kDh>);
  if (err != cudaSuccess) return err;
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wkv6_bwd_kernel<kDh>,
                                                      Sh::kThreads, Sh::kSmem);
  if (err != cudaSuccess) return err;
  if (Sh::kCluster > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config<kDh>(BH, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&clusters, wkv6_bwd_kernel<kDh>, &cfg);
    if (err != cudaSuccess) return err;
  }
  out[0] = Sh::kThreads;
  out[1] = static_cast<int>(Sh::kSmem);
  out[2] = Sh::kCluster;
  out[3] = blocks;
  out[4] = clusters;
  out[5] = fa.numRegs;
  out[6] = static_cast<int>(fa.localSizeBytes);
  return cudaSuccess;
}

}  // namespace

// r, k, v, wlog, dy, dr, dk, dv, dw: (B, S, H, dh), contiguous and 16-byte
// aligned; r..wlog each float32 (dtype code 0), float16 (1) or bfloat16 (2),
// and dr..dw in the code of their input; dy float32.  u: (H, dh) float32, its
// gradient du written in code u_dtype.  s0 and ds_final (either may be null
// for zeros) and ds0 (null when no start state was given): (B, H, dh, dh)
// float32, 16-byte aligned.  du_part: (B, H, dh) float32 scratch; ckpt: (B,
// H, ceil(S / 8), dh, dh) float32 scratch.  S >= 1 and B*H >= 1.  Returns the
// CUDA error of the launches (0 on success).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v, const void* wlog,
                               int r_dtype, int k_dtype, int v_dtype, int w_dtype,
                               int u_dtype, const float* u, const float* s0, const float* dy,
                               const float* ds_final, void* dr, void* dk, void* dv, void* dw,
                               void* du, float* du_part, float* ds0, float* ckpt, int B,
                               int S, int H, int dh, cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int codes[5] = {r_dtype, k_dtype, v_dtype, w_dtype, u_dtype};
  for (int c : codes)
    if (!wkv6io::valid(c)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dh) {
#define WKV6_BWD_CASE(D)                                                                     \
    case D:                                                                                  \
      err = launch<D>(r, k, v, wlog, r_dtype, k_dtype, v_dtype, w_dtype, u_dtype, u, s0, dy, \
                      ds_final, dr, dk, dv, dw, du, du_part, ds0, ckpt, B, S, H, stream);    \
      break;
    WKV6_BWD_CASE(8)
    WKV6_BWD_CASE(16)
    WKV6_BWD_CASE(32)
    WKV6_BWD_CASE(64)
#undef WKV6_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// What the card makes of the kernel at head width dh for B*H = BH clusters:
// out[0..6] = threads a block, dynamic shared bytes a block, blocks a
// cluster, blocks resident per SM, clusters resident on the card (0 for a
// cluster of 1), registers a thread, local (spilled) bytes a thread.
// Returns the CUDA error (0 on success).
extern "C" int wkv6_bwd_occupancy(int dh, int BH, int* out) {
  cudaError_t err;
  switch (dh) {
    case 8: err = occupancy<8>(BH, out); break;
    case 16: err = occupancy<16>(BH, out); break;
    case 32: err = occupancy<32>(BH, out); break;
    case 64: err = occupancy<64>(BH, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
