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
// so the two agree to a tolerance, not bit for bit.
//
// Bound, at the training shape (B, S, H, dh) = (8, 512, 32, 64): HBM sees one
// read of r, k, v, wlog and dy and one write of the four gradients; in
// float32 that is 302.0 MB, 0.0902 ms at an H100 SXM's 3.35 TB/s (235 MB with
// the training path's bfloat16 k and v).  The function needs 14 fp32
// operations per (i, j) and step (the state's recompute k*v, w*S and the add;
// the sums of dr, dk, dv and dwlog, a product and an add each; the update of
// G, two products and an add) and 21 per i (the decay and its derivative,
// dy.v, r u k, the rank-one terms of dr, dk, dv, dwlog's scale, du): 58,688
// per (b, h, t), 7.69 GFLOP, 0.115 ms at 67 TFLOP/s.  So the bound is by
// operations.
//
// Design: one block per (b, h), 8 dh threads in two groups of 4 dh, 4
// threads a line.  A row thread holds G[i][q*dh/4 ..] and the matching part
// of the state; it computes dr, dk and dwlog (sums over j: its own columns,
// then two shuffles across the 4 threads of the row) and du.  A column thread
// holds G[q*dh/4 ..][j] and computes dv (a sum over i, the same way).  Both
// groups update their copy of G with the same fmaf, so neither waits on the
// other inside a chunk.  The backward needs S_{t-1} in reverse order; it is
// not recovered by dividing by w (w ~ 0.55: rounding would grow over the
// sequence).  Instead a first forward pass writes the state before every
// chunk of kC = 8 steps to a global scratch (B*H x chunks x dh x dh float32,
// read back by the thread that wrote it, interleaved by thread so that a
// warp's access of one value a thread is one 128-byte line: in a row's
// layout each was 32 lines, and the scratch took over half the kernel's
// time), and the reverse pass recomputes a
// chunk's states from it into shared memory: 8 states of dh x dh floats, 144
// KB at dh = 64 (plus 18 KB of staged inputs: one block per SM), laid out so
// that a warp's 32 lanes hit 32 banks.  A chunk's inputs are staged into
// shared memory (one element a thread; each step's 4 column planes padded
// into distinct bank octets), with each step's dy.v and r.u.k summed by a
// butterfly; the next chunk's inputs load into registers while a chunk
// computes.  du is summed over t in registers and over b by a
// second kernel in a fixed order: no atomics, the same bits every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_io.cuh"

namespace {

using wkv6io::load;
using wkv6io::store;

constexpr int kC = 8;                    // steps per chunk: one saved state a chunk
constexpr int kP = 4;                    // threads a row of G (or a column)
constexpr int kLinesPerWarp = 32 / kP;   // rows (columns) a warp holds

template <int kDh>
struct Bwd {
  static constexpr int kW = kDh / kP;                  // columns (rows) a thread holds
  static constexpr int kGroup = kDh * kP;              // threads of each group
  static constexpr int kThreads = 2 * kGroup;
  // a staged step is kP planes of kW values, kQw apart: the 4 planes of a
  // step start in 4 bank octets, so that a warp's 4 q groups reading value x
  // of their plane hit 4 banks (kW = 16 needs the padding)
  static constexpr int kQw = kW == 16 ? 24 : kW;
  static constexpr int kRow = kP * kQw;                // floats a staged step
  // the stride between a step's q planes in the recomputed states: 8 mod 32,
  // so that lane (q, line % 8) of a warp reads bank 8 q + line % 32
  static constexpr int kQs = kDh + ((8 - kDh % 32) + 32) % 32;
  static constexpr int kSegLanes = kDh < 32 ? kDh : 32;   // lanes of a staged partial sum
  static constexpr int kSegs = kDh / kSegLanes;
  static constexpr int kHist = kC * kW * kP * kQs;        // floats of recomputed states
  static constexpr int kStaged = 6 * kC * kRow + 2 * kC * kSegs;
  static constexpr size_t kSmem = (kHist + kStaged) * sizeof(float);
  static_assert(kGroup % 32 == 0, "a group is whole warps");
  static_assert(kThreads == kC * kDh, "one staged element a thread");
};

// where element e of a staged step lies
template <int kDh>
__device__ __forceinline__ int staged(int e) {
  using Sh = Bwd<kDh>;
  return (e / Sh::kW) * Sh::kQw + e % Sh::kW;
}

template <int kDh>
__global__ void __launch_bounds__(Bwd<kDh>::kThreads, 1)
wkv6_bwd_kernel(const void* __restrict__ r, const void* __restrict__ k,
                const void* __restrict__ v, const void* __restrict__ wlog, int code_r,
                int code_k, int code_v, int code_w, const float* __restrict__ u,
                const float* __restrict__ s0, const float* __restrict__ dy,
                const float* __restrict__ ds_final, void* __restrict__ dr,
                void* __restrict__ dk, void* __restrict__ dv, void* __restrict__ dw,
                float* __restrict__ du_part, float* __restrict__ ds0,
                float* __restrict__ ckpt, int S, int H) {
  using Sh = Bwd<kDh>;
  constexpr int kW = Sh::kW, kRow = Sh::kRow;
  constexpr int kMat = kDh * kDh;
  extern __shared__ __align__(16) float smem[];
  float* const hist = smem;                   // [kC][kW][kP][kQs]: row threads' own
  float* const s_r = hist + Sh::kHist;        // the chunk's inputs, [kC][kRow] each
  float* const s_k = s_r + kC * kRow;
  float* const s_v = s_k + kC * kRow;
  float* const s_d = s_v + kC * kRow;         // w = exp(-exp(wlog))
  float* const s_nd = s_d + kC * kRow;        // dw/dwlog = -exp(wlog) w
  float* const s_dy = s_nd + kC * kRow;
  float* const s_dyv = s_dy + kC * kRow;      // [kC][kSegs] partial sums of dy.v
  float* const s_ruk = s_dyv + kC * Sh::kSegs;   // [kC][kSegs] partial sums of r u k

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int n_chunks = (S + kC - 1) / kC;
  // element (b, t, h, i) of a (B, S, H, dh) tensor: base + t * row + i
  const size_t row = static_cast<size_t>(H) * kDh;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * kDh;
  // the staging role: element se of step st of a chunk (tid = st * kDh + se)
  const int st = tid / kDh, se = tid % kDh;
  const int s_at = st * kRow + staged<kDh>(se);
  const float u_se = u[h * kDh + se];
  // the compute role: a row thread holds G[line][q*kW + x] and S likewise, a
  // column thread G[q*kW + x][line]
  const bool is_row = tid < Sh::kGroup;
  const int gt = is_row ? tid : tid - Sh::kGroup;
  const int lane = gt % 32;
  const int line = (gt / 32) * kLinesPerWarp + lane % kLinesPerWarp;
  const int q = lane / kLinesPerWarp;
  const int line_at = staged<kDh>(line), plane = q * Sh::kQw;
  const size_t mat = static_cast<size_t>(bh) * kMat;
  const int mine = line * kDh + q * kW;       // a row thread's first element of a matrix
  // a row thread's saved states: value x of chunk c at (c*kW + x)*kGroup, so
  // that a warp's store or load of one value a thread is one 128-byte line
  float* const ck = ckpt + static_cast<size_t>(bh) * n_chunks * kMat + gt;
  float* const my_hist = hist + q * Sh::kQs + line;   // step tau, x: + (tau*kW + x)*kP*kQs

  // ---- forward: the state before each chunk into the scratch
  float s[kW];
#pragma unroll
  for (int x = 0; x < kW; ++x) s[x] = (is_row && s0) ? s0[mat + mine + x] : 0.0f;
  // the next chunk's k, v, wlog, loaded while this one computes (chunks
  // before the last are whole)
  float fk = 0.0f, fv = 0.0f, fw = 0.0f;
  auto fetch_fwd = [&](int c) {
    const size_t at = base + static_cast<size_t>(c * kC + st) * row + se;
    fk = load(k, code_k, at);
    fv = load(v, code_v, at);
    fw = load(wlog, code_w, at);
  };
  if (n_chunks > 1) fetch_fwd(0);
  for (int c = 0;; ++c) {
    if (is_row) {
#pragma unroll
      for (int x = 0; x < kW; ++x) ck[(static_cast<size_t>(c) * kW + x) * Sh::kGroup] = s[x];
    }
    if (c == n_chunks - 1) break;
    __syncthreads();   // the previous chunk's reads of s_k, s_v, s_d are done
    s_k[s_at] = fk;
    s_v[s_at] = fv;
    s_d[s_at] = expf(-expf(fw));
    if (c + 1 < n_chunks - 1) fetch_fwd(c + 1);
    __syncthreads();
    if (is_row) {
      for (int tau = 0; tau < kC; ++tau) {
        const float d = s_d[tau * kRow + line_at], kk = s_k[tau * kRow + line_at];
        const float* const v_t = s_v + tau * kRow + plane;
#pragma unroll
        for (int x = 0; x < kW; ++x) s[x] = fmaf(d, s[x], kk * v_t[x]);
      }
    }
  }

  // ---- reverse, a chunk at a time from the last
  float g[kW];
#pragma unroll
  for (int x = 0; x < kW; ++x)
    g[x] = ds_final ? ds_final[mat + (is_row ? mine + x : (q * kW + x) * kDh + line)] : 0.0f;
  const float u_line = u[h * kDh + line];
  float du_acc = 0.0f;
  // the next chunk's inputs (zeros past the sequence), loaded ahead
  float pr = 0.0f, pk = 0.0f, pv = 0.0f, pw = 0.0f, pg = 0.0f;
  auto fetch = [&](int c) {
    const int t = c * kC + st;
    pr = pk = pv = pw = pg = 0.0f;
    if (t < S) {
      const size_t at = base + static_cast<size_t>(t) * row + se;
      pr = load(r, code_r, at);
      pk = load(k, code_k, at);
      pv = load(v, code_v, at);
      pw = load(wlog, code_w, at);
      pg = dy[at];
    }
  };
  fetch(n_chunks - 1);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kC, steps = min(kC, S - t0);
    if (is_row) {   // the chunk's saved state, read before the barrier
#pragma unroll
      for (int x = 0; x < kW; ++x) s[x] = ck[(static_cast<size_t>(c) * kW + x) * Sh::kGroup];
    }
    __syncthreads();   // the staging buffers are free
    {
      const float e = expf(pw), d = expf(-e);
      s_r[s_at] = pr;
      s_k[s_at] = pk;
      s_v[s_at] = pv;
      s_d[s_at] = d;
      s_nd[s_at] = -(e * d);
      s_dy[s_at] = pg;
      float dyv = pg * pv, ruk = pr * u_se * pk;
#pragma unroll
      for (int off = Sh::kSegLanes / 2; off > 0; off /= 2) {
        dyv += __shfl_xor_sync(0xffffffffu, dyv, off);
        ruk += __shfl_xor_sync(0xffffffffu, ruk, off);
      }
      if (se % Sh::kSegLanes == 0) {
        s_dyv[st * Sh::kSegs + se / Sh::kSegLanes] = dyv;
        s_ruk[st * Sh::kSegs + se / Sh::kSegLanes] = ruk;
      }
    }
    if (c > 0) fetch(c - 1);   // in flight while this chunk computes
    __syncthreads();
    if (is_row) {
      // S_{t0-1} .. S_{t0+steps-2}, recomputed from the chunk's saved state
      for (int tau = 0; tau < steps; ++tau) {
#pragma unroll
        for (int x = 0; x < kW; ++x) my_hist[(tau * kW + x) * kP * Sh::kQs] = s[x];
        const float d = s_d[tau * kRow + line_at], kk = s_k[tau * kRow + line_at];
        const float* const v_t = s_v + tau * kRow + plane;
#pragma unroll
        for (int x = 0; x < kW; ++x) s[x] = fmaf(d, s[x], kk * v_t[x]);
      }
      for (int tau = steps - 1; tau >= 0; --tau) {
        const float* const dy_t = s_dy + tau * kRow + plane;
        const float* const v_t = s_v + tau * kRow + plane;
        float a = 0.0f, bs = 0.0f, cs = 0.0f;   // dy.S_{t-1}, G.v, G.S_{t-1} over my columns
#pragma unroll
        for (int x = 0; x < kW; ++x) {
          const float sp = my_hist[(tau * kW + x) * kP * Sh::kQs];
          a = fmaf(dy_t[x], sp, a);
          bs = fmaf(g[x], v_t[x], bs);
          cs = fmaf(g[x], sp, cs);
        }
#pragma unroll
        for (int off = kLinesPerWarp; off < 32; off *= 2) {
          a += __shfl_xor_sync(0xffffffffu, a, off);
          bs += __shfl_xor_sync(0xffffffffu, bs, off);
          cs += __shfl_xor_sync(0xffffffffu, cs, off);
        }
        const int at_line = tau * kRow + line_at;
        const float ri = s_r[at_line], ki = s_k[at_line], di = s_d[at_line];
        float dyv = s_dyv[tau * Sh::kSegs];
#pragma unroll
        for (int sg = 1; sg < Sh::kSegs; ++sg) dyv += s_dyv[tau * Sh::kSegs + sg];
        const size_t at = base + static_cast<size_t>(t0 + tau) * row + line;
        if (q == 0) {
          store(dr, code_r, at, fmaf(u_line * ki, dyv, a));
        } else if (q == 1) {
          store(dk, code_k, at, fmaf(ri * u_line, dyv, bs));
        } else if (q == 2) {
          store(dw, code_w, at, s_nd[at_line] * cs);
        } else {
          du_acc = fmaf(ri * ki, dyv, du_acc);
        }
#pragma unroll
        for (int x = 0; x < kW; ++x) g[x] = fmaf(di, g[x], ri * dy_t[x]);
      }
    } else {
      for (int tau = steps - 1; tau >= 0; --tau) {
        const float* const k_t = s_k + tau * kRow + plane;
        const float* const r_t = s_r + tau * kRow + plane;
        const float* const d_t = s_d + tau * kRow + plane;
        const float gyj = s_dy[tau * kRow + line_at];
        float acc = 0.0f;   // k.G over my rows
#pragma unroll
        for (int x = 0; x < kW; ++x) acc = fmaf(k_t[x], g[x], acc);
#pragma unroll
        for (int off = kLinesPerWarp; off < 32; off *= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        float ruk = s_ruk[tau * Sh::kSegs];
#pragma unroll
        for (int sg = 1; sg < Sh::kSegs; ++sg) ruk += s_ruk[tau * Sh::kSegs + sg];
        if (q == 0)
          store(dv, code_v, base + static_cast<size_t>(t0 + tau) * row + line,
                fmaf(gyj, ruk, acc));
#pragma unroll
        for (int x = 0; x < kW; ++x) g[x] = fmaf(d_t[x], g[x], r_t[x] * gyj);
      }
    }
  }
  if (is_row && ds0) {
#pragma unroll
    for (int x = 0; x < kW; ++x) ds0[mat + mine + x] = g[x];
  }
  if (is_row && q == kP - 1) du_part[static_cast<size_t>(bh) * kDh + line] = du_acc;
}

// du[n] = sum over b of du_part[b][n], b in order, n = h * dh + i
__global__ void wkv6_du_kernel(const float* __restrict__ du_part, void* __restrict__ du,
                               int code_u, int B, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<size_t>(b) * n + idx];
  store(du, code_u, idx, acc);
}

template <int kDh>
cudaError_t launch(const void* r, const void* k, const void* v, const void* wlog, int cr,
                   int ck, int cv, int cw, int cu, const float* u, const float* s0,
                   const float* dy, const float* ds_final, void* dr, void* dk, void* dv,
                   void* dw, void* du, float* du_part, float* ds0, float* ckpt, int B, int S,
                   int H, cudaStream_t stream) {
  using Sh = Bwd<kDh>;
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<kDh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(Sh::kSmem));
  if (err != cudaSuccess) return err;
  wkv6_bwd_kernel<kDh><<<B * H, Sh::kThreads, Sh::kSmem, stream>>>(
      r, k, v, wlog, cr, ck, cv, cw, u, s0, dy, ds_final, dr, dk, dv, dw, du_part, ds0, ckpt,
      S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * kDh;
  wkv6_du_kernel<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, cu, B, n);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, wlog, dy, dr, dk, dv, dw: (B, S, H, dh), contiguous; r..wlog each
// float32 (dtype code 0), float16 (1) or bfloat16 (2), and dr..dw in the code
// of their input; dy float32.  u: (H, dh) float32, its gradient du written in
// code u_dtype.  s0 and ds_final (either may be null for zeros) and ds0 (null
// when no start state was given): (B, H, dh, dh) float32.  du_part: (B, H, dh)
// float32 scratch; ckpt: (B, H, ceil(S / 8), dh, dh) float32 scratch.  S >= 1
// and B*H >= 1.  Returns the CUDA error of the launches (0 on success).
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
