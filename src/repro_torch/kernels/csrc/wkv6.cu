// RWKV-6 WKV recurrence (rwkv6's time-mix hot loop), for Hopper.
//
// wkv6_launch replaces the Pallas TPU kernel repro/kernels/wkv6.py::wkv6
// (pl.pallas_call at :91).  For r, k, v, wlog of shape (B, S, H, dh) and u
// (H, dh), all float32, it runs per (b, h), with the state S (dh x dh):
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * (k_t[i] * v_t[j]))
//   S[i][j] = exp(-exp(wlog_t[i])) * S[i][j] + k_t[i] * v_t[j]
// in the operation order of repro/models/rwkv6.py::wkv6_scan (:54-73), the
// form the model consumes: S starts from init_state (or zeros) and the final
// state is written out, so that prefill can store it and a decode step
// (S = 1) continue from it.  The sum over i runs in order 0..dh-1; the plain
// version's einsum sums in another order, so the two agree to a tolerance,
// not bit for bit.
//
// Bound: HBM sees one read of r, k, v, wlog (4 x B*S*H*dh floats), of u and
// of the start state, and one write of y and of the final state: at the
// prefill shape (8, 512, 32, 64) that is 172.0 MB, 0.0513 ms at an H100
// SXM's 3.35 TB/s.  The function needs 5 fp32 operations per (i, j) and step
// (r.S: a product and its sum; the decay product, the k*v product and the
// add to S) and 8 per i: the u term is rank one, v_j * sum_i r_i u_i k_i,
// and the decay costs a negation and two expf.  That is 5*dh^2 + 8*dh per
// (b, h, t), 2.75 GFLOP at the prefill shape, 0.0411 ms at 67 TFLOP/s, so
// the bound is by bytes.  This kernel does 7 operations per (i, j) (it adds
// u*kv into each term of y's sum, in the plain version's order), but neither
// count limits it: each (b, h) is a chain of S dependent steps, and the sum
// over i is a chain of dh dependent adds, so the kernel is latency-bound
// with a few warps per SM (B*H = 256 blocks of dh threads at the prefill
// shape).
//
// Design: one block per (b, h) with dh threads.  Thread j keeps the state
// column S[:, j] (dh floats) in registers for the whole sequence (dh is a
// template parameter: 8, 16, 32, 64).  At each step the block stages r_t,
// k_t and the decay exp(-exp(wlog_t)) in shared memory (double-buffered, so
// one __syncthreads a step), and each thread reads them as broadcasts and
// writes y_t[j]: no cross-thread reduction.  A (b, t, h) row is dh
// contiguous floats in the (B, S, H, dh) layout, so the per-step loads and
// the store of y coalesce, and the next step's row is loaded into registers
// before the current step's arithmetic to hide the load's latency.  The
// start state is read and the final state written row by row (S[i][:] over
// the threads), also coalesced.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <int kDh>
__global__ void __launch_bounds__(kDh)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ wlog,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int S, int H) {
  __shared__ float sr[2][kDh], sk[2][kDh], sd[2][kDh];
  __shared__ float su[kDh];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;

  float st[kDh];  // st[i] = S[i][j]
  const size_t s_base = static_cast<size_t>(bh) * kDh * kDh + j;
#pragma unroll
  for (int i = 0; i < kDh; ++i) st[i] = s0 ? s0[s_base + static_cast<size_t>(i) * kDh] : 0.0f;
  su[j] = u[h * kDh + j];

  // element (b, t, h, j) of a (B, S, H, dh) tensor
  const size_t row = static_cast<size_t>(H) * kDh;
  size_t at = (static_cast<size_t>(b) * S * H + h) * kDh + j;
  float rn = r[at], kn = k[at], vn = v[at], wn = wlog[at];
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sd[buf][j] = expf(-expf(wn));
    const float vj = vn;
    __syncthreads();
    if (t + 1 < S) {
      const size_t nxt = at + row;
      rn = r[nxt]; kn = k[nxt]; vn = v[nxt]; wn = wlog[nxt];
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kDh; ++i) {
      const float kv = sk[buf][i] * vj;
      acc = acc + sr[buf][i] * (st[i] + su[i] * kv);
      st[i] = sd[buf][i] * st[i] + kv;
    }
    y[at] = acc;
    at += row;
  }
#pragma unroll
  for (int i = 0; i < kDh; ++i) s_out[s_base + static_cast<size_t>(i) * kDh] = st[i];
}

template <int kDh>
void launch(const float* r, const float* k, const float* v, const float* wlog,
            const float* u, const float* s0, float* y, float* s_out, int B,
            int S, int H, cudaStream_t stream) {
  wkv6_kernel<kDh><<<B * H, kDh, 0, stream>>>(r, k, v, wlog, u, s0, y, s_out, S, H);
}

}  // namespace

// r, k, v, wlog, y: (B, S, H, dh) float32, contiguous; u: (H, dh); s0 (or
// null for zeros) and s_out: (B, H, dh, dh).  S >= 1 and B*H >= 1.  Returns
// the CUDA error of the launch (0 on success).
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* wlog, const float* u, const float* s0,
                           float* y, float* s_out, int B, int S, int H, int dh,
                           cudaStream_t stream) {
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 8: launch<8>(r, k, v, wlog, u, s0, y, s_out, B, S, H, stream); break;
    case 16: launch<16>(r, k, v, wlog, u, s0, y, s_out, B, S, H, stream); break;
    case 32: launch<32>(r, k, v, wlog, u, s0, y, s_out, B, S, H, stream); break;
    case 64: launch<64>(r, k, v, wlog, u, s0, y, s_out, B, S, H, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
