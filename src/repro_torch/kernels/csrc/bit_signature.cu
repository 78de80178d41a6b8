// Per-address-bit error signatures of count rows, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/bit_signature.py::bit_signature
// (pl.pallas_call at :65): for every row of an (N, R = 2^nbits) int32 count
// matrix and every address bit b, the sum of the counts of the row indices
// with bit b set minus the sum of those with it clear, as (N, nbits) int32.
// Blind discovery (Sec 5.3) ranks and sign-tests these sums.
//
// Arithmetic: int32 that wraps like the reference's (the adds run on
// unsigned words, which wrap by definition; the sum mod 2^32 does not depend
// on the order of the adds), so kernel, plain version and reference agree
// value for value.
//
// Bound: every count is read once and nbits int32 written per row.  At the
// timing shape (N = 262,144, R = 512) that is 546 MB, 0.163 ms at an H100
// SXM's 3.35 TB/s; the +-1 products and adds of the reference's masked
// reduction are N*R*nbits*2 = 2.4e9 int32 operations, 0.145 ms at 16.7e12
// op/s, so it is bound by bytes.  At the blind-discovery path's shape
// (N = 768, R = 512, 1.5 MB) it is bound by the launch.  Design: one warp per
// count row (a grid-stride loop over rows, blocks of kThreads); the lanes
// read the row with coalesced 16-byte loads, four counts at a time.  The four
// indices of a load share every bit above bit 1, so for those bits a lane
// adds or subtracts the four counts' sum once; bits 0 and 1 take their
// two-and-two differences.
// Each lane keeps its nbits partial sums in registers, an xor butterfly of
// warp shuffles totals them, and lane b writes bit b's sum, so the row's
// output leaves in one coalesced store.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBits = 16;
constexpr int kWarp = 32;
// threads a block: a warp a count row whatever the block; 128 and 512 ran
// within 3% of 256 on the H100
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned plus_minus(bool set, unsigned v) {
  return set ? v : 0u - v;
}

__global__ void bit_signature_kernel(const int* __restrict__ counts, int* __restrict__ out,
                                     long long n, int n_rows, int nbits, int vec) {
  const int lane = threadIdx.x % kWarp;
  const long long first = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x / kWarp;
  for (long long row = first; row < n; row += stride) {
    const int* src = counts + row * n_rows;
    unsigned acc[kMaxBits];
#pragma unroll
    for (int b = 0; b < kMaxBits; ++b) acc[b] = 0u;
    if (vec) {
      // four counts per load; c0 is a multiple of 4
      for (int c0 = 4 * lane; c0 < n_rows; c0 += 4 * kWarp) {
        const int4 q = *reinterpret_cast<const int4*>(src + c0);
        const unsigned v0 = q.x, v1 = q.y, v2 = q.z, v3 = q.w;
        acc[0] += (v1 + v3) - (v0 + v2);
        acc[1] += (v2 + v3) - (v0 + v1);
        const unsigned all = (v0 + v1) + (v2 + v3);
#pragma unroll
        for (int b = 2; b < kMaxBits; ++b)
          if (b < nbits) acc[b] += plus_minus((c0 >> b) & 1, all);
      }
    } else {
      for (int c = lane; c < n_rows; c += kWarp) {
        const unsigned v = src[c];
#pragma unroll
        for (int b = 0; b < kMaxBits; ++b)
          if (b < nbits) acc[b] += plus_minus((c >> b) & 1, v);
      }
    }
    unsigned mine = 0u;
#pragma unroll
    for (int b = 0; b < kMaxBits; ++b) {
      if (b < nbits) {
        unsigned s = acc[b];
#pragma unroll
        for (int off = kWarp / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == b) mine = s;
      }
    }
    if (lane < nbits) out[row * nbits + lane] = static_cast<int>(mine);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` (PyTorch's current
// stream) and returns cudaGetLastError() as an int: non-zero means the launch
// was refused and nothing ran.  `vec` says the rows may be read 16 bytes at a
// time (R a multiple of 4 and `counts` 16-byte aligned).
extern "C" int bit_signature_launch(const int* counts, int* out, long long n, int n_rows,
                                    int nbits, int vec, void* stream) {
  if (nbits < 1 || nbits > kMaxBits || n_rows != (1 << nbits))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long warps_per_block = kThreads / kWarp;
  long long blocks = (n + warps_per_block - 1) / warps_per_block;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;   // the rows loop covers the rest
  if (blocks < 1) blocks = 1;
  bit_signature_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(counts, out, n, n_rows, nbits,
                                                              vec);
  return static_cast<int>(cudaGetLastError());
}
