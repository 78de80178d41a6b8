// SECDED(72,64) check bits and syndromes of the Hsiao code, for Hopper.
//
// Replaces the Pallas TPU kernels repro/kernels/secded.py::encode_checks
// (:56, pl.pallas_call at :60) and ::syndrome (:73, pl.pallas_call at :77).
// The TPU kernels compute (x @ H) % 2 on the matrix unit; here each thread
// owns one codeword and accumulates the parity of (x & 1) by XOR of the
// 8-bit column masks of H, which equals the product mod 2 for 0/1 inputs and
// is exact integer work: the kernel equals the plain version bit for bit.
//
// Bound: the kernels read N*W int32 bits and write N*8 int32 (W = 64 or 72)
// and do three integer operations per bit, so they are bound by bytes:
// 0.983 GB for the Fig 17 syndrome (N = 3,072,000, W = 72), 0.29 ms at an
// H100 SXM's 3.35 TB/s; 2.42 GB for a 64 MiB blob's encode (N = 8,388,608,
// W = 64), 0.72 ms.  Design: a block stages its kRows (128) codewords (one
// per thread) in shared memory with coalesced 16-byte loads -- a thread
// reading its own 72 int32 straight from device memory would stride by
// 288 B -- padded to W + 1 words a row so that the per-thread walk over
// its row hits 32 distinct banks.  H lives in __constant__ memory; every
// thread of a warp reads the same mask at the same step (broadcast).  Each
// thread writes its 8 outputs with two 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDataBits = 64;
constexpr int kCheckBits = 8;
// codewords a block, one per thread (the kernel's kRows).  The staged tile is
// kRows x (W + 1) int32 of static shared memory (37 KB at 128 and W = 72):
// more rows would need dynamic shared memory; 32 and 64 ran within 1.5% of
// 128 on the H100
constexpr int kBlockRows = 128;

// Row i of H_DATA (repro_torch/core/ecc.py::_hsiao_columns) as an 8-bit
// mask, bit j = H_DATA[i, j]: the 56 weight-3 columns, then the first 8
// weight-5 columns, in itertools.combinations order.  The 8 check-bit rows
// of H_FULL are the identity (mask 1 << j).  tests/test_torch_secded_shuffle.py
// holds this table against core/ecc.py's H_DATA, and tests/test_torch_ecc.py
// that against the reference's.
__constant__ unsigned char kHData[kDataBits] = {
    0x07, 0x0B, 0x13, 0x23, 0x43, 0x83, 0x0D, 0x15, 0x25, 0x45, 0x85, 0x19, 0x29,
    0x49, 0x89, 0x31, 0x51, 0x91, 0x61, 0xA1, 0xC1, 0x0E, 0x16, 0x26, 0x46, 0x86,
    0x1A, 0x2A, 0x4A, 0x8A, 0x32, 0x52, 0x92, 0x62, 0xA2, 0xC2, 0x1C, 0x2C, 0x4C,
    0x8C, 0x34, 0x54, 0x94, 0x64, 0xA4, 0xC4, 0x38, 0x58, 0x98, 0x68, 0xA8, 0xC8,
    0x70, 0xB0, 0xD0, 0xE0, 0x1F, 0x2F, 0x4F, 0x8F, 0x37, 0x57, 0x97, 0x67};

// W = 64: data bits -> check bits (encode); W = 72: codeword -> syndrome.
template <int W, int kRows>
__global__ void __launch_bounds__(kRows) parity_kernel(const int* __restrict__ x,
                                                       int* __restrict__ out,
                                                       long long n) {
  constexpr int kPitch = W + 1;
  __shared__ int tile[kRows * kPitch];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows), n - row0));
  const int* src = x + row0 * W;
  const int count = rows * W;   // a multiple of 4: W is
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (int q = threadIdx.x; q < count / 4; q += kRows) {
      const int4 v = __ldg(src4 + q);
      const int e = q * 4;
      int* dst = tile + (e / W) * kPitch + (e % W);   // 4 | W: one row
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < count; e += kRows)
      tile[(e / W) * kPitch + (e % W)] = __ldg(src + e);
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= rows) return;

  const int* mine = tile + threadIdx.x * kPitch;
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const unsigned mask = i < kDataBits ? kHData[i] : (1u << (i - kDataBits));
    acc ^= (0u - static_cast<unsigned>(mine[i] & 1)) & mask;
  }
  int4* dst = reinterpret_cast<int4*>(out + (row0 + threadIdx.x) * kCheckBits);
  dst[0] = make_int4(acc & 1, (acc >> 1) & 1, (acc >> 2) & 1, (acc >> 3) & 1);
  dst[1] = make_int4((acc >> 4) & 1, (acc >> 5) & 1, (acc >> 6) & 1, (acc >> 7) & 1);
}

template <int W, int kRows>
int launch(const int* x, int* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kRows - 1) / kRows;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  parity_kernel<W, kRows><<<static_cast<unsigned>(blocks), kRows, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  `x` is (n, 64) or (n, 72) contiguous
// int32 and `out` (n, 8) contiguous int32, 16-byte aligned (the wrapper
// allocates it).  Each launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError() as an int: non-zero means nothing ran.
extern "C" int secded_encode_launch(const int* x, int* out, long long n, void* stream) {
  return launch<kDataBits, kBlockRows>(x, out, n, stream);
}

extern "C" int secded_syndrome_launch(const int* x, int* out, long long n, void* stream) {
  return launch<kDataBits + kCheckBits, kBlockRows>(x, out, n, stream);
}
