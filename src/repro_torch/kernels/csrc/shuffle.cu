// DIVA Shuffling and every other 576-lane burst permutation, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/shuffle.py::_permute (:64,
// pl.pallas_call at :69), reached through apply_shuffle (:90).  The TPU
// kernel multiplies each (tile, 576) block of bursts by a 576x576 0/1
// permutation matrix, because the TPU's vector unit has no cheap gather.
// Hopper gathers from shared memory at full speed, so here the permutation
// is a gather: out[n, i] = x[n, perm[i]].  Integer moves only: the kernel
// equals the plain version x[:, perm] bit for bit.
//
// Bound: it reads and writes N*576 int32 and computes nothing, so it is bound
// by bytes: 0.885 GB for one Fig 17 shuffle (N = 192,000), 0.26 ms at an H100
// SXM's 3.35 TB/s.  Design: the permutation (as int32) sits in shared memory
// once per block; a block walks tiles of kTileRows bursts (8, 18 KB),
// loading each tile with coalesced 16-byte loads and writing each output
// tile with coalesced 16-byte stores of four lanes gathered from the staged
// tile.  Blocks are persistent (kBlocksPerSm per SM, grid-stride over the
// tiles), so the permutation is read from device memory once per block, not
// once per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 576;        // 9 chips x 64 burst bits
constexpr int kThreads = 256;
// bursts a tile (the kernel's kTileRows): the tile is static shared memory,
// so 16 bursts (36 KB) is the most it takes
constexpr int kTileBursts = 8;
// persistent blocks an SM: at 192,000 bursts on the H100, 0.365 ms against
// 0.390 at 8 blocks an SM, in each of 10 alternating pairs
constexpr int kBlocksPerSm = 4;

// kTileRows bursts per tile
template <int kTileRows>
__global__ void __launch_bounds__(kThreads) permute_kernel(const int* __restrict__ x,
                                                           const long long* __restrict__ perm,
                                                           int* __restrict__ out,
                                                           long long n) {
  __shared__ int s_perm[kLanes];
  __shared__ int tile[kTileRows * kLanes];
  for (int i = threadIdx.x; i < kLanes; i += kThreads) s_perm[i] = static_cast<int>(perm[i]);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long row0 = t * kTileRows;
    const int rows = static_cast<int>(min(static_cast<long long>(kTileRows), n - row0));
    const int count = rows * kLanes;   // a multiple of 4: 576 is
    const int* src = x + row0 * kLanes;
    int* dst = out + row0 * kLanes;
    __syncthreads();   // s_perm written / the previous tile fully read
    if (aligned) {
      const int4* src4 = reinterpret_cast<const int4*>(src);
      int4* tile4 = reinterpret_cast<int4*>(tile);
      for (int q = threadIdx.x; q < count / 4; q += kThreads) tile4[q] = __ldg(src4 + q);
    } else {
      for (int e = threadIdx.x; e < count; e += kThreads) tile[e] = __ldg(src + e);
    }
    __syncthreads();
    if (aligned) {
      int4* dst4 = reinterpret_cast<int4*>(dst);
      for (int q = threadIdx.x; q < count / 4; q += kThreads) {
        const int e = q * 4;
        const int* row = tile + (e / kLanes) * kLanes;   // 4 | 576: one row
        const int c = e % kLanes;
        dst4[q] = make_int4(row[s_perm[c]], row[s_perm[c + 1]], row[s_perm[c + 2]],
                            row[s_perm[c + 3]]);
      }
    } else {
      for (int e = threadIdx.x; e < count; e += kThreads)
        dst[e] = tile[(e / kLanes) * kLanes + s_perm[e % kLanes]];
    }
  }
}

template <int kTileRows>
int launch(const int* x, const long long* perm, int* out, long long n, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  long long blocks = static_cast<long long>(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > n_tiles) blocks = n_tiles;
  permute_kernel<kTileRows><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, perm, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  `x` and `out` are (n, 576) contiguous
// int32; `perm` is 576 int64 on the device, a permutation of 0..575 (the
// wrapper checks it).  Launches on `stream` (PyTorch's current stream) and
// returns cudaGetLastError() as an int: non-zero means nothing ran.
extern "C" int diva_shuffle_launch(const int* x, const long long* perm, int* out, long long n,
                                   void* stream) {
  if (n <= 0) return 0;
  return launch<kTileBursts>(x, perm, out, n, static_cast<cudaStream_t>(stream));
}
