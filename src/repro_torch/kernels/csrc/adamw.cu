// The train step's global-norm clip and AdamW update, for Hopper.
//
// Replaces no Pallas kernel: the reference's clip and AdamW
// (repro/optim/optimizers.py: clip_by_global_norm, adamw) are jnp that XLA
// fuses inside the jitted step.  Run as eager PyTorch ops, the same update
// takes ~16 passes a leaf with a temporary each (152 bytes an element) and
// the clip 20 more (the squares, their sums, a scaled copy of every leaf).
//
// Bound: bytes.  The norm reads each gradient once (4 bytes a float32
// element); the update reads g, p, m, v and writes p, m, v once (28 bytes):
// 32 bytes an element over the two passes, 47.5 GB for RWKV-6 1.6B's 1.48B
// float32 parameters, 14.2 ms at an H100 SXM's 3.35 TB/s.  The ~20 float32
// operations an element are far below the card's rate.
//
// Design.  Both passes walk a table of leaves passed by value (up to
// kMaxLeaves a launch: one launch for a model's ~20 layer-stacked leaves),
// each block a fixed chunk of one leaf, so that every SM is busy whatever
// the leaves' sizes.  A thread moves 4 elements at a time: 16-byte loads and
// stores of float32 (8-byte of bfloat16) where the leaf's pointers allow,
// scalar ones otherwise and at a leaf's tail.
//
// sq_partials_kernel sums a chunk's squares in double (the square of a float
// is exact there), each thread in order, then the warps by a fixed shuffle
// tree and the warps in order: one partial a block.  norm_finish_kernel, one
// block, sums the partials in a fixed order and writes the norm, sqrt of
// the sum rounded to float32, and the clip's scale as clip_to_norm computes
// it, min(max_norm * (1 / max(norm, 1e-9)), 1) (PyTorch's scalar / tensor is
// a reciprocal and a product), NaN kept.  No atomics: the same bits every
// run.
//
// adamw_kernel scales g by the clip's scale in registers (rounded back to
// bfloat16 for a bfloat16 leaf, as clip_to_norm keeps each leaf's dtype),
// then runs AdamW in the plain version's float32 order with round-to-nearest
// intrinsics (nothing contracted into an FMA; the build passes -fmad=false
// too):
//   m = b1 m + (1 - b1) g;   v = b2 v + ((1 - b2) g) g
//   u = (m / bc1) / (sqrt(v / bc2) + eps)  [+ wd p where the leaf has ndim >= 2]
//   p = p - lr u
// so that p, m and v equal the eager update's bits given the same scale.
// lr, bc1, bc2 and the scale are 0-d float32 tensors on the card, read by
// pointer: the step reads nothing back to the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0;    // the wrappers' dtype codes (kernels/wkv6.py's)
constexpr int kBF16 = 2;
constexpr int kMaxLeaves = 32;   // leaves a launch: the table stays under 4 KB
constexpr int kVec = 4;          // elements a load
constexpr int kSqThreads = 256;   // another block would sum the squares in another order
constexpr int kSqIters = 16;     // vectors a thread: a chunk of 16,384 elements
constexpr long long kSqChunk = static_cast<long long>(kSqThreads) * kVec * kSqIters;
// threads a block of the update: 128 and 512 ran within 1% of 256 at
// rwkv6-1.6b's leaves on the H100 (14.7-15.1 ms)
constexpr int kAdamThreads = 256;
constexpr int kAdamIters = 8;    // vectors a thread: a chunk of 8,192 elements
constexpr long long kAdamChunk = static_cast<long long>(kAdamThreads) * kVec * kAdamIters;
constexpr int kFinishThreads = 1024;

struct SqTable {
  const void* g[kMaxLeaves];
  long long n[kMaxLeaves];
  long long first[kMaxLeaves + 1];   // each leaf's first block of the launch
  int dtype[kMaxLeaves];
  int vec[kMaxLeaves];               // 1: the leaf takes 4-element loads
  int count;
};

struct AdamTable {
  const void* g[kMaxLeaves];
  const void* p[kMaxLeaves];
  const float* m[kMaxLeaves];
  const float* v[kMaxLeaves];
  void* p_out[kMaxLeaves];
  float* m_out[kMaxLeaves];
  float* v_out[kMaxLeaves];
  long long n[kMaxLeaves];
  long long first[kMaxLeaves + 1];
  signed char g_dtype[kMaxLeaves];
  signed char p_dtype[kMaxLeaves];
  signed char decay[kMaxLeaves];
  signed char vec[kMaxLeaves];
  int count;
};

// b1, 1 - b1, b2, 1 - b2, eps and the weight decay, each the float32 that
// PyTorch makes of the Python scalar; the rest 0-d tensors on the card (the
// scale null: no clip)
struct AdamConsts {
  float b1, c1, b2, c2, eps, wd;
  const float* lr;
  const float* bc1;
  const float* bc2;
  const float* scale;
};

template <typename Table>
__device__ __forceinline__ int leaf_of(const Table& t, long long block) {
  int i = 0;
  while (i + 1 < t.count && t.first[i + 1] <= block) ++i;
  return i;
}

__device__ __forceinline__ float bf16_bits(unsigned bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ unsigned to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_bf16(float x) {
  return bf16_bits(to_bf16_bits(x));
}

__device__ __forceinline__ float load1(const void* base, int dtype, long long e) {
  if (dtype == kF32) return __ldg(static_cast<const float*>(base) + e);
  return bf16_bits(__ldg(static_cast<const unsigned short*>(base) + e));
}

__device__ __forceinline__ void load4(const void* base, int dtype, long long e, float x[4]) {
  if (dtype == kF32) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(base) + e));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    const uint2 q = __ldg(
        reinterpret_cast<const uint2*>(static_cast<const unsigned short*>(base) + e));
    x[0] = bf16_bits(q.x & 0xFFFFu);
    x[1] = __uint_as_float(q.x & 0xFFFF0000u);
    x[2] = bf16_bits(q.y & 0xFFFFu);
    x[3] = __uint_as_float(q.y & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store1(void* base, int dtype, long long e, float x) {
  if (dtype == kF32)
    static_cast<float*>(base)[e] = x;
  else
    static_cast<unsigned short*>(base)[e] = static_cast<unsigned short>(to_bf16_bits(x));
}

__device__ __forceinline__ void store4(void* base, int dtype, long long e, const float x[4]) {
  if (dtype == kF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + e) =
        make_float4(x[0], x[1], x[2], x[3]);
  } else {
    uint2 q;
    q.x = to_bf16_bits(x[0]) | (to_bf16_bits(x[1]) << 16);
    q.y = to_bf16_bits(x[2]) | (to_bf16_bits(x[3]) << 16);
    *reinterpret_cast<uint2*>(static_cast<unsigned short*>(base) + e) = q;
  }
}

// -------------------------------------------------------------- the norm

__device__ __forceinline__ double sq(float x) {
  return static_cast<double>(x) * static_cast<double>(x);
}

// the block's sum of `acc`, in a fixed order, in thread 0
template <int kThreads>
__device__ __forceinline__ double block_sum(double acc) {
  __shared__ double warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

__global__ void __launch_bounds__(kSqThreads)
    sq_partials_kernel(SqTable t, long long base, double* __restrict__ partials) {
  const long long block = blockIdx.x;
  const int i = leaf_of(t, block);
  const long long lo = (block - t.first[i]) * kSqChunk;
  const long long hi = min(lo + kSqChunk, t.n[i]);
  const void* g = t.g[i];
  const int dtype = t.dtype[i];
  double acc = 0.0;
  if (t.vec[i]) {
    for (int it = 0; it < kSqIters; ++it) {
      const long long e = lo + (static_cast<long long>(it) * kSqThreads + threadIdx.x) * kVec;
      if (e >= hi) break;
      if (e + kVec <= hi) {
        float x[4];
        load4(g, dtype, e, x);
        acc += sq(x[0]);
        acc += sq(x[1]);
        acc += sq(x[2]);
        acc += sq(x[3]);
      } else {
        for (long long k = e; k < hi; ++k) acc += sq(load1(g, dtype, k));
      }
    }
  } else {
    for (long long e = lo + threadIdx.x; e < hi; e += kSqThreads) acc += sq(load1(g, dtype, e));
  }
  const double total = block_sum<kSqThreads>(acc);
  if (threadIdx.x == 0) partials[base + block] = total;
}

__global__ void __launch_bounds__(kFinishThreads)
    norm_finish_kernel(const double* __restrict__ partials, long long count, float max_norm,
                       float* __restrict__ out) {
  double acc = 0.0;
  for (long long j = threadIdx.x; j < count; j += kFinishThreads) acc += partials[j];
  const double total = block_sum<kFinishThreads>(acc);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(static_cast<float>(total));
    const float floor = isnan(norm) ? norm : fmaxf(norm, 1e-9f);
    const float scale = __fmul_rn(__frcp_rn(floor), max_norm);
    out[0] = norm;
    out[1] = isnan(scale) ? scale : fminf(scale, 1.0f);
  }
}

// -------------------------------------------------------------- the update

struct Scalars {
  float lr, bc1, bc2, scale;
  bool clip;
};

__device__ __forceinline__ void adam_one(float g, float p, float& m, float& v, float& p_new,
                                         const AdamConsts& c, const Scalars& s, bool g_bf16,
                                         bool decay) {
  if (s.clip) {
    g = __fmul_rn(g, s.scale);
    if (g_bf16) g = round_bf16(g);
  }
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.c1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.c2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), c.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(c.wd, p));
  p_new = __fsub_rn(p, __fmul_rn(s.lr, u));
}

__global__ void __launch_bounds__(kAdamThreads) adamw_kernel(AdamTable t, AdamConsts c) {
  const long long block = blockIdx.x;
  const int i = leaf_of(t, block);
  const long long lo = (block - t.first[i]) * kAdamChunk;
  const long long hi = min(lo + kAdamChunk, t.n[i]);
  Scalars s;
  s.lr = __ldg(c.lr);
  s.bc1 = __ldg(c.bc1);
  s.bc2 = __ldg(c.bc2);
  s.clip = c.scale != nullptr;
  s.scale = s.clip ? __ldg(c.scale) : 1.0f;
  const void* g = t.g[i];
  const void* p = t.p[i];
  const float* m = t.m[i];
  const float* v = t.v[i];
  void* p_out = t.p_out[i];
  float* m_out = t.m_out[i];
  float* v_out = t.v_out[i];
  const int gd = t.g_dtype[i], pd = t.p_dtype[i];
  const bool g_bf16 = gd == kBF16, decay = t.decay[i] != 0;

  auto one = [&](long long e) {
    float mi = __ldg(m + e), vi = __ldg(v + e), pn;
    adam_one(load1(g, gd, e), load1(p, pd, e), mi, vi, pn, c, s, g_bf16, decay);
    store1(p_out, pd, e, pn);
    m_out[e] = mi;
    v_out[e] = vi;
  };

  if (t.vec[i]) {
    for (int it = 0; it < kAdamIters; ++it) {
      const long long e = lo + (static_cast<long long>(it) * kAdamThreads + threadIdx.x) * kVec;
      if (e >= hi) break;
      if (e + kVec <= hi) {
        float gx[4], px[4], pn[4];
        load4(g, gd, e, gx);
        load4(p, pd, e, px);
        float4 m4 = __ldg(reinterpret_cast<const float4*>(m + e));
        float4 v4 = __ldg(reinterpret_cast<const float4*>(v + e));
        adam_one(gx[0], px[0], m4.x, v4.x, pn[0], c, s, g_bf16, decay);
        adam_one(gx[1], px[1], m4.y, v4.y, pn[1], c, s, g_bf16, decay);
        adam_one(gx[2], px[2], m4.z, v4.z, pn[2], c, s, g_bf16, decay);
        adam_one(gx[3], px[3], m4.w, v4.w, pn[3], c, s, g_bf16, decay);
        store4(p_out, pd, e, pn);
        *reinterpret_cast<float4*>(m_out + e) = m4;
        *reinterpret_cast<float4*>(v_out + e) = v4;
      } else {
        for (long long k = e; k < hi; ++k) one(k);
      }
    }
  } else {
    for (long long e = lo + threadIdx.x; e < hi; e += kAdamThreads) one(e);
  }
}

bool aligned(const void* ptr, int dtype) {
  const uintptr_t need = dtype == kF32 ? 16 : 8;   // 4 elements
  return (reinterpret_cast<uintptr_t>(ptr) & (need - 1)) == 0;
}

bool valid(int dtype) { return dtype == kF32 || dtype == kBF16; }

long long blocks_of(long long n, long long chunk) { return (n + chunk - 1) / chunk; }

int launch_adamw(int n_leaves, const void* const* g, const void* const* p, const void* const* m,
                 const void* const* v, void* const* p_out, void* const* m_out,
                 void* const* v_out, const long long* n, const int* g_dtype,
                 const int* p_dtype, const int* decay, const AdamConsts& c,
                 cudaStream_t stream) {
  for (int lo = 0; lo < n_leaves; lo += kMaxLeaves) {
    AdamTable t;
    t.count = 0;
    long long blocks = 0;
    for (int j = lo; j < n_leaves && j < lo + kMaxLeaves; ++j) {
      const int k = t.count++;
      t.g[k] = g[j];
      t.p[k] = p[j];
      t.m[k] = static_cast<const float*>(m[j]);
      t.v[k] = static_cast<const float*>(v[j]);
      t.p_out[k] = p_out[j];
      t.m_out[k] = static_cast<float*>(m_out[j]);
      t.v_out[k] = static_cast<float*>(v_out[j]);
      t.n[k] = n[j];
      t.g_dtype[k] = static_cast<signed char>(g_dtype[j]);
      t.p_dtype[k] = static_cast<signed char>(p_dtype[j]);
      t.decay[k] = static_cast<signed char>(decay[j] != 0);
      t.vec[k] = aligned(g[j], g_dtype[j]) && aligned(p[j], p_dtype[j]) &&
                 aligned(p_out[j], p_dtype[j]) && aligned(m[j], kF32) && aligned(v[j], kF32) &&
                 aligned(m_out[j], kF32) && aligned(v_out[j], kF32);
      t.first[k] = blocks;
      blocks += blocks_of(n[j], kAdamChunk);
    }
    t.first[t.count] = blocks;
    if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    adamw_kernel<<<static_cast<unsigned>(blocks), kAdamThreads, 0, stream>>>(t, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Plain C entry points for ctypes.  Every leaf is contiguous, non-empty and
// lies on the current device; dtypes are 0 (float32) or 2 (bfloat16).  Each
// launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int: non-zero means the launch was refused.

// The gradients' global norm and the clip's scale: out[0] = norm, out[1] =
// scale (float32, on the card).  `partials` holds n_partials doubles, the
// number of 16,384-element chunks of all leaves (the wrapper's count is
// checked here).  ceil(n_leaves / 32) + 1 launches.
extern "C" int grad_sq_norm_launch(int n_leaves, const void* const* g, const long long* n,
                                   const int* dtype, double* partials, long long n_partials,
                                   float max_norm, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long base = 0;
  for (int lo = 0; lo < n_leaves; lo += kMaxLeaves) {
    SqTable t;
    t.count = 0;
    long long blocks = 0;
    for (int j = lo; j < n_leaves && j < lo + kMaxLeaves; ++j) {
      if (n[j] <= 0 || !valid(dtype[j])) return static_cast<int>(cudaErrorInvalidValue);
      const int k = t.count++;
      t.g[k] = g[j];
      t.n[k] = n[j];
      t.dtype[k] = dtype[j];
      t.vec[k] = aligned(g[j], dtype[j]);
      t.first[k] = blocks;
      blocks += blocks_of(n[j], kSqChunk);
    }
    t.first[t.count] = blocks;
    if (base + blocks > n_partials || blocks > 0x7FFFFFFFLL)
      return static_cast<int>(cudaErrorInvalidValue);
    sq_partials_kernel<<<static_cast<unsigned>(blocks), kSqThreads, 0, s>>>(t, base, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    base += blocks;
  }
  if (base != n_partials) return static_cast<int>(cudaErrorInvalidValue);
  norm_finish_kernel<<<1, kFinishThreads, 0, s>>>(partials, n_partials, max_norm, out);
  return static_cast<int>(cudaGetLastError());
}

// AdamW over n_leaves leaves: p, g in float32 or bfloat16 (their own), m and
// v float32; new p (p's dtype), m and v written to the *_out buffers.
// decay[j]: the leaf has ndim >= 2.  b1, c1 = 1 - b1, b2, c2 = 1 - b2, eps
// and wd as float32; lr, bc1, bc2 and scale (null: no clip) 0-d float32
// tensors.  ceil(n_leaves / 32) launches.
extern "C" int adamw_launch(int n_leaves, const void* const* g, const void* const* p,
                            const void* const* m, const void* const* v, void* const* p_out,
                            void* const* m_out, void* const* v_out, const long long* n,
                            const int* g_dtype, const int* p_dtype, const int* decay, float b1,
                            float c1, float b2, float c2, float eps, float wd, const float* lr,
                            const float* bc1, const float* bc2, const float* scale,
                            void* stream) {
  for (int j = 0; j < n_leaves; ++j)
    if (n[j] <= 0 || !valid(g_dtype[j]) || !valid(p_dtype[j]))
      return static_cast<int>(cudaErrorInvalidValue);
  const AdamConsts c{b1, c1, b2, c2, eps, wd, lr, bc1, bc2, scale};
  return launch_adamw(n_leaves, g, p, m, v, p_out, m_out, v_out, n, g_dtype, p_dtype, decay, c,
                      static_cast<cudaStream_t>(stream));
}
