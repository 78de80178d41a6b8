// Reading and writing the wkv6 kernels' tensors in their own dtypes: float32
// (code 0), float16 (1) or bfloat16 (2), the codes of kernels/wkv6.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace wkv6io {

enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

__host__ __device__ __forceinline__ bool valid(int code) { return code >= kF32 && code <= kBF16; }

// the raw 16- or 32-bit word of element idx
__device__ __forceinline__ uint32_t load_raw(const void* p, int code, size_t idx) {
  if (code == kF32) return __ldg(static_cast<const unsigned int*>(p) + idx);
  return __ldg(static_cast<const unsigned short*>(p) + idx);
}

// a raw word widened to float32 (exact)
__device__ __forceinline__ float widen(uint32_t bits, int code) {
  if (code == kF32) return __uint_as_float(bits);
  if (code == kF16) return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
  return __uint_as_float(bits << 16);   // bfloat16: the high half of a float32
}

__device__ __forceinline__ float load(const void* p, int code, size_t idx) {
  return widen(load_raw(p, code, idx), code);
}

// x rounded to nearest even in the dtype, as torch's .to(dtype) rounds
__device__ __forceinline__ void store(void* p, int code, size_t idx, float x) {
  if (code == kF32) {
    static_cast<float*>(p)[idx] = x;
  } else if (code == kF16) {
    static_cast<__half*>(p)[idx] = __float2half_rn(x);
  } else {
    static_cast<__nv_bfloat16*>(p)[idx] = __float2bfloat16_rn(x);
  }
}

// x[0..3] into elements idx .. idx + 3, rounded as store() rounds: one
// 16-byte store in float32, one 8-byte store in a 16-bit dtype (idx a
// multiple of 4, the tensor 16-byte aligned)
__device__ __forceinline__ void store4(void* p, int code, size_t idx, const float* x) {
  if (code == kF32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + idx) = make_float4(x[0], x[1], x[2], x[3]);
    return;
  }
  uint2 w;
  if (code == kF16) {
    const __half2 lo = __floats2half2_rn(x[0], x[1]), hi = __floats2half2_rn(x[2], x[3]);
    w.x = *reinterpret_cast<const unsigned int*>(&lo);
    w.y = *reinterpret_cast<const unsigned int*>(&hi);
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    w.x = *reinterpret_cast<const unsigned int*>(&lo);
    w.y = *reinterpret_cast<const unsigned int*>(&hi);
  }
  *reinterpret_cast<uint2*>(static_cast<unsigned short*>(p) + idx) = w;
}

}  // namespace wkv6io
