// Shared device helpers of the port's Hopper kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (`kernels/build.py`)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// masked logit of the reference kernels (not -inf: a fully masked row
// stays finite, exactly as the Pallas kernels behave)
constexpr float kNegInf = -1e30f;
constexpr float kMinDenom = 1e-30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
// round to nearest even, as torch's float -> bfloat16 cast
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared-memory row pitch for a [rows][D] float tile read one row per
// lane: an odd pitch puts the 32 lanes' rows on 32 different banks
__host__ __device__ __forceinline__ int odd_pitch(int D) {
  return (D % 2 == 0) ? D + 1 : D;
}

// head-dim values each lane owns in the P.V accumulator: ceil(D / 32)
// rounded up to the next instantiated width (D <= 256)
inline int lane_width(int D) {
  if (D <= 32) return 1;
  if (D <= 64) return 2;
  if (D <= 128) return 4;
  if (D <= 256) return 8;
  return 0;
}

// opt a kernel into more than 48 KB of dynamic shared memory
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
