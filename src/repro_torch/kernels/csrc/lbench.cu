// LBench: the paper's FMA chain `beta = beta * x + alpha`, the roofline
// and interference probe (paper Sec 3.2, Fig 11).
//
// Replaces: src/repro/kernels/lbench/lbench.py `lbench_pallas` (one
// (block_rows, 128) VMEM tile per grid step, the chain unrolled at trace
// time).
//
// Bound: bytes below the ridge, operations above it. Each element is read
// once and written once (8 bytes in float32) and takes nflop flops, so the
// least time on the H100 is max(8 * n / 3.35e12, nflop * n / 67e12) s
// (float32 FMA outside the tensor cores): the ridge is at 20 flop/B,
// nflop = 160.
//
// Design: a grid-stride loop over 16-byte float4 loads and stores, so the
// memory side streams at full width; each thread carries four independent
// chains in registers (one per lane of the float4), which gives the FMA
// pipes four instructions in flight per thread on the compute side. The
// chain is written as fmaf, one FFMA per iteration (2 flops in the model),
// unrolled by 16 like the paper's `#pragma GCC unroll 16`. Any element
// count works: the elements past the last whole float4 (or all of them,
// for a pointer that is not 16-byte aligned) go through a scalar loop. It
// computes in float32 only and is out of place, like the reference.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;  // 8 resident blocks per SM

__device__ __forceinline__ float chain(float x, int half, bool odd,
                                       float alpha) {
  float b = odd ? x + alpha : x;
#pragma unroll 16
  for (int i = 0; i < half; ++i) b = fmaf(b, x, alpha);
  return b;
}

__global__ void __launch_bounds__(kThreads)
    lbench_kernel(const float* __restrict__ a, float* __restrict__ out,
                  long long n, long long n4, int half, bool odd,
                  float alpha) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    const float4 x = a4[i];
    float4 b = x;
    if (odd) {
      b.x += alpha;
      b.y += alpha;
      b.z += alpha;
      b.w += alpha;
    }
#pragma unroll 16
    for (int k = 0; k < half; ++k) {
      b.x = fmaf(b.x, x.x, alpha);
      b.y = fmaf(b.y, x.y, alpha);
      b.z = fmaf(b.z, x.z, alpha);
      b.w = fmaf(b.w, x.w, alpha);
    }
    o4[i] = b;
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride)
    out[i] = chain(a[i], half, odd, alpha);
}

}  // namespace

// a and out: n contiguous float32 on the device. Returns
// cudaGetLastError() of the launch.
extern "C" int repro_lbench(const void* a, void* out, long long n, int nflop,
                            float alpha, void* stream) {
  if (n == 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const long long work = n4 > n - 4 * n4 ? n4 : n - 4 * n4;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  lbench_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), n, n4,
      nflop / 2, (nflop % 2) == 1, alpha);
  return static_cast<int>(cudaGetLastError());
}
