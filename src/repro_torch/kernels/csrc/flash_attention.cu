// Dense GQA flash-attention forward (bucket prefill).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
// `_fwd_pallas` / `flash_mha` (forward only; the backward pass ports with
// the training slice and will read the lse written here).
//
// Bound: at the serving shapes (one prompt of 64..512 tokens, D = 64) the
// operation count 4 * D * (unmasked query-key pairs) over the card's bf16
// peak is a few microseconds and so are the bytes; this first version runs
// its products on the FMA units in f32, not on the tensor cores, so it is
// bound by FMA issue, far above either bound. `mma.sync`/`wgmma` tiles are
// later work.
//
// Design: one block per (tile of 16 query rows, query head, batch row), 4
// warps of 4 rows each. K/V tiles of 32 keys are staged in shared memory in
// f32 by a loop that stands in for the TPU's sequential kv grid axis; the
// block's query rows are staged once. Per row, lane j scores key j of the
// tile (QK^T from shared memory, odd row pitch so the 32 lanes hit 32
// banks), the warp reduces the tile max and sum, and each lane accumulates
// ceil(D/32) head-dim values of P.V, so the online softmax state (m, l, acc)
// lives in registers for the whole key loop. Causal tiles past the block's
// last query position (with kv_offset) are never loaded, as the Pallas
// kernel skips them. D up to 256 and any Sq/Skv: the ragged query tile and
// key tile are masked (keys past Skv contribute nothing; causally masked
// keys take the reference's -1e30 logit). Output in q's dtype, lse in f32.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane

template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                     int D, float scale, int causal, int kv_offset) {
  extern __shared__ float smem[];
  const int Dp = repro::odd_pitch(D);
  float* qs = smem;           // [kBQ][D]
  float* ks = qs + kBQ * D;   // [kBK][Dp]
  float* vs = ks + kBK * Dp;  // [kBK][Dp]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int g = h / (H / KV);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kThreads = kWarps * 32;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qi = q0 + r;
    qs[idx] = qi < Sq ? repro::to_float(q[((b * Sq + qi) * H + h) * D + d])
                      : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = repro::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Skv, kv_offset + q_last + 1) : Skv;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kj = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (kj < Skv) {
        const long long o = ((b * Skv + kj) * KV + g) * D + d;
        kk = repro::to_float(k[o]);
        vv = repro::to_float(v[o]);
      }
      ks[j * Dp + d] = kk;
      vs[j * Dp + d] = vv;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool in_kv = kj < Skv;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      if (qi >= Sq) break;  // warp-uniform
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qs[r * D + d] * ks[lane * Dp + d];
      s *= scale;
      if (causal && kj > kv_offset + qi) s = repro::kNegInf;
      if (!in_kv) s = repro::kNegInf;
      const float m_new = fmaxf(m[rr], repro::warp_max(s));
      const float p = in_kv ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + repro::warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
      for (int jj = 0; jj < kBK; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] += pj * vs[jj * Dp + d];
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= Sq) break;
    const float l_safe = fmaxf(l[rr], repro::kMinDenom);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D)
        out[((b * Sq + qi) * H + h) * D + d] =
            repro::from_float<T>(acc[rr][i] / l_safe);
    }
    if (lane == 0) lse[(b * H + h) * Sq + qi] = m[rr] + logf(l_safe);
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Skv, int H, int KV, int D, float scale,
           int causal, int kv_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * D + 2 * kBK * repro::odd_pitch(D));
  auto kernel = flash_fwd_kernel<T, DPL>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, H, KV, D, scale, causal, kv_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int Sq, int Skv, int H, int KV, int D,
             float scale, int causal, int kv_offset, cudaStream_t stream) {
  switch (repro::lane_width(D)) {
    case 1:
      return launch<T, 1>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, scale,
                          causal, kv_offset, stream);
    case 2:
      return launch<T, 2>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, scale,
                          causal, kv_offset, stream);
    case 4:
      return launch<T, 4>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, scale,
                          causal, kv_offset, stream);
    case 8:
      return launch<T, 8>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, scale,
                          causal, kv_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Skv,KV,D) contiguous in `dtype` (kF32 | kBF16);
// out (B,Sq,H,D) in `dtype`, lse (B,H,Sq) f32. Returns cudaGetLastError().
extern "C" int repro_flash_mha(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int Sq, int Skv,
                               int H, int KV, int D, int dtype, float scale,
                               int causal, int kv_offset, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch_d<float>(q, k, v, out, lse, B, Sq, Skv, H, KV, D, scale,
                           causal, kv_offset, s);
  if (dtype == repro::kBF16)
    return launch_d<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Skv, H, KV, D,
                                   scale, causal, kv_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
