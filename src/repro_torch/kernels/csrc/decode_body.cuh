// One query token per (batch row, query head) against a KV cache whose
// rows an addressing policy locates: the body shared by the paged decode
// (`paged_decode.cu`, rows through a block table) and the contiguous
// decode (`decode_attention.cu`, rows at b * S + t).
//
// Bound: bytes. Per row the step must read its live K and V once (plus the
// int8 pool's (scale, zero) rows); the arithmetic is 4 * D flops per
// (query head, key), far below the byte time.
//
// Design: one block per (KV head, batch row) computes all rep = H / KV
// query heads of that group, so each K/V row leaves device memory once per
// step; the Pallas grids (B, H, keys) re-read it per query head. A loop
// over the row's live keys stands in for the sequential key grid axis: it
// is bounded by min(length, capacity) — a parked row (length past the
// cache) reads the whole cache and produces garbage the engine masks, it
// never reads past it. For each tile of 32 consecutive positions the
// first 32 threads resolve each key's row (and, int8, the page's or
// token's (scale, zero)) into shared memory; then the block stages the
// tile's K/V rows in f32, dequantized `q * scale + zero` right after the
// load, so fp values exist only in shared memory. Rows whose size is a
// multiple of 16 bytes load as 16-byte vectors, so a tile's loads are all
// in flight together; other head dims load element by element. The ragged
// last tile is zero-filled and masked. Per query head a warp runs the
// online softmax (lane j scores key j; each lane owns ceil(D/32) head-dim
// values of the accumulator), with the reference's -1e30 mask and the
// denominator clamped at 1e-30.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int kWarps = 4;
constexpr int kMaxRowsPerWarp = 4;  // rep = H / KV <= 16
constexpr int kBK = 32;             // keys per tile: one per lane

enum SzMode : int { kSzNone = 0, kSzPage = 1, kSzToken = 2 };

// rows of a physical page pool (P, page, KV, D) through a (B, n_pages)
// block table
struct PagedRows {
  const int* bt;
  int page, n_pages;
  __device__ __forceinline__ int capacity() const { return n_pages * page; }
  // (page id for per-page sz, row index into the (rows, KV, D) view)
  __device__ __forceinline__ void locate(long long b, int t, long long& pid,
                                         long long& row) const {
    pid = bt[b * n_pages + t / page];
    row = pid * page + t % page;
  }
};

// rows of a contiguous cache (B, S, KV, D)
struct DenseRows {
  int S;
  __device__ __forceinline__ int capacity() const { return S; }
  __device__ __forceinline__ void locate(long long b, int t, long long& pid,
                                         long long& row) const {
    pid = b;
    row = b * S + t;
  }
};

template <typename T, typename TKV, int SZ, int DPL, typename Rows>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(
    const T* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ksz,
    const float* __restrict__ vsz, const Rows rows,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV, int D,
    float scale) {
  extern __shared__ float smem[];
  __shared__ long long s_row[kBK];  // cache row of each key
  __shared__ float s_ksc[kBK], s_kz[kBK], s_vsc[kBK], s_vz[kBK];
  const int rep = H / KV;
  const int Dp = odd_pitch(D);
  float* qs = smem;           // [rep][D]
  float* ks = qs + rep * D;   // [kBK][Dp]
  float* vs = ks + kBK * Dp;  // [kBK][Dp]

  const int g = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kThreads = kWarps * 32;

  for (int idx = tid; idx < rep * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    qs[idx] = to_float(q[(b * H + g * rep + r) * D + d]);
  }
  const int n_keys = max(0, min(lengths[b], rows.capacity()));
  constexpr int kPerVec = 16 / sizeof(TKV);  // elements per 16-byte load
  const int row_bytes = D * static_cast<int>(sizeof(TKV));
  const bool vec_rows =
      row_bytes % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) &
       15) == 0;

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp], acc[kMaxRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    if (tid < kBK) {
      const int t = k0 + tid;
      long long row = 0;
      float ksc = 1.f, kz = 0.f, vsc = 1.f, vz = 0.f;
      if (t < n_keys) {
        long long pid;
        rows.locate(b, t, pid, row);
        if (SZ == kSzPage) {
          const long long o = (pid * KV + g) * 2;
          ksc = ksz[o];
          kz = ksz[o + 1];
          vsc = vsz[o];
          vz = vsz[o + 1];
        } else if (SZ == kSzToken) {
          const long long o = (row * KV + g) * 2;
          ksc = ksz[o];
          kz = ksz[o + 1];
          vsc = vsz[o];
          vz = vsz[o + 1];
        }
      }
      s_row[tid] = row;
      s_ksc[tid] = ksc;
      s_kz[tid] = kz;
      s_vsc[tid] = vsc;
      s_vz[tid] = vz;
    }
    __syncthreads();
    if (vec_rows) {
      // 16-byte loads: each thread moves whole vectors of K and V rows, so
      // a tile's loads are few and all in flight at once
      const int vpr = row_bytes / 16;  // vectors per row
      for (int idx = tid; idx < kBK * vpr; idx += kThreads) {
        const int j = idx / vpr;
        const int d0 = (idx - j * vpr) * kPerVec;
        float kk[kPerVec], vv[kPerVec];
        if (k0 + j < n_keys) {
          const long long o = (s_row[j] * KV + g) * D + d0;
          const uint4 kraw = *reinterpret_cast<const uint4*>(kp + o);
          const uint4 vraw = *reinterpret_cast<const uint4*>(vp + o);
          const TKV* ke = reinterpret_cast<const TKV*>(&kraw);
          const TKV* ve = reinterpret_cast<const TKV*>(&vraw);
#pragma unroll
          for (int e = 0; e < kPerVec; ++e) {
            kk[e] = to_float(ke[e]);
            vv[e] = to_float(ve[e]);
            if (SZ != kSzNone) {
              kk[e] = kk[e] * s_ksc[j] + s_kz[j];
              vv[e] = vv[e] * s_vsc[j] + s_vz[j];
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < kPerVec; ++e) kk[e] = vv[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < kPerVec; ++e) {
          ks[j * Dp + d0 + e] = kk[e];
          vs[j * Dp + d0 + e] = vv[e];
        }
      }
    } else {
      for (int idx = tid; idx < kBK * D; idx += kThreads) {
        const int j = idx / D;
        const int d = idx - j * D;
        float kk = 0.f, vv = 0.f;
        if (k0 + j < n_keys) {
          const long long o = (s_row[j] * KV + g) * D + d;
          kk = to_float(kp[o]);
          vv = to_float(vp[o]);
          if (SZ != kSzNone) {
            kk = kk * s_ksc[j] + s_kz[j];
            vv = vv * s_vsc[j] + s_vz[j];
          }
        }
        ks[j * Dp + d] = kk;
        vs[j * Dp + d] = vv;
      }
    }
    __syncthreads();

    const bool live = k0 + lane < n_keys;
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;
      if (r >= rep) break;  // warp-uniform
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qs[r * D + d] * ks[lane * Dp + d];
      s = live ? s * scale : kNegInf;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = live ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
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
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int r = rr * kWarps + warp;
    if (r >= rep) break;
    const float l_safe = fmaxf(l[rr], kMinDenom);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D)
        out[(b * H + g * rep + r) * D + d] =
            from_float<T>(acc[rr][i] / l_safe);
    }
  }
}

template <typename Rows>
struct Args {
  const void *q, *kp, *vp, *ksz, *vsz, *lengths;
  void* out;
  int B, H, KV, D;
  float scale;
  Rows rows;
  cudaStream_t stream;
};

template <typename T, typename TKV, int SZ, int DPL, typename Rows>
int launch(const Args<Rows>& a) {
  const int Dp = odd_pitch(a.D);
  const size_t smem = sizeof(float) * ((a.H / a.KV) * a.D + 2 * kBK * Dp);
  auto kernel = decode_kernel<T, TKV, SZ, DPL, Rows>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.KV, a.B);
  kernel<<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const float*>(a.ksz),
      static_cast<const float*>(a.vsz), a.rows,
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out), a.H, a.KV,
      a.D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// instantiate over the accumulator width each lane owns (ceil(D/32))
template <typename T, typename TKV, int SZ, typename Rows>
int launch_d(const Args<Rows>& a) {
  switch (lane_width(a.D)) {
    case 1: return launch<T, TKV, SZ, 1>(a);
    case 2: return launch<T, TKV, SZ, 2>(a);
    case 4: return launch<T, TKV, SZ, 4>(a);
    case 8: return launch<T, TKV, SZ, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace decode
}  // namespace repro
