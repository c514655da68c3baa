// Paged flash decode: one query token per slot and head against the
// physical KV page pool, through the slot's block table.
//
// Replaces: src/repro/kernels/decode_attention/paged.py
// `paged_flash_decode` (every decode step, once per layer).
//
// Bound: bytes. Per slot the step must read its live pages of K and V once
// (int8 payload plus its (scale, zero) rows on the serving pool); the
// arithmetic is 4 * D flops per (query head, key), far below the byte time.
//
// Design: one block per (KV head, slot) computes all rep = H / KV query
// heads of that group, so each page's K and V leave device memory once per
// step; the Pallas grid (B, H, n_pages) re-reads them per query head. A
// loop over the slot's live keys stands in for the page grid axis: it is
// bounded by min(length, n_pages * page) — a parked slot (length past the
// table) reads every table entry and produces garbage the engine masks, it
// never reads past the table. The block loads its own block-table entries:
// for each tile of 32 consecutive logical positions the first 32 threads
// resolve (physical page, in-page offset) and the page's or token's
// (scale, zero) into shared memory, then the block stages the tile's K/V
// rows in f32, dequantized `q * scale + zero` right after the load, so fp
// values exist only in shared memory. Rows whose size is a multiple of 16
// bytes (int8 D = 64: four vectors a row) load as 16-byte vectors, so a
// tile's loads are all in flight together; other head dims load element
// by element. Per query head a warp runs the same
// online softmax as the flash kernel (lane j scores key j; each lane owns
// ceil(D/32) head-dim values of the accumulator). Three sub-scale modes,
// chosen by the sz rank as in the reference: none (fp pool), per page
// (P, KV, 2), per token (P, page, KV, 2).

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxRowsPerWarp = 4;  // rep = H / KV <= 16
constexpr int kBK = 32;             // keys per tile: one per lane

enum SzMode : int { kSzNone = 0, kSzPage = 1, kSzToken = 2 };

template <typename T, typename TKV, int SZ, int DPL>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(
    const T* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ksz,
    const float* __restrict__ vsz, const int* __restrict__ bt,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int KV, int D,
    int page, int n_pages, float scale) {
  extern __shared__ float smem[];
  __shared__ long long s_row[kBK];  // (phys * page + off) of each key
  __shared__ float s_ksc[kBK], s_kz[kBK], s_vsc[kBK], s_vz[kBK];
  const int rep = H / KV;
  const int Dp = repro::odd_pitch(D);
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
    qs[idx] = repro::to_float(q[(b * H + g * rep + r) * D + d]);
  }
  const int n_keys = max(0, min(lengths[b], n_pages * page));
  constexpr int kPerVec = 16 / sizeof(TKV);  // elements per 16-byte load
  const int row_bytes = D * static_cast<int>(sizeof(TKV));
  const bool vec_rows =
      row_bytes % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) &
       15) == 0;

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp], acc[kMaxRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    m[rr] = repro::kNegInf;
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
        const long long phys = bt[b * n_pages + t / page];
        row = phys * page + t % page;
        if (SZ == kSzPage) {
          const long long o = (phys * KV + g) * 2;
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
            kk[e] = repro::to_float(ke[e]);
            vv[e] = repro::to_float(ve[e]);
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
          kk = repro::to_float(kp[o]);
          vv = repro::to_float(vp[o]);
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
      s = live ? s * scale : repro::kNegInf;
      const float m_new = fmaxf(m[rr], repro::warp_max(s));
      const float p = live ? expf(s - m_new) : 0.f;
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
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int r = rr * kWarps + warp;
    if (r >= rep) break;
    const float l_safe = fmaxf(l[rr], repro::kMinDenom);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D)
        out[(b * H + g * rep + r) * D + d] =
            repro::from_float<T>(acc[rr][i] / l_safe);
    }
  }
}

struct Args {
  const void *q, *kp, *vp, *ksz, *vsz, *bt, *lengths;
  void* out;
  int B, H, KV, D, page, n_pages;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename TKV, int SZ, int DPL>
int launch(const Args& a) {
  const int Dp = repro::odd_pitch(a.D);
  const size_t smem = sizeof(float) * ((a.H / a.KV) * a.D + 2 * kBK * Dp);
  auto kernel = paged_decode_kernel<T, TKV, SZ, DPL>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.KV, a.B);
  kernel<<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const float*>(a.ksz),
      static_cast<const float*>(a.vsz), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out), a.H, a.KV,
      a.D, a.page, a.n_pages, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TKV, int SZ>
int launch_d(const Args& a) {
  switch (repro::lane_width(a.D)) {
    case 1: return launch<T, TKV, SZ, 1>(a);
    case 2: return launch<T, TKV, SZ, 2>(a);
    case 4: return launch<T, TKV, SZ, 4>(a);
    case 8: return launch<T, TKV, SZ, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_kv(const Args& a, int kv_dtype, int sz_mode) {
  if (kv_dtype == repro::kI8) {
    if (sz_mode == kSzPage) return launch_d<T, int8_t, kSzPage>(a);
    if (sz_mode == kSzToken) return launch_d<T, int8_t, kSzToken>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sz_mode != kSzNone) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == repro::kF32) return launch_d<T, float, kSzNone>(a);
  if (kv_dtype == repro::kBF16) return launch_d<T, __nv_bfloat16, kSzNone>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,H,D) in `q_dtype` (kF32 | kBF16); k/v pages (P,page,KV,D) in
// `kv_dtype` (kF32 | kBF16 | kI8); ksz/vsz f32 (P,KV,2) (sz_mode 1) or
// (P,page,KV,2) (sz_mode 2), unused for sz_mode 0; bt (B,n_pages) and
// lengths (B,) int32; out (B,H,D) in `q_dtype`. All contiguous, on the
// device. Returns cudaGetLastError() of the launch.
extern "C" int repro_paged_decode(const void* q, const void* kp,
                                  const void* vp, const void* ksz,
                                  const void* vsz, const void* bt,
                                  const void* lengths, void* out, int B, int H,
                                  int KV, int D, int page, int n_pages,
                                  int q_dtype, int kv_dtype, int sz_mode,
                                  float scale, void* stream) {
  if (B == 0) return 0;
  Args a{q,  kp, vp, ksz,  vsz,     bt,    lengths,
         out, B,  H,  KV,  D,       page,  n_pages,
         scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == repro::kF32) return launch_kv<float>(a, kv_dtype, sz_mode);
  if (q_dtype == repro::kBF16)
    return launch_kv<__nv_bfloat16>(a, kv_dtype, sz_mode);
  return static_cast<int>(cudaErrorInvalidValue);
}
