// Paged chunked prefill: a page-aligned chunk of C prompt tokens attends
// causally to everything already cached for its sequence, through the
// sequence's block table into the physical KV page pool.
//
// Replaces: src/repro/kernels/flash_attention/paged_prefill.py
//   `paged_prefill_flash`            gather-only (the chunk is already in
//                                    the pool; sz none / per page / per
//                                    token)
//   `paged_prefill_insert_flash`     FUSED fp: writes the chunk's K/V into
//                                    the pool while attending
//   `paged_prefill_insert_flash_q8`  FUSED int8: writes the pre-quantized
//                                    payload and its per-page (scale,
//                                    zero) rows while attending
// One templated body, instantiated per (sz mode) x (fused or gather-only).
//
// Bound: bytes at the serving shapes. The chunk must read q, every cached
// page up to its causal frontier once (int8 payload plus (scale, zero)
// rows on the default pool), read its own K/V once, write it once, and
// write o; the arithmetic is 4 * D flops per unmasked (query head, key)
// pair, which at C = 128 and D = 64 is a few hundred MFLOP, below the byte
// time at the bf16 tensor-core rate. This first version runs its products
// on the FMA units in f32, so it is bound by FMA issue far above both.
//
// Design: one block per (tile of query positions, KV head, batch row)
// computes all rep = H / KV query heads of that KV head for its tile
// (rep * tile <= 16 rows, 4 rows per warp), so each staged K/V tile serves
// every query head of its group; the Pallas grid re-reads each page per
// query head. A loop over tiles of 32 consecutive key positions stands in
// for the TPU's sequential page axis and stops at the block's own causal
// frontier (c0 + last query of the tile), so pages above it are never
// read. For each key tile the first 32 threads resolve the key's source:
// in the fused kernels a key on one of the chunk's own pages
// (pi >= c0 / page) comes from the k_new / v_new operands (and, int8, the
// fresh (scale, zero) rows), any older key from the pool page bt[b, pi]
// (per-page or per-token (scale, zero) from the pool sz). The block then
// stages the tile's K and V rows in shared memory as f32 (16-byte vector
// loads where a row is a multiple of 16 bytes), dequantizing
// `q * scale + zero` right after the load. The online softmax (m, l, acc)
// of each row lives in registers across the key loop, as in
// flash_attention.cu and paged_decode.cu. `c0` is read on the device, so
// one build serves every chunk of every request.
//
// The fused write: only the chunk's pages are written, and no block reads
// them from the pool (they come from the operands), so there is no race
// between blocks in one launch. Exactly one block per (b, KV head), the
// one with query tile 0, copies that head's slice of each of the C / page
// chunk pages to pool[bt[b, c0/page + j], :, g, :] (and the (scale, zero)
// rows to sz[bt[...], g]). The chunk's table entries must be uniquely
// owned, the reference's contract; c0 and C must be page-aligned.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows a block
constexpr int kBK = 32;                       // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

enum SzMode : int { kSzNone = 0, kSzPage = 1, kSzToken = 2 };

// copy the chunk's pages of KV head g into the pool (and the int8 (scale,
// zero) rows into the pool sz): n_wp pages of `page` rows of D elements
template <typename TKV, int SZ>
__device__ void write_chunk(TKV* __restrict__ kp, TKV* __restrict__ vp,
                            float* __restrict__ ksz, float* __restrict__ vsz,
                            const TKV* __restrict__ kn,
                            const TKV* __restrict__ vn,
                            const float* __restrict__ kszn,
                            const float* __restrict__ vszn,
                            const int* __restrict__ bt_row, long long b,
                            int g, int p0, int n_wp, int C, int KV, int D,
                            int page) {
  const int tid = threadIdx.x;
  constexpr int kPerVec = 16 / sizeof(TKV);
  const int row_bytes = D * static_cast<int>(sizeof(TKV));
  const bool vec =
      row_bytes % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp) |
        reinterpret_cast<uintptr_t>(kn) | reinterpret_cast<uintptr_t>(vn)) &
       15) == 0;
  const int per_row = vec ? row_bytes / 16 : D;  // vectors or elements
  const int total = n_wp * page * per_row;
  for (int idx = tid; idx < total; idx += kThreads) {
    const int i = idx / per_row;   // chunk row, 0 .. C - 1
    const int e = idx - i * per_row;
    const int j = i / page;        // chunk page
    const long long phys = bt_row[p0 + j];
    const long long dst = ((phys * page + (i - j * page)) * KV + g) * D;
    const long long src = ((b * C + i) * KV + g) * D;
    if (vec) {
      const int d0 = e * kPerVec;
      *reinterpret_cast<uint4*>(kp + dst + d0) =
          *reinterpret_cast<const uint4*>(kn + src + d0);
      *reinterpret_cast<uint4*>(vp + dst + d0) =
          *reinterpret_cast<const uint4*>(vn + src + d0);
    } else {
      kp[dst + e] = kn[src + e];
      vp[dst + e] = vn[src + e];
    }
  }
  if (SZ == kSzPage) {
    for (int idx = tid; idx < n_wp * 2; idx += kThreads) {
      const int j = idx >> 1;
      const int c = idx & 1;
      const long long phys = bt_row[p0 + j];
      const long long o = ((b * n_wp + j) * KV + g) * 2 + c;
      ksz[(phys * KV + g) * 2 + c] = kszn[o];
      vsz[(phys * KV + g) * 2 + c] = vszn[o];
    }
  }
}

template <typename T, typename TKV, int SZ, bool FUSED, int DPL>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q, TKV* __restrict__ kp, TKV* __restrict__ vp,
    float* __restrict__ ksz, float* __restrict__ vsz,
    const TKV* __restrict__ kn, const TKV* __restrict__ vn,
    const float* __restrict__ kszn, const float* __restrict__ vszn,
    const int* __restrict__ bt, const int* __restrict__ c0s,
    T* __restrict__ out, int C, int H, int KV, int D, int page, int n_pages,
    int bq, float scale) {
  extern __shared__ float smem[];
  __shared__ long long s_off[kBK];  // element offset of each key's row
  __shared__ int s_new[kBK];        // 1: the row is in k_new / v_new
  __shared__ float s_ksc[kBK], s_kz[kBK], s_vsc[kBK], s_vz[kBK];
  const int rep = H / KV;
  const int rows = bq * rep;
  const int Dp = repro::odd_pitch(D);
  float* qs = smem;             // [kRows][D]
  float* ks = qs + kRows * D;   // [kBK][Dp]
  float* vs = ks + kBK * Dp;    // [kBK][Dp]

  const int q0 = blockIdx.x * bq;
  const int g = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = c0s[b];
  const int p0 = c0 / page;           // first page of the chunk
  const int n_wp = C / page;          // pages the chunk writes (fused)
  const int* bt_row = bt + b * n_pages;

  if (FUSED && blockIdx.x == 0)
    write_chunk<TKV, SZ>(kp, vp, ksz, vsz, kn, vn, kszn, vszn, bt_row, b, g,
                         p0, n_wp, C, KV, D, page);

  // row r of the block: query position q0 + r / rep, head g * rep + r % rep
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qi = q0 + r / rep;
    qs[idx] = (r < rows && qi < C)
                  ? repro::to_float(
                        q[((b * C + qi) * H + g * rep + r % rep) * D + d])
                  : 0.f;
  }
  // keys past the block's last query position are causally masked for
  // every row of the block: the loop stops there
  const int q_hi = min(q0 + bq, C);
  const int k_end = max(0, min(c0 + q_hi, n_pages * page));

  constexpr int kPerVec = 16 / sizeof(TKV);
  const int row_bytes = D * static_cast<int>(sizeof(TKV));
  uintptr_t align =
      reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp);
  if (FUSED)
    align |= reinterpret_cast<uintptr_t>(kn) | reinterpret_cast<uintptr_t>(vn);
  const bool vec_rows = row_bytes % 16 == 0 && (align & 15) == 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = repro::kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    if (tid < kBK) {
      const int t = k0 + tid;
      long long off = 0;
      int is_new = 0;
      float ksc = 1.f, kz = 0.f, vsc = 1.f, vz = 0.f;
      if (t < k_end) {
        const int pi = t / page;
        if (FUSED && pi >= p0) {
          is_new = 1;
          off = ((b * C + (t - c0)) * KV + g) * D;
          if (SZ == kSzPage) {
            const long long o = ((b * n_wp + (pi - p0)) * KV + g) * 2;
            ksc = kszn[o];
            kz = kszn[o + 1];
            vsc = vszn[o];
            vz = vszn[o + 1];
          }
        } else {
          const long long phys = bt_row[pi];
          const long long row = phys * page + (t - pi * page);
          off = (row * KV + g) * D;
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
      }
      s_off[tid] = off;
      s_new[tid] = is_new;
      s_ksc[tid] = ksc;
      s_kz[tid] = kz;
      s_vsc[tid] = vsc;
      s_vz[tid] = vz;
    }
    __syncthreads();
    if (vec_rows) {
      const int vpr = row_bytes / 16;  // vectors per row
      for (int idx = tid; idx < kBK * vpr; idx += kThreads) {
        const int j = idx / vpr;
        const int d0 = (idx - j * vpr) * kPerVec;
        float kk[kPerVec], vv[kPerVec];
        if (k0 + j < k_end) {
          const TKV* ksrc = (FUSED && s_new[j]) ? kn : kp;
          const TKV* vsrc = (FUSED && s_new[j]) ? vn : vp;
          const long long o = s_off[j] + d0;
          const uint4 kraw = *reinterpret_cast<const uint4*>(ksrc + o);
          const uint4 vraw = *reinterpret_cast<const uint4*>(vsrc + o);
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
        if (k0 + j < k_end) {
          const TKV* ksrc = (FUSED && s_new[j]) ? kn : kp;
          const TKV* vsrc = (FUSED && s_new[j]) ? vn : vp;
          kk = repro::to_float(ksrc[s_off[j] + d]);
          vv = repro::to_float(vsrc[s_off[j] + d]);
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

    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r / rep;
      if (r >= rows || qi >= C) break;  // warp-uniform
      const bool live = kpos < k_end && kpos <= c0 + qi;
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
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int qi = q0 + r / rep;
    if (r >= rows || qi >= C) break;
    const float l_safe = fmaxf(l[rr], repro::kMinDenom);
    const long long o = ((b * C + qi) * H + g * rep + r % rep) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[o + d] = repro::from_float<T>(acc[rr][i] / l_safe);
    }
  }
}

struct Args {
  const void* q;
  void *kp, *vp, *ksz, *vsz;
  const void *kn, *vn, *kszn, *vszn, *bt, *c0;
  void* out;
  int B, C, H, KV, D, page, n_pages;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename TKV, int SZ, bool FUSED, int DPL>
int launch(const Args& a) {
  const int rep = a.H / a.KV;
  const int bq = rep >= kRows ? 1 : kRows / rep;  // query positions/block
  const size_t smem =
      sizeof(float) * (kRows * a.D + 2 * kBK * repro::odd_pitch(a.D));
  auto kernel = paged_prefill_kernel<T, TKV, SZ, FUSED, DPL>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.C + bq - 1) / bq, a.KV, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<TKV*>(a.kp),
      static_cast<TKV*>(a.vp), static_cast<float*>(a.ksz),
      static_cast<float*>(a.vsz), static_cast<const TKV*>(a.kn),
      static_cast<const TKV*>(a.vn), static_cast<const float*>(a.kszn),
      static_cast<const float*>(a.vszn), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.c0), static_cast<T*>(a.out), a.C, a.H, a.KV,
      a.D, a.page, a.n_pages, bq, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TKV, int SZ, bool FUSED>
int launch_d(const Args& a) {
  switch (repro::lane_width(a.D)) {
    case 1: return launch<T, TKV, SZ, FUSED, 1>(a);
    case 2: return launch<T, TKV, SZ, FUSED, 2>(a);
    case 4: return launch<T, TKV, SZ, FUSED, 4>(a);
    case 8: return launch<T, TKV, SZ, FUSED, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// fp pools are instantiated in q's own dtype only (the engine's pools:
// "fp" stores cfg.dtype, the dtype of q), which keeps the build short
template <typename T>
int launch_kv(const Args& a, int kv_dtype, int sz_mode, int fused) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == repro::kI8) {
    if (sz_mode == kSzPage)
      return fused ? launch_d<T, int8_t, kSzPage, true>(a)
                   : launch_d<T, int8_t, kSzPage, false>(a);
    if (sz_mode == kSzToken && !fused)
      return launch_d<T, int8_t, kSzToken, false>(a);
    return bad;
  }
  if (sz_mode != kSzNone) return bad;
  return fused ? launch_d<T, T, kSzNone, true>(a)
               : launch_d<T, T, kSzNone, false>(a);
}

}  // namespace

// q (B,C,H,D) in `q_dtype` (kF32 | kBF16); pools k/v (P,page,KV,D) in
// `kv_dtype` (q_dtype itself, or kI8) with f32 ksz/vsz (P,KV,2) (sz_mode 1) or
// (P,page,KV,2) (sz_mode 2), null for sz_mode 0; bt (B,n_pages) int32
// whose every entry below the frontier c0 + C names a real page; c0 (B,)
// int32 chunk starts on the device; out (B,C,H,D) in `q_dtype`. With
// `fused`, kn/vn (B,C,KV,D) in the pool dtype are written into the pool
// at the chunk's pages (and, sz_mode 1, kszn/vszn (B,C/page,KV,2) f32 into
// ksz/vsz); c0 and C must be page-aligned. All contiguous, on the device.
// Returns cudaGetLastError() of the launch.
extern "C" int repro_paged_prefill(const void* q, void* kp, void* vp,
                                   void* ksz, void* vsz, const void* kn,
                                   const void* vn, const void* kszn,
                                   const void* vszn, const void* bt,
                                   const void* c0, void* out, int B, int C,
                                   int H, int KV, int D, int page,
                                   int n_pages, int q_dtype, int kv_dtype,
                                   int sz_mode, int fused, float scale,
                                   void* stream) {
  if (B == 0 || C == 0) return 0;
  Args a{q,   kp,  vp,    ksz,   vsz, kn,   vn,      kszn,
         vszn, bt, c0,    out,   B,   C,    H,       KV,
         D,    page, n_pages, scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == repro::kF32)
    return launch_kv<float>(a, kv_dtype, sz_mode, fused);
  if (q_dtype == repro::kBF16)
    return launch_kv<__nv_bfloat16>(a, kv_dtype, sz_mode, fused);
  return static_cast<int>(cudaErrorInvalidValue);
}
