// Paged chunked prefill: a chunk of C prompt tokens attends causally to
// everything already cached for its sequence, through the sequence's
// block table into the physical KV page pool.
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
// Each computes the reference's `_tile_update` (q, k, v in float32,
// online softmax, masked logits -1e30, denominator clamped at 1e-30).
//
// Bound: bytes at the serving shapes. At SmolLM-360M's chunk (C = 128,
// c0 = 384, 15/5 heads, D = 64, page 16, int8 pool) the chunk reads q,
// every cached page up to its causal frontier once, its own K/V once,
// writes it once and writes o: about 1.3 MB, 0.4 us at 3.35 TB/s; the
// 220 MFLOP of QK^T and PV take 0.22 us at the bf16 tensor-core rate.
//
// What the first design (one body for every dtype) lost: five query
// positions per block at rep 3, so 130 blocks of 4 warps, one warp per
// scheduler and nothing to hide latency; every product a float32 FMA
// chain out of shared memory (QK^T a 64-long dependent chain per lane, PV
// 32 shuffles per row, two warp reductions per 32-key tile), no tensor
// core; each key tile three barriers and two dependent global round trips
// (32 threads resolve block-table entries and (scale, zero) rows, then
// all threads load K/V), with no copy in flight during the arithmetic;
// K/V staged as float32. It ran at 560x its bound and 12x SDPA.
//
// bf16 q (every engine path): `paged_prefill_mma_kernel`.
// - Rows of a block are (query position, head of the KV group), so one
//   staged K/V tile serves all rep = H / KV query heads; each warp owns 16
//   rows (padded and masked), a block 32 or 64 (the launch plan,
//   `kernels/flash_attention/paged_prefill.py` `launch_plan`). Key tiles
//   are 64 keys (four pages of 16, or one of 64).
// - QK^T and PV run on the tensor cores: mma.sync m16n8k16 bf16 -> f32,
//   fed by ldmatrix (K plain, V transposed) from shared memory; D is
//   padded to a multiple of 16 with zeros, so any D <= 256 works. P goes
//   from the QK^T accumulators straight into PV's A fragments. The online
//   softmax (m, l, acc) lives in registers in the accumulator layout; l
//   and the int8 zero term are summed per lane and reduced across the
//   quad once, at the end.
// - Copies: the block reads its slice of the block table once into
//   shared memory, then K/V tiles go through cp.async (16 bytes where rows
//   allow, else 4, else synchronous bytes) into a two-stage ring in the
//   pool's own type; the next tile's copies are issued before the current
//   tile's arithmetic, so one tile is always in flight. Keys past the
//   block's frontier are zero-filled by the copy. The per-key (scale,
//   zero) rows ride in the same copy group (8-byte cp.async per key, per
//   page or per token), which keeps per-page and per-token pools on one
//   path and puts no dependent global read between tiles. cp.async and
//   not TMA: a tile is four pages at table-chosen addresses, one small
//   copy each, and the 16-byte copies are already issued by the warps
//   that wait for them; wgmma would need 64-row warpgroups, which at
//   rep 3 leaves 30 blocks for 132 SMs.
// - int8 pools without a dequantize pass: a payload value is exact in
//   bf16, so the ring is converted to bf16 unscaled (one shared-memory
//   pass per tile) and the per-key (scale, zero) is applied in float32
//   around the products: s_ij = sc_j (q_i . k8_j) + z_j sum_d q_id, and
//   o_i = sum_j (p_ij vsc_j) v8_j + sum_j p_ij vz_j. The products are
//   exact as in float32 arithmetic; P (or P * vsc), the second
//   product's A operand, goes in as a bf16 hi + lo pair (two products),
//   about 16 bits. With P in one bf16 (8 bits) every kernel case stayed
//   within tolerance, but about a quarter of the outputs moved one bf16
//   ulp off the float32 path, and the random-weight 32-layer SmolLM
//   flipped one request's first token on the chunked int8 trace.
// - Filling the card: the block's key range is split across blocks
//   (grid z = B * n_split); each split writes its unnormalized (acc, m, l)
//   to a float32 scratch and `paged_prefill_combine_kernel` merges them
//   (flash-decoding). At the main shape 64-row blocks make 35 blocks of
//   up to 8 tiles; 32-row blocks (65 blocks) were slower, since a warp's
//   chain of tiles stays as long, while the split shortens it: 8 splits
//   (280 blocks of one tile, about two per SM, the plan's default) ran
//   3x faster than none, the combine kernel a fifth of the time
//   (PERF.md, `scripts/paged_prefill_plans.py`).
// - A warp whose rows all lie below a tile's first key skips the tile's
//   arithmetic (the causal upper triangle).
//
// float32 q: `paged_prefill_kernel`, the first design's FMA body, kept
// because the float32 sweep holds it to 1e-5, which TF32 or bf16 products
// cannot meet; the engine never launches it.
//
// `c0` is read on the device, so one build serves every chunk of every
// request. The fused write: only the chunk's pages are written, and no
// block reads them from the pool (they come from the operands), so there
// is no race between blocks in one launch. Exactly one block per (b, KV
// head), query tile 0 of split 0, copies that head's slice of each of the
// C / page chunk pages to pool[bt[b, c0/page + j], :, g, :] (and the
// (scale, zero) rows to sz[bt[...], g]). The chunk's table entries must be
// uniquely owned, the reference's contract; c0 and C must be page-aligned.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

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
  const int nthr = blockDim.x;
  constexpr int kPerVec = 16 / sizeof(TKV);
  const int row_bytes = D * static_cast<int>(sizeof(TKV));
  const bool vec =
      row_bytes % 16 == 0 &&
      ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp) |
        reinterpret_cast<uintptr_t>(kn) | reinterpret_cast<uintptr_t>(vn)) &
       15) == 0;
  const int per_row = vec ? row_bytes / 16 : D;  // vectors or elements
  const int total = n_wp * page * per_row;
  for (int idx = tid; idx < total; idx += nthr) {
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
    for (int idx = tid; idx < n_wp * 2; idx += nthr) {
      const int j = idx >> 1;
      const int c = idx & 1;
      const long long phys = bt_row[p0 + j];
      const long long o = ((b * n_wp + j) * KV + g) * 2 + c;
      ksz[(phys * KV + g) * 2 + c] = kszn[o];
      vsz[(phys * KV + g) * 2 + c] = vszn[o];
    }
  }
}

// ------------------------------------------------ float32 q: FMA body
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // (query, head) rows a block
constexpr int kBK = 32;                       // keys per tile: one per lane
constexpr int kThreads = kWarps * 32;

// One block per (tile of query positions, KV head, batch row), all rep
// heads of the KV head (rep * tile <= 16 rows, 4 per warp); 32-key tiles
// staged in shared memory as f32, dequantized right after the load.
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

// ------------------------------------------- bf16 q: tensor-core body
constexpr int kBN = 64;         // keys per tile
constexpr int kMaxThreads = 128;

// Shared-memory layout of the tensor-core body, in bytes; every region
// starts 16-byte aligned. The launch plan in Python mirrors it.
struct MmaSmem {
  int q, ring, conv, sz, table, total;
  __host__ __device__ MmaSmem(int rows_blk, int D, bool i8, bool has_sz,
                              int n_tab) {
    const int dp = (D + 15) & ~15;
    const int qp = 2 * (dp + 8);         // bf16 row pitch, bytes
    q = rows_blk * qp;                   // [rows_blk][dp + 8] bf16
    ring = 2 * 2 * kBN * (i8 ? dp : qp);  // [stage][k, v][kBN] rows
    conv = i8 ? 2 * kBN * qp : 0;        // [k, v][kBN] bf16 rows
    sz = has_sz ? 2 * 2 * kBN * 8 : 0;   // [stage][k, v][kBN] float2
    table = ((n_tab * 4) + 15) & ~15;    // block-table slice, int32
    total = q + ring + conv + sz + table;
  }
};

struct MmaShape {
  int C, H, KV, D, page, n_pages, bq, n_split, n_tab, vb, vbq;
  long long R;  // output rows B * C * H
  float scale;
};

template <typename TKV, int SZ, bool FUSED, int DMAX>
__global__ void __launch_bounds__(kMaxThreads) paged_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, TKV* __restrict__ kp,
    TKV* __restrict__ vp, float* __restrict__ ksz, float* __restrict__ vsz,
    const TKV* __restrict__ kn, const TKV* __restrict__ vn,
    const float* __restrict__ kszn, const float* __restrict__ vszn,
    const int* __restrict__ bt, const int* __restrict__ c0s,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
    float* __restrict__ part_ml, MmaShape s) {
  constexpr bool kI8 = std::is_same<TKV, int8_t>::value;
  constexpr int kNT = DMAX / 8;          // 8-wide d tiles of the output
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows_blk = blockDim.x / 2;   // 16 rows per warp
  const int rep = s.H / s.KV;
  const int rows = s.bq * rep;
  const int dp = (s.D + 15) & ~15;
  const int kd = dp / 16;                // 16-deep k steps of QK^T
  const int qp = dp + 8;                 // bf16 row pitch (elements)
  const MmaSmem lay(rows_blk, s.D, kI8, SZ != kSzNone, s.n_tab);
  const int rp = kI8 ? dp : 2 * qp;      // ring row pitch, bytes
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  unsigned char* ring = smem_mma + lay.q;
  __nv_bfloat16* ck = reinterpret_cast<__nv_bfloat16*>(ring + lay.ring);
  __nv_bfloat16* cv = ck + kBN * qp;
  float2* ssz = reinterpret_cast<float2*>(ring + lay.ring + lay.conv);
  int* s_bt = reinterpret_cast<int*>(ring + lay.ring + lay.conv + lay.sz);

  const int q0 = blockIdx.x * s.bq;
  const int g = blockIdx.y;
  const long long b = blockIdx.z / s.n_split;
  const int split = blockIdx.z - static_cast<int>(b) * s.n_split;
  const int c0 = c0s[b];
  const int p0 = c0 / s.page;
  const int n_wp = s.C / s.page;
  const int* bt_row = bt + b * s.n_pages;
  const int q_hi = min(q0 + s.bq, s.C);
  const int k_end = max(0, min(c0 + q_hi, s.n_pages * s.page));
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const int t_lo = split * n_tiles / s.n_split;
  const int t_hi = (split + 1) * n_tiles / s.n_split;
  const int pg_lo = t_lo * kBN / s.page;
  if (t_hi > t_lo) {
    const int pg_hi = (min(t_hi * kBN, k_end) - 1) / s.page;
    for (int i = tid; i <= pg_hi - pg_lo; i += blockDim.x)
      s_bt[i] = bt_row[pg_lo + i];
  }
  __syncthreads();

  const char* any = reinterpret_cast<const char*>(kp);  // for empty copies
  const int row_bytes = s.D * static_cast<int>(sizeof(TKV));
  const int fill = kI8 ? dp : 2 * dp;    // staged bytes per row
  // K/V rows of tile t (and their (scale, zero)) into ring stage st
  auto issue = [&](int t, int st) {
    const int k0 = t * kBN;
    unsigned char* kr = ring + (st * 2) * kBN * rp;
    unsigned char* vr = kr + kBN * rp;
    const int per = fill / s.vb;
    for (int idx = tid; idx < kBN * per; idx += blockDim.x) {
      const int j = idx / per;
      const int off = (idx - j * per) * s.vb;
      const int key = k0 + j;
      const char* ksrc = any;
      const char* vsrc = any;
      int n = 0;
      if (key < k_end) {
        const int pi = key / s.page;
        long long o;
        const TKV* kbase = kp;
        const TKV* vbase = vp;
        if (FUSED && pi >= p0) {
          o = ((b * s.C + (key - c0)) * s.KV + g) * s.D;
          kbase = kn;
          vbase = vn;
        } else {
          const long long phys = s_bt[pi - pg_lo];
          o = ((phys * s.page + (key - pi * s.page)) * s.KV + g) * s.D;
        }
        n = max(0, min(s.vb, row_bytes - off));
        if (n) {
          ksrc = reinterpret_cast<const char*>(kbase + o) + off;
          vsrc = reinterpret_cast<const char*>(vbase + o) + off;
        }
      }
      repro::cp_chunk(kr + j * rp + off, ksrc, n, s.vb);
      repro::cp_chunk(vr + j * rp + off, vsrc, n, s.vb);
    }
    if (SZ != kSzNone) {
      for (int j = tid; j < kBN; j += blockDim.x) {
        const int key = k0 + j;
        const float* ka = nullptr;
        const float* va = nullptr;
        if (key < k_end) {
          const int pi = key / s.page;
          long long o;
          if (FUSED && pi >= p0) {
            o = ((b * n_wp + (pi - p0)) * s.KV + g) * 2;
            ka = kszn + o;
            va = vszn + o;
          } else {
            const long long phys = s_bt[pi - pg_lo];
            o = SZ == kSzPage
                    ? (phys * s.KV + g) * 2
                    : ((phys * s.page + (key - pi * s.page)) * s.KV + g) * 2;
            ka = ksz + o;
            va = vsz + o;
          }
        }
        float2* dk = ssz + (st * 2) * kBN + j;
        float2* dv = dk + kBN;
        if (s.vb != 1) {
          repro::cp_async8(dk, ka ? static_cast<const void*>(ka) : any,
                           ka ? 8 : 0);
          repro::cp_async8(dv, va ? static_cast<const void*>(va) : any,
                           va ? 8 : 0);
        } else {
          *dk = ka ? make_float2(ka[0], ka[1]) : make_float2(0.f, 0.f);
          *dv = va ? make_float2(va[0], va[1]) : make_float2(0.f, 0.f);
        }
      }
    }
  };

  // rows of this lane: r0 = warp * 16 + lane / 4 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int qi = q0 + r / rep;
    row_ok[h] = r < rows && qi < s.C;
    qpos[h] = c0 + qi;
  }
  // the warp's last query position: tiles above it are all masked
  const int w_last = min(warp * 16 + 15, rows - 1);
  const int warp_kmax =
      warp * 16 < rows ? c0 + min(q0 + w_last / rep, s.C - 1) : -1;

  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {repro::kNegInf, repro::kNegInf};
  float l[2] = {0.f, 0.f};
  float zs[2] = {0.f, 0.f};    // int8: sum_j p_ij vz_j (per lane)
  float qsum[2] = {0.f, 0.f};  // int8: sum_d q_id

  if (t_hi > t_lo) {
    // q rows, zero-padded to dp columns and to rows_blk rows
    const int per = 2 * dp / s.vbq;
    for (int idx = tid; idx < rows_blk * per; idx += blockDim.x) {
      const int r = idx / per;
      const int off = (idx - r * per) * s.vbq;
      const int qi = q0 + r / rep;
      const char* src = any;
      int n = 0;
      if (r < rows && qi < s.C) {
        n = max(0, min(s.vbq, 2 * s.D - off));
        if (n)
          src = reinterpret_cast<const char*>(
                    q + ((b * s.C + qi) * s.H + g * rep + r % rep) * s.D) +
                off;
      }
      repro::cp_chunk(reinterpret_cast<char*>(sq) + r * 2 * qp + off, src, n,
                      s.vbq);
    }
    issue(t_lo, 0);
  }
  repro::cp_async_commit();

  if (FUSED && blockIdx.x == 0 && split == 0)
    write_chunk<TKV, SZ>(kp, vp, ksz, vsz, kn, vn, kszn, vszn, bt_row, b, g,
                         p0, n_wp, s.C, s.KV, s.D, s.page);

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      issue(t + 1, st ^ 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // stage st (and, first, q) landed for every thread
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    if constexpr (kI8) {
      // int8 payload -> bf16, unscaled (exact)
      const unsigned char* kr = ring + (st * 2) * kBN * rp;
      const int per = dp / 16;
      for (int idx = tid; idx < 2 * kBN * per; idx += blockDim.x) {
        const int row = idx / per;  // 0 .. 2 kBN - 1: k rows, then v rows
        const int c = (idx - row * per) * 16;
        const int4 raw =
            *reinterpret_cast<const int4*>(kr + row * rp + c);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = repro::pack_bf16(static_cast<float>(e[2 * i]),
                                  static_cast<float>(e[2 * i + 1]));
        uint4* dst = reinterpret_cast<uint4*>(ck + row * qp + c);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
      if (SZ != kSzNone && t == t_lo) {
        // sum_d q_id of this lane's two rows, across the quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float a = 0.f;
          for (int d = lane & 3; d < dp; d += 4)
            a += __bfloat162float(sq[(r0 + 8 * h) * qp + d]);
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          qsum[h] = a;
        }
      }
      __syncthreads();
      kt = ck;
      vt = cv;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(ring + (st * 2) * kBN * rp);
      vt = kt + kBN * qp;
    }
    const int k0 = t * kBN;
    if (k0 <= warp_kmax) {
      // S = Q K^T for the warp's 16 rows x 64 keys
      float sc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks) {
        if (ks < kd) {
          uint32_t a[4];
          repro::ldsm_x4(a, sq + (warp * 16 + (lane & 15)) * qp + ks * 16 +
                                (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bb[4];
            repro::ldsm_x4(bb, kt + (np * 16 + (lane & 7) +
                                     ((lane >> 4) & 1) * 8) * qp +
                                   ks * 16 + ((lane >> 3) & 1) * 8);
            repro::mma_bf16(sc[2 * np], a, bb[0], bb[1]);
            repro::mma_bf16(sc[2 * np + 1], a, bb[2], bb[3]);
          }
        }
      }
      // scale, mask, online softmax in the accumulator layout
      const float2* kzs = ssz + (st * 2) * kBN;
      const float2* vzs = kzs + kBN;
      float mx[2] = {repro::kNegInf, repro::kNegInf};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int j = nt * 8 + 2 * (lane & 3) + (e & 1);
          const int key = k0 + j;
          float v = sc[nt][e];
          if (SZ != kSzNone) {
            const float2 z = kzs[j];
            v = z.x * v + z.y * qsum[h];
          }
          v *= s.scale;
          const bool live = key < k_end && key <= qpos[h];
          sc[nt][e] = live ? v : repro::kNegInf;
          mx[h] = fmaxf(mx[h], sc[nt][e]);
        }
      }
      float alpha[2], ls[2] = {0.f, 0.f}, zp[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int j = nt * 8 + 2 * (lane & 3) + (e & 1);
          const int key = k0 + j;
          const bool live = key < k_end && key <= qpos[h];
          float p = live ? expf(sc[nt][e] - m[h]) : 0.f;
          ls[h] += p;
          if (SZ != kSzNone) {
            const float2 z = vzs[j];
            zp[h] += p * z.y;
            p *= z.x;
          }
          sc[nt][e] = p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = l[h] * alpha[h] + ls[h];
        zs[h] = zs[h] * alpha[h] + zp[h];
      }
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
      // O += P V: P's accumulators are PV's A fragments, 16 keys a step,
      // as a bf16 hi + lo pair (two products), so P keeps about 16 bits
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        repro::pack_bf16_split(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
        repro::pack_bf16_split(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
        repro::pack_bf16_split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2],
                               al[2]);
        repro::pack_bf16_split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3],
                               al[3]);
#pragma unroll
        for (int np = 0; np < DMAX / 16; ++np) {
          if (np < kd) {
            uint32_t bb[4];
            repro::ldsm_x4_t(bb, vt + (kk * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * qp +
                                     np * 16 + (lane >> 4) * 8);
            repro::mma_bf16(acc[2 * np], ah, bb[0], bb[1]);
            repro::mma_bf16(acc[2 * np], al, bb[0], bb[1]);
            repro::mma_bf16(acc[2 * np + 1], ah, bb[2], bb[3]);
            repro::mma_bf16(acc[2 * np + 1], al, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // stage st (and the bf16 copy) free for reuse
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    zs[h] += __shfl_xor_sync(0xffffffffu, zs[h], 1);
    zs[h] += __shfl_xor_sync(0xffffffffu, zs[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int r = r0 + 8 * h;
    const long long row =
        (b * s.C + (q0 + r / rep)) * s.H + g * rep + r % rep;
    if (s.n_split == 1) {
      const float l_safe = fmaxf(l[h], repro::kMinDenom);
      __nv_bfloat16* o = out + row * s.D;
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int d = i * 8 + 2 * (lane & 3);
        if (d < s.D)
          o[d] = __float2bfloat16_rn((acc[i][2 * h] + zs[h]) / l_safe);
        if (d + 1 < s.D)
          o[d + 1] =
              __float2bfloat16_rn((acc[i][2 * h + 1] + zs[h]) / l_safe);
      }
    } else {
      const long long base = split * s.R + row;
      float* o = part + base * dp;
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int d = i * 8 + 2 * (lane & 3);
        if (d < dp)
          *reinterpret_cast<float2*>(o + d) =
              make_float2(acc[i][2 * h] + zs[h], acc[i][2 * h + 1] + zs[h]);
      }
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(part_ml + base * 2) =
            make_float2(m[h], l[h]);
    }
  }
}

// merge the n_split partial (acc, m, l) of each output row:
// o = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30)
__global__ void paged_prefill_combine_kernel(const float* __restrict__ part,
                                             const float* __restrict__ ml,
                                             __nv_bfloat16* __restrict__ out,
                                             long long R, int D, int dp,
                                             int n_split) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= R * D) return;
  const long long row = i / D;
  const int d = static_cast<int>(i - row * D);
  float M = repro::kNegInf;
  for (int sp = 0; sp < n_split; ++sp)
    M = fmaxf(M, ml[(sp * R + row) * 2]);
  float L = 0.f, o = 0.f;
  for (int sp = 0; sp < n_split; ++sp) {
    const long long base = sp * R + row;
    const float w = expf(ml[base * 2] - M);
    L += w * ml[base * 2 + 1];
    o += w * part[base * dp + d];
  }
  out[i] = __float2bfloat16_rn(o / fmaxf(L, repro::kMinDenom));
}

struct Args {
  const void* q;
  void *kp, *vp, *ksz, *vsz;
  const void *kn, *vn, *kszn, *vszn, *bt, *c0;
  void* out;
  int B, C, H, KV, D, page, n_pages;
  float scale;
  int rows_blk, n_split, n_tab, vb, vbq, smem;
  void *part, *part_ml;
  cudaStream_t stream;
};

template <typename T, typename TKV, int SZ, bool FUSED, int DPL>
int launch_fma(const Args& a) {
  const int rep = a.H / a.KV;
  const int bq = rep >= kRows ? 1 : kRows / rep;  // query positions/block
  const size_t smem =
      sizeof(float) * (kRows * a.D + 2 * kBK * repro::odd_pitch(a.D));
  if (static_cast<int>(smem) != a.smem)
    return static_cast<int>(cudaErrorInvalidValue);
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

template <typename TKV, int SZ, bool FUSED, int DMAX>
int launch_mma(const Args& a) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int rep = a.H / a.KV;
  const bool i8 = std::is_same<TKV, int8_t>::value;
  if (a.rows_blk % 16 != 0 || a.rows_blk > kMaxThreads / 2 ||
      a.rows_blk < rep || a.n_split < 1)
    return bad;
  const MmaSmem lay(a.rows_blk, a.D, i8, SZ != kSzNone, a.n_tab);
  if (lay.total != a.smem) return bad;
  auto kernel = paged_prefill_mma_kernel<TKV, SZ, FUSED, DMAX>;
  cudaError_t err = repro::allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  MmaShape s{a.C, a.H, a.KV, a.D, a.page, a.n_pages, a.rows_blk / rep,
             a.n_split, a.n_tab, a.vb, a.vbq,
             static_cast<long long>(a.B) * a.C * a.H, a.scale};
  dim3 grid((a.C + s.bq - 1) / s.bq, a.KV, a.B * a.n_split);
  kernel<<<grid, 2 * a.rows_blk, lay.total, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<TKV*>(a.kp),
      static_cast<TKV*>(a.vp), static_cast<float*>(a.ksz),
      static_cast<float*>(a.vsz), static_cast<const TKV*>(a.kn),
      static_cast<const TKV*>(a.vn), static_cast<const float*>(a.kszn),
      static_cast<const float*>(a.vszn), static_cast<const int*>(a.bt),
      static_cast<const int*>(a.c0), static_cast<__nv_bfloat16*>(a.out),
      static_cast<float*>(a.part), static_cast<float*>(a.part_ml), s);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  const long long n = s.R * a.D;
  paged_prefill_combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256,
                                 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<const float*>(a.part_ml),
      static_cast<__nv_bfloat16*>(a.out), s.R, a.D, (a.D + 15) & ~15,
      a.n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TKV, int SZ, bool FUSED>
int launch_d(const Args& a) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same<T, float>::value) {
    switch (repro::lane_width(a.D)) {
      case 1: return launch_fma<float, TKV, SZ, FUSED, 1>(a);
      case 2: return launch_fma<float, TKV, SZ, FUSED, 2>(a);
      case 4: return launch_fma<float, TKV, SZ, FUSED, 4>(a);
      case 8: return launch_fma<float, TKV, SZ, FUSED, 8>(a);
      default: return bad;
    }
  } else {
    const int dp = (a.D + 15) & ~15;
    if (dp <= 32) return launch_mma<TKV, SZ, FUSED, 32>(a);
    if (dp <= 64) return launch_mma<TKV, SZ, FUSED, 64>(a);
    if (dp <= 128) return launch_mma<TKV, SZ, FUSED, 128>(a);
    if (dp <= 256) return launch_mma<TKV, SZ, FUSED, 256>(a);
    return bad;
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
// The launch plan (`launch_plan` in kernels/flash_attention/
// paged_prefill.py): bf16 q takes rows_blk (32 | 64) rows per block,
// n_split key splits (part (n_split, B*C*H, D padded to 16) and part_ml
// (n_split, B*C*H, 2) f32 scratch when n_split > 1), n_tab block-table
// entries per block, cp.async widths vb (K/V rows) and vbq (q rows) of
// 16, 4 or 1 (synchronous); float32 q ignores them. `smem` is the plan's
// dynamic shared-memory bytes, checked against the kernel's own layout.
// Returns cudaGetLastError() of the launch (cudaErrorInvalidValue for an
// operand or plan the kernels do not take).
extern "C" int repro_paged_prefill(
    const void* q, void* kp, void* vp, void* ksz, void* vsz, const void* kn,
    const void* vn, const void* kszn, const void* vszn, const void* bt,
    const void* c0, void* out, int B, int C, int H, int KV, int D, int page,
    int n_pages, int q_dtype, int kv_dtype, int sz_mode, int fused,
    float scale, int rows_blk, int n_split, int n_tab, int vb, int vbq,
    int smem, void* part, void* part_ml, void* stream) {
  if (B == 0 || C == 0) return 0;
  Args a{q,    kp,      vp,     ksz,    vsz,  kn,   vn,    kszn,
         vszn, bt,      c0,     out,    B,    C,    H,     KV,
         D,    page,    n_pages, scale, rows_blk, n_split, n_tab, vb,
         vbq,  smem,    part,   part_ml, static_cast<cudaStream_t>(stream)};
  if (q_dtype == repro::kF32)
    return launch_kv<float>(a, kv_dtype, sz_mode, fused);
  if (q_dtype == repro::kBF16)
    return launch_kv<__nv_bfloat16>(a, kv_dtype, sz_mode, fused);
  return static_cast<int>(cudaErrorInvalidValue);
}
