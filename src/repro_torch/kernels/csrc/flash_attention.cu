// Dense GQA flash-attention forward (bucket prefill).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
// `_fwd_pallas` / `flash_mha` (forward only; the backward pass ports with
// the training slice and will read the lse written here).
//
// Bound: at the serving shapes (one prompt of 64..512 tokens, 15/5 heads,
// D = 64) the bytes (q, k, v and o once, lse) take about 0.2 us at
// 3.35 TB/s and the 4 * D * (unmasked query-key pairs) operations as long
// at the bf16 tensor-core rate: the kernel is bound by its own latency
// chain (loads, a few tiles of products, the write), not by the card.
//
// What the first design lost (9.2x SDPA at the main shape): one block per
// (16 query positions, query head), so each of the rep = H / KV heads of a
// group loaded the same K/V tile again; QK^T a 64-long float32 FMA chain
// per lane out of shared memory and PV 32 shuffles per row per tile, no
// tensor core; K/V staged as float32 by synchronous loads with two
// barriers per 32-key tile, no copy in flight during the arithmetic; each
// warp walked its 4 rows one after another.
//
// bf16 (every engine path): `flash_mma_kernel`, the pattern of
// `paged_prefill_mma_kernel` (csrc/paged_prefill.cu) without the pool.
// - Rows of a block are consecutive (query position, head of the KV group)
//   pairs, row = qi * rep + head, so one staged K/V tile serves every head
//   of the group and every row slot holds a real row (the last block of a
//   head is ragged). The grid goes over KV heads, not query heads.
// - A block is 4 warps: rows / 16 row groups of 16 rows times 64 / rows key
//   groups. The launch plan (`kernels/flash_attention/flash_attention.py`
//   `launch_plan`) takes 32 rows, so two warps share each row group and
//   take its 64-key tiles in turn, and merge their (acc, m, l) through
//   shared memory at the end: at the main shape (Sq = 128, rep 3) 60
//   blocks whose warps each compute one tile, where 64-row blocks left 30
//   SMs each two tiles deep (slower when timed, PERF.md).
// - QK^T and PV run on mma.sync m16n8k16 bf16 -> f32, fed by ldmatrix (K
//   plain, V transposed); D is padded to a multiple of 16 with zeros, so
//   any D <= 256 works. P goes into PV as a bf16 hi + lo pair (two
//   products, about 16 bits), as the reference computes PV in float32:
//   with P in one bf16 the paged-prefill body moved a quarter of its
//   outputs one bf16 ulp and flipped an engine token.
// - Copies: each round's K/V tiles (one per key group) go through a
//   double-buffered cp.async ring (16 bytes where rows allow, else 4, else
//   synchronous bytes), the next round issued before the current round's
//   arithmetic. Causal tiles past the block's last query (with kv_offset)
//   are never loaded, and a warp whose rows all lie above a tile's keys
//   skips its arithmetic.
// - Key-range split across blocks where the plan finds too few blocks for
//   the card (flash-decoding): each split writes its unnormalized (acc, m,
//   l) to a float32 scratch and `flash_combine_kernel` merges them,
//   writing the output and the lse.
// - Where a block's time goes (`scripts/kernel_phases.py`, PERF.md):
//   issuing the first copies, one tile's products and softmax with one
//   warp per scheduler, and the write; SDPA stays faster at the main
//   shape.
// - What that body lost at D 256 (paligemma-3b's prefix + prompt, 384
//   positions x 8 heads on one KV head; NVIDIA H100 80GB HBM3, 700 W):
//   every warp owned all 256 output columns of its 16 rows, 128 float32
//   accumulators a lane besides S and P's two halves, 255 registers; two
//   key groups' tile rings did not fit, so the plan took 64-row blocks
//   with one key group, 48 blocks, split 6 ways over the keys and merged
//   by the combine kernel through float32 scratch: 0.046 ms against
//   SDPA's 0.014, the combine a quarter of it.
// - Above D 128 (D padded to 16) a row group's 16 rows belong to 4
//   column warps over 32-key tiles: each warp computes the tile's S over
//   a quarter of the depth (four independent 4-deep mma chains, q's
//   fragments of that quarter held in registers), the four partial tiles
//   meet in shared memory behind a named barrier of the four warps, every
//   warp sums them in the same order and runs the same online softmax on
//   the whole tile (so m and l agree bit for bit), then P V for its own
//   64 columns (32 accumulators a lane). Blocks of 16 rows with two key
//   groups, 256 threads: 192 blocks at paligemma's shape, no key split;
//   causal blocks run in reverse order, the longest key ranges first.
//
// float32 (the sweep's 1e-5 gate, which bf16 products cannot meet; no
// engine path): `flash_fma_kernel`, the first design, kept as it was.
//
// Output in q's dtype, lse (B, H, Sq) f32 = m + log(max(l, 1e-30)); masked
// logits -1e30, keys past Skv contribute nothing.

#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------- float32: FMA body
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBK = 32;                     // keys per tile: one per lane

// One block per (tile of 16 query rows, query head, batch row), 4 warps of
// 4 rows; K/V tiles of 32 keys staged in shared memory as f32 (odd row
// pitch, so the 32 lanes' rows hit 32 banks); lane j scores key j, each
// lane accumulates ceil(D/32) head-dim values of P.V.
template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
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
    qs[idx] = qi < Sq ? q[((b * Sq + qi) * H + h) * D + d] : 0.f;
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
        kk = k[o];
        vv = v[o];
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
      if (d < D) out[((b * Sq + qi) * H + h) * D + d] = acc[rr][i] / l_safe;
    }
    if (lane == 0) lse[(b * H + h) * Sq + qi] = m[rr] + logf(l_safe);
  }
}

// ------------------------------------------- bf16: tensor-core body
constexpr int kBN = 64;          // keys per tile (D <= 128)
constexpr int kThreadsMma = 128;  // 4 warps (D <= 128)
constexpr int kBNWide = 32;      // keys per tile above D 128
constexpr int kColGroups = 4;    // warps sharing a row group above D 128
constexpr int kMaxThreadsWide = 256;
constexpr int kSPitch = kBNWide + 8;  // f32 pitch of a row group's S tile

// Shared-memory layout of the tensor-core body, in bytes; every region
// starts 16-byte aligned. The launch plan in Python mirrors it.
struct MmaSmem {
  int q, ring, sx, total;
  __host__ __device__ MmaSmem(int rows_blk, int D, int kp, int tile) {
    const int qp = 2 * (((D + 15) & ~15) + 8);  // bf16 row pitch, bytes
    q = rows_blk * qp;                           // [rows_blk] q rows
    ring = 2 * kp * 2 * tile * qp;  // [round parity][key group][k, v][tile]
    // above D 128: [row group][key group][column warp][16][kSPitch] f32
    // partial S tiles
    sx = ((D + 15) & ~15) > 128
             ? rows_blk / 16 * kp * kColGroups * 16 * kSPitch * 4
             : 0;
    total = q + ring + sx;
  }
};

// a barrier of `n` threads (whole warps) under id `id` (1..15)
__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

struct MmaShape {
  int Sq, Skv, H, KV, D, rows_blk, kp, n_split, vb, causal, kv_offset;
  long long R;  // output rows B * Sq * H
  float scale;
};

// DMAX <= 128: 4 warps, each a row group's 16 rows over every output
// column. DMAX 256: kColGroups warps share a row group over 32-key tiles:
// each computes the tile's S over a quarter of the depth (four
// independent 4-deep mma chains), the four partial tiles meet in shared
// memory and every warp sums them in the same order, runs the same
// online softmax on the whole tile (the same arithmetic, so m and l
// agree bit for bit) and P V for its quarter of the columns.
template <int DMAX>
__global__ void __launch_bounds__(DMAX > 128 ? kMaxThreadsWide : kThreadsMma)
    flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part,
    float* __restrict__ part_ml, MmaShape s) {
  constexpr int kNCG = DMAX > 128 ? kColGroups : 1;  // column groups
  constexpr int kTile = DMAX > 128 ? kBNWide : kBN;  // keys per tile
  constexpr int kNT = DMAX / 8 / kNCG;   // 8-wide d tiles a warp owns
  constexpr int kNP = DMAX / 16 / kNCG;  // 16-wide d tiles a warp owns
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_thr = kNCG == 1 ? kThreadsMma : blockDim.x;
  const int rows_blk = s.rows_blk;
  const int n_rg = rows_blk / 16;        // row groups of 16 rows
  const int kp = kNCG == 1 ? 4 / n_rg : s.kp;  // key groups
  const int cg = warp % kNCG;            // this warp's columns, ...
  const int rg = warp / kNCG % n_rg;     // ... its rows ...
  const int kg = warp / kNCG / n_rg;     // ... and its share of the tiles
  const int rep = s.H / s.KV;
  const int dp = (s.D + 15) & ~15;
  const int kd = dp / 16;                // 16-deep k steps of QK^T
  const int qp = dp + 8;                 // bf16 row pitch (elements)
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* ring = sq + rows_blk * qp;  // tile slots of [k, v][kTile][qp]
  float* s_x = reinterpret_cast<float*>(ring + 2 * kp * 2 * kTile * qp);

  const int g = blockIdx.y;
  const long long b = blockIdx.z / s.n_split;
  const int split = blockIdx.z - static_cast<int>(b) * s.n_split;
  // row slots of the block: rows row0 .. row0 + rows_blk - 1 of the head
  // group's Sq * rep rows, row = qi * rep + head
  const int n_rows = s.Sq * rep;
  // above D 128 the causal blocks run the longest key ranges first
  const int bx = kNCG > 1 && s.causal ? gridDim.x - 1 - blockIdx.x
                                      : blockIdx.x;
  const int row0 = bx * rows_blk;
  const int q_last = (min(row0 + rows_blk, n_rows) - 1) / rep;
  const int k_end =
      s.causal ? max(0, min(s.Skv, s.kv_offset + q_last + 1)) : s.Skv;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int t_lo = split * n_tiles / s.n_split;
  const int t_hi = (split + 1) * n_tiles / s.n_split;

  const char* any = reinterpret_cast<const char*>(k);  // for empty copies
  const int row_bytes = 2 * s.D;
  const int per = 2 * dp / s.vb;         // copies per staged row
  // a thread's copies of a staged tile are chunks tid, tid + n_thr, ...:
  // its first (row, chunk) and the step, so the loop does not divide
  const int j0 = tid / per, c0 = tid - j0 * per;
  const int dj = n_thr / per, dc = n_thr - dj * per;
  const long long kv0 = (b * s.Skv * s.KV + g) * s.D;  // key 0's row
  const long long kv_step = static_cast<long long>(s.KV) * s.D;
  // K/V rows of tile t into tile slot `slot`, zero-padded to dp columns
  auto issue = [&](int t, int slot) {
    const int k0 = t * kTile;
    char* kr = reinterpret_cast<char*>(ring + slot * 2 * kTile * qp);
    char* vr = kr + 2 * kTile * qp;
    for (int j = j0, c = c0; j < kTile;) {
      const int off = c * s.vb;
      const int key = k0 + j;
      const char* ksrc = any;
      const char* vsrc = any;
      int n = 0;
      if (key < k_end) {
        n = max(0, min(s.vb, row_bytes - off));
        if (n) {
          const long long o = kv0 + key * kv_step;
          ksrc = reinterpret_cast<const char*>(k + o) + off;
          vsrc = reinterpret_cast<const char*>(v + o) + off;
        }
      }
      repro::cp_chunk(kr + j * 2 * qp + off, ksrc, n, s.vb);
      repro::cp_chunk(vr + j * 2 * qp + off, vsrc, n, s.vb);
      j += dj;
      c += dc;
      if (c >= per) {
        c -= per;
        ++j;
      }
    }
  };
  // round r: key group j takes tile t_lo + r * kp + j, in slot
  // (r & 1) * kp + j
  auto issue_round = [&](int r) {
    for (int j = 0; j < kp; ++j) {
      const int t = t_lo + r * kp + j;
      if (t < t_hi) issue(t, (r & 1) * kp + j);
    }
  };

  // rows of this lane: r0 = rg * 16 + lane / 4 and r0 + 8
  const int r0 = rg * 16 + (lane >> 2);
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r0 + 8 * h;
    row_ok[h] = row < n_rows;
    qpos[h] = s.kv_offset + row / rep;
  }
  // the warp's last key: tiles above it are all masked for its rows
  const int w_row = row0 + rg * 16;
  const int warp_kmax =
      w_row >= n_rows ? -1
      : s.causal      ? s.kv_offset + (min(w_row + 15, n_rows - 1)) / rep
                      : s.Skv;

  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {repro::kNegInf, repro::kNegInf};
  float l[2] = {0.f, 0.f};
  // above D 128 the q fragments of the warp's quarter of the depth stay
  // in registers over the tiles
  constexpr int kKQ = DMAX / 16 / kNCG;  // k-steps a column warp takes
  uint32_t qa[kNCG > 1 ? kKQ : 1][4];

  if (t_hi > t_lo) {
    // q rows, zero-padded to dp columns and past the last row
    for (int idx = tid; idx < rows_blk * per; idx += n_thr) {
      const int r = idx / per;
      const int off = (idx - r * per) * s.vb;
      const int row = row0 + r;
      const char* src = any;
      int n = 0;
      if (row < n_rows) {
        n = max(0, min(s.vb, row_bytes - off));
        if (n) {
          const int qi = row / rep;
          const int h = g * rep + (row - qi * rep);
          src = reinterpret_cast<const char*>(
                    q + ((b * s.Sq + qi) * s.H + h) * s.D) +
                off;
        }
      }
      repro::cp_chunk(reinterpret_cast<char*>(sq) + r * 2 * qp + off, src,
                      n, s.vb);
    }
    issue_round(0);
  }
  repro::cp_async_commit();

  const int n_rounds = (t_hi - t_lo + kp - 1) / kp;
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) {
      issue_round(r + 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // round r (and, first, q) landed for every thread
    const int t = t_lo + r * kp + kg;
    const __nv_bfloat16* kt = ring + ((r & 1) * kp + kg) * 2 * kTile * qp;
    const __nv_bfloat16* vt = kt + kTile * qp;
    const int k0 = t * kTile;
    if constexpr (kNCG > 1) {
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < kKQ; ++j)
          if (cg * kKQ + j < kd)
            repro::ldsm_x4(qa[j], sq + (rg * 16 + (lane & 15)) * qp +
                                      (cg * kKQ + j) * 16 + (lane >> 4) * 8);
      }
    }
    if (t < t_hi && k0 <= warp_kmax) {
      // S = Q K^T for the warp's 16 rows x kTile keys
      float sc[kTile / 8][4];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
      if constexpr (kNCG > 1) {
        // this warp's partial S over k-steps cg * kKQ .. (four n-tiles,
        // four independent chains); the column warps' partial tiles meet
        // in shared memory and each warp sums them in column-warp order,
        // so all four hold the same S (the same condition holds for all
        // four, so all four reach the barrier)
#pragma unroll
        for (int j = 0; j < kKQ; ++j) {
          const int ks = cg * kKQ + j;
          if (ks < kd) {
#pragma unroll
            for (int np = 0; np < kTile / 16; ++np) {
              uint32_t bb[4];
              repro::ldsm_x4(bb, kt + (np * 16 + (lane & 7) +
                                       ((lane >> 4) & 1) * 8) * qp +
                                     ks * 16 + ((lane >> 3) & 1) * 8);
              repro::mma_bf16(sc[2 * np], qa[j], bb[0], bb[1]);
              repro::mma_bf16(sc[2 * np + 1], qa[j], bb[2], bb[3]);
            }
          }
        }
        float* st = s_x + (rg * kp + kg) * kNCG * 16 * kSPitch;
        const int gr = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          float* o = st + cg * 16 * kSPitch + nt * 8 + c2;
          *reinterpret_cast<float2*>(o + gr * kSPitch) =
              make_float2(sc[nt][0], sc[nt][1]);
          *reinterpret_cast<float2*>(o + (gr + 8) * kSPitch) =
              make_float2(sc[nt][2], sc[nt][3]);
        }
        named_bar(1 + rg * kp + kg, 32 * kNCG);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          float2 x0 = make_float2(0.f, 0.f), x1 = x0;
#pragma unroll
          for (int c = 0; c < kNCG; ++c) {
            const float* o = st + c * 16 * kSPitch + nt * 8 + c2;
            const float2 a0 = *reinterpret_cast<const float2*>(o + gr * kSPitch);
            const float2 a1 =
                *reinterpret_cast<const float2*>(o + (gr + 8) * kSPitch);
            x0.x += a0.x;
            x0.y += a0.y;
            x1.x += a1.x;
            x1.y += a1.y;
          }
          sc[nt][0] = x0.x;
          sc[nt][1] = x0.y;
          sc[nt][2] = x1.x;
          sc[nt][3] = x1.y;
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < DMAX / 16; ++ks) {
          if (ks < kd) {
            uint32_t a[4];
            repro::ldsm_x4(a, sq + (rg * 16 + (lane & 15)) * qp + ks * 16 +
                                  (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < kTile / 16; ++np) {
              uint32_t bb[4];
              repro::ldsm_x4(bb, kt + (np * 16 + (lane & 7) +
                                       ((lane >> 4) & 1) * 8) * qp +
                                     ks * 16 + ((lane >> 3) & 1) * 8);
              repro::mma_bf16(sc[2 * np], a, bb[0], bb[1]);
              repro::mma_bf16(sc[2 * np + 1], a, bb[2], bb[3]);
            }
          }
        }
      }
      // scale, mask, online softmax in the accumulator layout
      float mx[2] = {repro::kNegInf, repro::kNegInf};
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const bool live = key < k_end && (!s.causal || key <= qpos[h]);
          sc[nt][e] = live ? sc[nt][e] * s.scale : repro::kNegInf;
          mx[h] = fmaxf(mx[h], sc[nt][e]);
        }
      }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int key = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const bool live = key < k_end && (!s.causal || key <= qpos[h]);
          const float p = live ? expf(sc[nt][e] - m[h]) : 0.f;
          ls[h] += p;
          sc[nt][e] = p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ls[h];
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
      // O += P V: P's accumulators are PV's A fragments, 16 keys a step,
      // as a bf16 hi + lo pair (two products), so P keeps about 16 bits;
      // the warp's own 16-wide d tiles cg * kNP + j
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t ah[4], al[4];
        repro::pack_bf16_split(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
        repro::pack_bf16_split(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
        repro::pack_bf16_split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2],
                               al[2]);
        repro::pack_bf16_split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3],
                               al[3]);
#pragma unroll
        for (int jp = 0; jp < kNP; ++jp) {
          const int np = cg * kNP + jp;
          if (np < kd) {
            uint32_t bb[4];
            repro::ldsm_x4_t(bb, vt + (kk * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * qp +
                                     np * 16 + (lane >> 4) * 8);
            repro::mma_bf16(acc[2 * jp], ah, bb[0], bb[1]);
            repro::mma_bf16(acc[2 * jp], al, bb[0], bb[1]);
            repro::mma_bf16(acc[2 * jp + 1], ah, bb[2], bb[3]);
            repro::mma_bf16(acc[2 * jp + 1], al, bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // round r's slots free for reuse
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  if (kp > 1) {
    // the key groups' (acc, m, l) merge into key group 0's, in group
    // order, through the (now free) ring: [kp - 1][rows_blk] (m, l) pairs,
    // then [kp - 1][rows_blk][dp] acc
    float* ml_s = reinterpret_cast<float*>(ring);
    float* acc_s = ml_s + (kp - 1) * rows_blk * 2;
    if (kg > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = (kg - 1) * rows_blk + r0 + 8 * h;
        if ((lane & 3) == 0 && cg == 0)
          *reinterpret_cast<float2*>(ml_s + slot * 2) = make_float2(m[h], l[h]);
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          const int d = (cg * kNT + i) * 8 + 2 * (lane & 3);
          if (d < dp)
            *reinterpret_cast<float2*>(acc_s + slot * dp + d) =
                make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
        }
      }
    }
    __syncthreads();
    if (kg > 0) return;
    for (int j = 1; j < kp; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int slot = (j - 1) * rows_blk + r0 + 8 * h;
        const float2 ml2 = *reinterpret_cast<const float2*>(ml_s + slot * 2);
        const float M = fmaxf(m[h], ml2.x);
        const float c = expf(m[h] - M);
        const float c2 = expf(ml2.x - M);
        l[h] = l[h] * c + ml2.y * c2;
        m[h] = M;
#pragma unroll
        for (int i = 0; i < kNT; ++i) {
          const int d = (cg * kNT + i) * 8 + 2 * (lane & 3);
          if (d < dp) {
            const float2 a2 =
                *reinterpret_cast<const float2*>(acc_s + slot * dp + d);
            acc[i][2 * h] = acc[i][2 * h] * c + a2.x * c2;
            acc[i][2 * h + 1] = acc[i][2 * h + 1] * c + a2.y * c2;
          }
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int row = row0 + r0 + 8 * h;
    const int qi = row / rep;
    const int hq = g * rep + (row - qi * rep);
    const long long orow = (b * s.Sq + qi) * s.H + hq;
    if (s.n_split == 1) {
      const float l_safe = fmaxf(l[h], repro::kMinDenom);
      const float inv = 1.f / l_safe;
      __nv_bfloat16* o = out + orow * s.D;
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int d = (cg * kNT + i) * 8 + 2 * (lane & 3);
        if (d + 1 < s.D && (s.D & 1) == 0) {  // a bf16 pair, 4-byte aligned
          *reinterpret_cast<uint32_t*>(o + d) =
              repro::pack_bf16(acc[i][2 * h] * inv, acc[i][2 * h + 1] * inv);
        } else {
          if (d < s.D) o[d] = __float2bfloat16_rn(acc[i][2 * h] * inv);
          if (d + 1 < s.D)
            o[d + 1] = __float2bfloat16_rn(acc[i][2 * h + 1] * inv);
        }
      }
      if ((lane & 3) == 0 && cg == 0)
        lse[(b * s.H + hq) * s.Sq + qi] = m[h] + logf(l_safe);
    } else {
      const long long base = split * s.R + orow;
      float* o = part + base * dp;
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        const int d = (cg * kNT + i) * 8 + 2 * (lane & 3);
        if (d < dp)
          *reinterpret_cast<float2*>(o + d) =
              make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
      }
      if ((lane & 3) == 0 && cg == 0)
        *reinterpret_cast<float2*>(part_ml + base * 2) =
            make_float2(m[h], l[h]);
    }
  }
}

// merge the n_split partial (acc, m, l) of each output row (b, qi, h):
// o = sum_s e^(m_s - M) acc_s / max(L, 1e-30), L = sum_s e^(m_s - M) l_s,
// lse = M + log(max(L, 1e-30))
__global__ void flash_combine_kernel(const float* __restrict__ part,
                                     const float* __restrict__ ml,
                                     __nv_bfloat16* __restrict__ out,
                                     float* __restrict__ lse, long long R,
                                     int Sq, int H, int D, int dp,
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
  const float l_safe = fmaxf(L, repro::kMinDenom);
  out[i] = __float2bfloat16_rn(o / l_safe);
  if (d == 0) {
    const long long b = row / (static_cast<long long>(Sq) * H);
    const int rem = static_cast<int>(row - b * Sq * H);
    const int qi = rem / H;
    lse[(b * H + (rem - qi * H)) * Sq + qi] = M + logf(l_safe);
  }
}

struct Args {
  const void *q, *k, *v;
  void *out, *lse;
  int B, Sq, Skv, H, KV, D;
  float scale;
  int causal, kv_offset, rows_blk, key_groups, n_split, vb, smem;
  void *part, *part_ml;
  cudaStream_t stream;
};

template <int DPL>
int launch_fma(const Args& a) {
  const size_t smem =
      sizeof(float) * (kBQ * a.D + 2 * kBK * repro::odd_pitch(a.D));
  if (static_cast<int>(smem) != a.smem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fma_kernel<DPL>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  kernel<<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      static_cast<float*>(a.lse), a.Sq, a.Skv, a.H, a.KV, a.D, a.scale,
      a.causal, a.kv_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int DMAX>
int launch_mma(const Args& a) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((a.rows_blk != 16 && a.rows_blk != 32 && a.rows_blk != 64) ||
      a.n_split < 1 || (a.vb != 16 && a.vb != 4 && a.vb != 1))
    return bad;
  constexpr bool wide = DMAX > 128;
  const int n_rg = a.rows_blk / 16;
  const int threads =
      wide ? 32 * kColGroups * n_rg * a.key_groups : kThreadsMma;
  if (wide ? a.key_groups < 1 || threads > kMaxThreadsWide
           : a.key_groups != 4 / n_rg)
    return bad;
  const MmaSmem lay(a.rows_blk, a.D, a.key_groups, wide ? kBNWide : kBN);
  if (lay.total != a.smem) return bad;
  auto kernel = flash_mma_kernel<DMAX>;
  cudaError_t err = repro::allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long R = static_cast<long long>(a.B) * a.Sq * a.H;
  MmaShape s{a.Sq,         a.Skv,     a.H,    a.KV,     a.D,
             a.rows_blk,   a.key_groups, a.n_split, a.vb, a.causal,
             a.kv_offset,  R,         a.scale};
  const int rep = a.H / a.KV;
  dim3 grid((a.Sq * rep + a.rows_blk - 1) / a.rows_blk, a.KV,
            a.B * a.n_split);
  kernel<<<grid, threads, lay.total, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse),
      static_cast<float*>(a.part), static_cast<float*>(a.part_ml), s);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return static_cast<int>(err);
  const long long n = R * a.D;
  flash_combine_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                         a.stream>>>(
      static_cast<const float*>(a.part), static_cast<const float*>(a.part_ml),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.lse), R,
      a.Sq, a.H, a.D, (a.D + 15) & ~15, a.n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Skv,KV,D) contiguous in `dtype` (kF32 | kBF16);
// out (B,Sq,H,D) in `dtype`, lse (B,H,Sq) f32. The launch plan
// (`launch_plan` in kernels/flash_attention/flash_attention.py): bf16
// takes rows_blk (16 | 32 | 64) row slots per block in key_groups groups
// of warps (4 / (rows_blk / 16) at D <= 128; above it 1 or 2, each of
// kColGroups warps per row group), n_split key splits
// (part (n_split, B*Sq*H, D padded to 16) and part_ml (n_split, B*Sq*H, 2)
// f32 scratch when n_split > 1) and the cp.async width vb (16, 4 or 1:
// synchronous) of q, k and v rows; float32 ignores them. `smem` is the
// plan's dynamic shared-memory bytes, checked against the kernel's own
// layout. Returns cudaGetLastError() of the launch (cudaErrorInvalidValue
// for an operand or plan the kernels do not take).
extern "C" int repro_flash_mha(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int Sq, int Skv,
                               int H, int KV, int D, int dtype, float scale,
                               int causal, int kv_offset, int rows_blk,
                               int key_groups, int n_split, int vb,
                               int smem, void* part,
                               void* part_ml, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Args a{q,         k,         v,        out,        lse,
               B,         Sq,        Skv,      H,          KV,
               D,         scale,     causal,   kv_offset,  rows_blk,
               key_groups, n_split,  vb,       smem,       part,
               part_ml,   static_cast<cudaStream_t>(stream)};
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kF32) {
    switch (repro::lane_width(D)) {
      case 1: return launch_fma<1>(a);
      case 2: return launch_fma<2>(a);
      case 4: return launch_fma<4>(a);
      case 8: return launch_fma<8>(a);
      default: return bad;
    }
  }
  if (dtype == repro::kBF16) {
    const int dp = (D + 15) & ~15;
    if (dp <= 32) return launch_mma<32>(a);
    if (dp <= 64) return launch_mma<64>(a);
    if (dp <= 128) return launch_mma<128>(a);
    if (dp <= 256) return launch_mma<256>(a);
  }
  return bad;
}
