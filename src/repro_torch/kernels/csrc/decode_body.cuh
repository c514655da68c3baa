// One query token per (batch row, query head) against a KV cache whose
// rows an addressing policy locates: the body shared by the paged decode
// (`paged_decode.cu`, rows through a block table) and the contiguous
// decode (`decode_attention.cu`, rows at b * S + t).
//
// Bound: bytes. Per row the step must read its live K and V once (plus the
// int8 pool's (scale, zero) rows); the arithmetic is 4 * D flops per
// (query head, key), far below the byte time. Decode is matrix-vector (rep
// = H / KV query rows per KV group), so the arithmetic stays float32 FMA
// (and the float32 sweep's 1e-5 gate); the lever is latency and the card's
// width, not the tensor cores.
//
// What the first design lost (3.1x SDPA at the main shape): one block per
// (KV head, slot), 40 blocks at B = 8 on 132 SMs, each walking up to 257
// keys in 32-key tiles, and each tile two dependent global round trips (32
// threads resolve the table entries and (scale, zero) rows, then the block
// loads K/V) with barriers between them.
//
// What the split body then lost at shapes the main path does not have
// (NVIDIA H100 80GB HBM3, 700 W, `scripts/kernel_phases.py`, per block):
// - Long key ranges (a sequence-sharded decode's 16384-position block,
//   B 1, 40 / 8 heads, D 128): 64-key spans for every length, so 256
//   spans, and the last span block of a (slot, KV head) merged them alone,
//   a few loads at a time: 361 of 373 us of that block (0.43 ms a call
//   against SDPA's 0.042). At 2048 keys (32 spans) the merge was 41 of
//   52 us.
// - D 256 with one KV head (paligemma-3b, B 8, 8 / 1 heads, int8 pool):
//   56 blocks for 132 SMs; a lane scored its key with a 256-long serial
//   FMA chain per row, and each warp re-read the K tile for each of its
//   rows and the V tile element by element: products 22.7 and merge 24.1
//   of 53 us (2.2x SDPA).
//
// Design: the slot's key range is split into spans, one block per (KV
// head, slot, span), grid (KV, B, n_span) with n_span from the capacity,
// so the host never reads the lengths (the launch plan,
// `kernels/decode_attention/paged.py` `decode_plan`).
// - The partition: spans of `span` keys (64; 32 above D 128, where one KV
//   head leaves the card short of blocks) while a slot needs at most
//   `kMaxSpans` (32) of them; a longer slot takes kMaxSpans spans or
//   fewer of the least multiple of `span` keys that does (`span_len`).
//   It depends only on the length and the fixed shape, never on the row
//   policy or the capacity: paged and contiguous caches partition [0,
//   length) the same way, so a paged fp engine stays bit-exact with a
//   contiguous one, and every length up to 32 spans (2048 keys at 64)
//   keeps the first split body's partition. Span blocks past the last
//   used span exit at once.
// - A block first reads the slot's length, the table entries of its
//   first two rounds (in parallel with the length: an entry at or past
//   the length is read but never dereferenced, so the table needs no
//   clamp) and q, which it stages as f32. The key range is bounded by
//   min(length, capacity), so a parked slot reads its whole cache and
//   never past it.
// - The span's keys stream through a double-buffered cp.async ring of
//   rounds of two 32-key tiles (one above D 128 for a float32 pool): the
//   round's cache rows and (scale, zero) rows (8-byte cp.async; per page
//   or per token) are located a round ahead, its K/V rows copied in the
//   cache's own type (16-byte cp.async where rows allow, else 4, else
//   synchronous bytes), one copy group a tile, each tile computed as soon
//   as its group lands while the next round is in flight. Rows are
//   staged at a pitch of an odd number of 16-byte chunks, so 32 lanes
//   reading 32 rows 16 bytes at a time hit every bank once.
// - Up to D 128, per 32-key tile, the first design's arithmetic: for each
//   of its warp's query rows lane j scores key j, dequantizing (`k *
//   scale + zero`) in registers, and each lane owns head-dim values lane
//   + 32 i of the accumulator; a slot whose keys fit in one span gets the
//   first design's sums exactly. Rows go to warps in turn, 4 warps up to
//   rep 4 and 5 from rep 5 (`block_warps`: at qwen2.5-32b's 40 / 8 heads
//   4 warps left warp 0 two rows; under 204 registers two 160-thread
//   blocks share an SM). (Reading each K chunk and V row once for all of
//   a warp's rows, in the same per-(row, dim) order, measured 1.8-2x
//   slower at the main shapes.)
// - Above D 128: 8 lanes score a key (4 keys a warp step), each over 32
//   of the 256 dims with q's slice in registers, two of the warp's rows at
//   a time, the partial sums reduced by shuffles; the scores pass through
//   shared memory to one key a lane for the softmax, and p back for P V,
//   where a lane owns 8 consecutive dims.
//   int8 values convert there through the float 2^23 + (x + 128), built
//   by a byte permute, less 2^23 + 128: the conversion instruction's
//   value at the integer pipe's rate.
// - The reference's -1e30 mask and the denominator clamped at 1e-30.
// - A slot of length 0 writes what the reference's all-masked softmax
//   gives, the mean of V: over physical page 0's rows for a paged cache
//   (the reference clamps every dead table entry to page 0), over the
//   slot's S rows for a contiguous one. Its table entries are never
//   dereferenced, and no row of length >= 1 takes this branch.
// - Merge in the same launch: a slot with one used span writes its output
//   directly. Otherwise each used span writes its float32 (acc, m, l) to a
//   scratch buffer, and the last span block to finish for the (slot, KV
//   head), found by an int32 ticket in scratch that it resets for the next
//   call, merges the partials in span order (not finish order, so the
//   result is the same on every run), online: o = sum_u e^(m_u - M) acc_u
//   / max(sum_u e^(m_u - M) l_u, 1e-30) with the running max M. Up to 8
//   spans each element loads every span's (m, l, acc) at once; past that
//   each row's (rescale, weight) per span are computed once from (m, l)
//   staged in shared memory, and every element sums its spans with the
//   loads of 8 elements in flight. (The staged merge alone, same sums,
//   took the main shapes' 2-5 spans 0.0106 -> 0.0112 ms paged and 0.0088
//   -> 0.0096 contiguous on the same card, `scripts/attention_plans.py`:
//   its two barriers and one thread's serial chain a row cost more than
//   the loads they save.)
// - On request (`lse` not null) each (row, query head) also writes its
//   float32 log-sum-exp m + log(l) over the scaled logits, M + log(L)
//   after a merge, and -1e30 for a slot of length 0, so that a caller can
//   merge the outputs of disjoint key blocks (the sequence-sharded decode
//   over a mesh) with weights e^(lse - max lse), a length-0 block's
//   exactly 0. The output is the same with or without it.
//
// Where the time goes now (same card, `scripts/kernel_phases.py`): at the
// 16384-position block a span block's products over its 512 keys take
// 52 of 71 us and the merge of 32 spans 10.6 (0.073 ms a call, 1.7x
// SDPA's 0.042); at paligemma-3b's shape the merge of 13 spans takes 9.5
// of 22 us, the products 6.1, and the call meets SDPA (0.024).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace decode {

constexpr int kWarps = 4;             // a block's warps above D 128 and up
constexpr int kThreads = kWarps * 32;  // to rep 4
constexpr int kMaxWarps = 5;          // up to D 128 from rep 5

// warps of a block: 5 from rep 5 up to D 128 (qwen2.5-32b's 40 / 8 heads:
// one warp a query row, where 4 warps left warp 0 two rows and three
// warps one), else 4. Five warps under 204 registers keep two blocks an
// SM; a warp a row up to 8 took 221 registers and one block an SM
__host__ __device__ __forceinline__ int block_warps(int D, int rep) {
  return D > 128 || rep <= kWarps ? kWarps : kMaxWarps;
}
constexpr int kMaxRowsPerWarp = 4;  // rep = H / KV <= 16
constexpr int kBK = 32;             // keys per tile: one per lane (4 per
                                    // warp step at D > 128)
constexpr int kStages = 2;          // rounds in the cp.async ring
constexpr int kMaxSpans = 32;       // spans a slot uses at most
constexpr int kMergeDirect = 8;     // spans a per-element merge loads at once
constexpr int kMergeElems = 8;      // output elements a merge thread holds

// keys a round of the ring stages: two tiles, one for a float32 pool
// above D 128 (whose rows would not fit two rounds of 64)
__host__ __device__ __forceinline__ int round_keys(int D, int esize) {
  return esize == 4 && D > 128 ? kBK : 2 * kBK;
}

enum SzMode : int { kSzNone = 0, kSzPage = 1, kSzToken = 2 };

// The slot's partition: spans of `span` keys while the slot needs at most
// kMaxSpans of them, else spans of the least multiple of `span` keys that
// keeps the count at kMaxSpans (a function of the length and the fixed
// shape only, so paged and dense caches split a length alike). The launch
// plan in Python mirrors it (`paged.key_spans`).
__host__ __device__ __forceinline__ int span_len(int n_keys, int span) {
  const int nb = (n_keys + span - 1) / span;
  return nb <= kMaxSpans ? span : span * ((nb + kMaxSpans - 1) / kMaxSpans);
}

// rows of a physical page pool (P, page, KV, D) through a (B, n_pages)
// block table
struct PagedRows {
  const int* bt;
  int page, n_pages;
  __device__ __forceinline__ int capacity() const { return n_pages * page; }
  // rows a length-0 slot averages: physical page 0's (the reference maps
  // every dead table entry there), located with entry 0
  __device__ __forceinline__ int empty_rows() const { return page; }
  // the table entry of key t (the only global read of the policy)
  __device__ __forceinline__ int entry(long long b, int t) const {
    return bt[b * n_pages + t / page];
  }
  // (page id for per-page sz, row index into the (rows, KV, D) view)
  __device__ __forceinline__ void locate(long long b, int e, int t,
                                         long long& pid,
                                         long long& row) const {
    pid = e;
    row = pid * page + t % page;
  }
};

// rows of a contiguous cache (B, S, KV, D)
struct DenseRows {
  int S;
  __device__ __forceinline__ int capacity() const { return S; }
  // rows a length-0 slot averages: all of its own
  __device__ __forceinline__ int empty_rows() const { return S; }
  __device__ __forceinline__ int entry(long long, int) const { return 0; }
  __device__ __forceinline__ void locate(long long b, int, int t,
                                         long long& pid,
                                         long long& row) const {
    pid = b;
    row = b * S + t;
  }
};

// Shared-memory layout of the split body, in bytes; every region starts
// 16-byte aligned. The launch plan in Python mirrors it.
struct Smem {
  int chunks;  // 16-byte chunks of a cache row's data
  int pitch;   // staged row pitch: an odd number of 16-byte chunks
  int dq;      // f32 q values per row (the chunks' elements, zero-padded)
  int rk;      // keys a round
  int ring, cw, sz, rows, q, wide, total;
  __host__ __device__ Smem(int D, int esize, int rep) {
    chunks = (D * esize + 15) / 16;
    pitch = 16 * (chunks | 1);
    dq = chunks * (16 / esize);
    rk = round_keys(D, esize);
    ring = kStages * 2 * rk * pitch;  // [stage][k, v][rk] rows
    // the merge's [rep][kMaxSpans] (c, w) and [rep] (M, L), over the ring
    // (the merge runs once the ring's copies have all landed)
    cw = (rep * (kMaxSpans + 1) * 8 + 15) / 16 * 16;
    // int8 pools: [stage][rk] (k scale, k zero, v scale, v zero)
    sz = esize == 1 ? kStages * rk * 16 : 0;
    rows = kStages * rk * 8;  // [stage][rk] cache row of each key
    q = rep * dq * 4;         // [rep][dq] f32
    // D > 128: [warp][row][kBK] scores / p, [warp][row] (m, l, alpha)
    wide = D > 128 ? kWarps * kMaxRowsPerWarp * (kBK + 4) * 4 : 0;
    total = (ring > cw ? ring : cw) + sz + rows + q + wide;
  }
  __host__ __device__ int after_ring() const { return ring > cw ? ring : cw; }
};

// N consecutive values of a staged row as float, in one shared-memory
// load of their bytes (two above 16 bytes). int8 values go through the
// float 2^23 + (x + 128), built by a byte permute, less 2^23 + 128: the
// same float as a conversion instruction gives, at integer-pipe rate
template <int BYTES> struct Raw;
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

__device__ __forceinline__ float i8_at(unsigned w, int k) {
  // w's bytes already offset by 128 (w ^ 0x80808080)
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + k)) -
         8388736.f;
}

template <typename TKV, int N>
__device__ __forceinline__ void load_vals(const unsigned char* p, float* out) {
  constexpr int kBytes = N * static_cast<int>(sizeof(TKV));
  if constexpr (kBytes > 16) {
    load_vals<TKV, N / 2>(p, out);
    load_vals<TKV, N / 2>(p + 16, out + N / 2);
  } else if constexpr (sizeof(TKV) == 1) {
    const typename Raw<kBytes>::T raw =
        *reinterpret_cast<const typename Raw<kBytes>::T*>(p);
    const unsigned* w = reinterpret_cast<const unsigned*>(&raw);
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) {
      const unsigned x = w[i] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k) out[4 * i + k] = i8_at(x, k);
    }
  } else {
    const typename Raw<kBytes>::T raw =
        *reinterpret_cast<const typename Raw<kBytes>::T*>(p);
    const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  }
}

struct Shape {
  int H, KV, D, span, n_span, vb, sz_vb;
  float scale;
};

template <typename T, typename TKV, int SZ, int DPL, typename Rows>
// (up to D 128 two blocks an SM, under 204 registers a thread, so that a
// long slot's span blocks share the SMs two at a time; above it one)
__global__ void __launch_bounds__(DPL == 8 ? kThreads : kMaxWarps * 32,
                                  DPL == 8 ? 1 : 2)
    decode_split_kernel(
    const T* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ksz,
    const float* __restrict__ vsz, const Rows rows,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part, float* __restrict__ part_ml,
    int* __restrict__ tickets, Shape s) {
  constexpr int kE = 16 / static_cast<int>(sizeof(TKV));  // per chunk
  // D > 128: 8 lanes share a key's dot product, each over the chunks
  // sub, sub + 8, ... of the row (32 of the 256 dims), and a lane owns 8
  // consecutive dims of the accumulator
  constexpr bool kWide = DPL == 8;
  constexpr int kJ = 256 / kE / 8;  // chunks a lane scores at D 256
  constexpr int kRK = sizeof(TKV) == 4 && kWide ? kBK : 2 * kBK;  // round
  constexpr int kTPR = kRK / kBK;  // tiles a round, a copy group each
  extern __shared__ __align__(16) unsigned char smem_dec[];
  __shared__ int s_last;
  const int rep = s.H / s.KV;
  const Smem lay(s.D, sizeof(TKV), rep);
  unsigned char* ring = smem_dec;
  float4* s_sz = reinterpret_cast<float4*>(smem_dec + lay.after_ring());
  long long* s_row = reinterpret_cast<long long*>(smem_dec +
                                                  lay.after_ring() + lay.sz);
  float* qs = reinterpret_cast<float*>(smem_dec + lay.after_ring() + lay.sz +
                                       lay.rows);
  float2* s_cw = reinterpret_cast<float2*>(smem_dec);  // over the ring

  const int g = blockIdx.x;
  const long long b = blockIdx.y;
  const int sp = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_thr = kWide ? kThreads : blockDim.x;  // `block_warps`
  const int n_warps = n_thr >> 5;
  const int nr = max(0, (rep - warp + n_warps - 1) / n_warps);  // warp's rows
  const int cap = rows.capacity();
  // the wide body's per-warp scores and (m, l, alpha) of its rows
  float* wp = reinterpret_cast<float*>(smem_dec + lay.total - lay.wide) +
              warp * kMaxRowsPerWarp * (kBK + 4);
  float* wml = wp + kMaxRowsPerWarp * kBK;

  // the slot's length, the table entries of the span's first two rounds
  // (as if the span had `span` keys, which it has unless the slot is
  // longer than kMaxSpans * span) and q, all in flight together; only
  // the live keys' entries are dereferenced below
  const int len = lengths[b];
  int ent = 0, ent_next = 0;  // thread tid < kRK: key tid of two rounds
  if (tid < kRK) {
    const int t0 = sp * s.span + tid;
    if (t0 < cap) ent = rows.entry(b, t0);
    if (t0 + kRK < cap) ent_next = rows.entry(b, t0 + kRK);
  }
  for (int idx = tid; idx < rep * lay.dq; idx += n_thr) {
    const int r = idx / lay.dq;
    const int d = idx - r * lay.dq;
    qs[idx] = d < s.D ? to_float(q[(b * s.H + g * rep + r) * s.D + d]) : 0.f;
  }
  const int n_keys = max(0, min(len, cap));
  const int L = span_len(n_keys, s.span);
  const int s0 = sp * L;
  if (sp > 0 && s0 >= n_keys) return;  // the span is past the length
  if (n_keys == 0) {
    // length 0: the reference's softmax over all-masked logits weighs
    // every key 1, so it writes the mean of V over the rows it reads,
    // the same for each query head of the group (span 0 alone, once)
    const int n_rows = rows.empty_rows();
    for (int d = tid; d < s.D; d += n_thr) {
      float sum = 0.f;
      for (int t = 0; t < n_rows; ++t) {
        long long pid, row;
        rows.locate(b, 0, t, pid, row);
        float vv = to_float(vp[(row * s.KV + g) * s.D + d]);
        if (SZ != kSzNone) {
          const long long o = 2 * ((SZ == kSzPage ? pid : row) * s.KV + g);
          vv = vv * vsz[o] + vsz[o + 1];
        }
        sum += vv;
      }
      const T o = from_float<T>(sum / static_cast<float>(max(n_rows, 1)));
      for (int r = 0; r < rep; ++r) out[(b * s.H + g * rep + r) * s.D + d] = o;
    }
    // its log-sum-exp weighs it 0 in a merge of key blocks
    if (lse != nullptr && tid < rep) lse[b * s.H + g * rep + tid] = kNegInf;
    return;
  }
  const int n_used = (n_keys + L - 1) / L;
  const int span_keys = min(L, n_keys - s0);
  const int n_rounds = (span_keys + kRK - 1) / kRK;
  if (L != s.span && tid < kRK) {  // a long slot's spans start elsewhere
    ent = s0 + tid < n_keys ? rows.entry(b, s0 + tid) : 0;
    ent_next = s0 + kRK + tid < n_keys ? rows.entry(b, s0 + kRK + tid) : 0;
  }

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp], acc[kMaxRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }
  if (kWide && lane < kMaxRowsPerWarp) {
    wml[3 * lane] = kNegInf;
    wml[3 * lane + 1] = 0.f;
  }

  // The span's keys in rounds of kRK through a ring of two: iteration t
  // computes round t (t >= 0), each tile as soon as its copies land, and
  // issues round t + 2 into the slot it frees. A round is issued in two
  // steps: threads tid < kRK locate key tid (its cache row, and its
  // (scale, zero) rows, per page or per token, as a cp.async of the
  // round's first group; the table entry was read a round ahead), then
  // every thread copies the K/V rows in the cache's own type, dead keys
  // zero-filled, one copy group a tile, chunks tid, tid + n_thr, ...
  // (its first (row, chunk) and the step, so the loop does not divide)
  const char* any = reinterpret_cast<const char*>(kp);  // for empty copies
  const int row_bytes = s.D * static_cast<int>(sizeof(TKV));
  const int per = lay.chunks * 16 / s.vb;  // copies per staged row
  const int dj = n_thr / per, dc = n_thr - dj * per;
  for (int t = -2; t < n_rounds; ++t) {
    if (t >= 0) {
      const int stage = t & 1;
      const unsigned char* kr = ring + stage * 2 * kRK * lay.pitch;
      const unsigned char* vr = kr + kRK * lay.pitch;
      for (int tt = 0; tt < kTPR; ++tt) {
        const int k0 = t * kRK + tt * kBK;  // the tile's first key in the span
        if (k0 >= span_keys) break;
        // the tile's group: 2 kTPR groups were committed since round t's
        // first, of which tt + 1 are round t's
        if (kTPR == 1 || tt == 1)
          cp_async_wait<kTPR>();
        else
          cp_async_wait<2 * kTPR - 1>();
        __syncthreads();  // ... landed for every thread
        const unsigned char* kst = kr + tt * kBK * lay.pitch;
        const unsigned char* vst = vr + tt * kBK * lay.pitch;
        const float4* zt = s_sz + stage * kRK + tt * kBK;
        if (nr == 0) {
          // a warp without query rows (rep < 4) has nothing to compute
        } else if constexpr (!kWide) {
          // lane j scores key j of the tile for each of its warp's rows
          // (dequantizing `q * scale + zero` in registers) and owns dims
          // lane + 32 i of the accumulator: the first design's arithmetic
          const int j = k0 + lane;  // this lane's key in the span
          const bool live = j < span_keys;
          const float4 zj =
              SZ != kSzNone ? zt[lane] : make_float4(1.f, 0.f, 1.f, 0.f);
          const unsigned char* krow = kst + lane * lay.pitch;
#pragma unroll
          for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
            const int r = rr * n_warps + warp;
            if (r >= rep) break;  // warp-uniform
            const float* qr = qs + r * lay.dq;
            float sc = 0.f;
#pragma unroll 4
            for (int c = 0; c < lay.chunks; ++c) {
              const uint4 raw = *reinterpret_cast<const uint4*>(krow + 16 * c);
              const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
              for (int i = 0; i < kE; ++i) {
                float kk = to_float(e[i]);
                if (SZ != kSzNone) kk = kk * zj.x + zj.y;
                sc += qr[c * kE + i] * kk;
              }
            }
            sc = live ? sc * s.scale : kNegInf;
            const float m_new = fmaxf(m[rr], warp_max(sc));
            const float p = live ? expf(sc - m_new) : 0.f;
            const float alpha = expf(m[rr] - m_new);
            l[rr] = l[rr] * alpha + warp_sum(p);
            m[rr] = m_new;
#pragma unroll
            for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
            for (int jj = 0; jj < kBK; ++jj) {
              const float pj = __shfl_sync(0xffffffffu, p, jj);
              const TKV* vrow =
                  reinterpret_cast<const TKV*>(vst + jj * lay.pitch);
              float vsc = 1.f, vz = 0.f;
              if (SZ != kSzNone) {
                const float4 z = zt[jj];
                vsc = z.z;
                vz = z.w;
              }
#pragma unroll
              for (int i = 0; i < DPL; ++i) {
                const int d = lane + 32 * i;
                if (d < s.D) {
                  float vv = to_float(vrow[d]);
                  if (SZ != kSzNone) vv = vv * vsc + vz;
                  acc[rr][i] += pj * vv;
                }
              }
            }
          }
        } else {
          // 8 lanes a key: lane 8 grp + sub scores key 4 st + grp of the
          // tile at step st over chunks sub + 8 i, for two of the warp's
          // rows at a time (their q slices in registers), each chunk read
          // and dequantized once for both; the partial sums reduced by
          // shuffles. The rows' scores go through shared memory to one key
          // a lane for the softmax, and their p back for P V; (m, l,
          // alpha) of each row in shared memory
          const int grp = lane >> 3, sub = lane & 7;
#pragma unroll 1
          for (int r0 = 0; r0 < nr; r0 += 2) {
            const bool two = r0 + 1 < nr;  // warp-uniform
            float qv[2][kJ * kE];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* qr = qs + ((r0 + (two ? h : 0)) * kWarps + warp) * lay.dq;
#pragma unroll
              for (int i = 0; i < kJ; ++i) {
                const int c = sub + 8 * i;
#pragma unroll
                for (int e = 0; e < kE; e += 4) {
                  const float4 q4 =
                      c < lay.chunks
                          ? *reinterpret_cast<const float4*>(qr + c * kE + e)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
                  qv[h][i * kE + e] = q4.x;
                  qv[h][i * kE + e + 1] = q4.y;
                  qv[h][i * kE + e + 2] = q4.z;
                  qv[h][i * kE + e + 3] = q4.w;
                }
              }
            }
#pragma unroll 2
            for (int st = 0; st < kBK / 4; ++st) {
              const int key = 4 * st + grp;
              const unsigned char* krow = kst + key * lay.pitch;
              const float4 zk =
                  SZ != kSzNone ? zt[key] : make_float4(1.f, 0.f, 1.f, 0.f);
              float s0 = 0.f, s1 = 0.f;
#pragma unroll
              for (int i = 0; i < kJ; ++i) {
                const int c = sub + 8 * i;
                if (c < lay.chunks) {
                  float kk[kE];
                  load_vals<TKV, kE>(krow + 16 * c, kk);
#pragma unroll
                  for (int x = 0; x < kE; ++x) {
                    if (SZ != kSzNone) kk[x] = kk[x] * zk.x + zk.y;
                    s0 += qv[0][i * kE + x] * kk[x];
                    s1 += qv[1][i * kE + x] * kk[x];
                  }
                }
              }
#pragma unroll
              for (int o = 1; o < 8; o <<= 1) {
                s0 += __shfl_xor_sync(0xffffffffu, s0, o);
                s1 += __shfl_xor_sync(0xffffffffu, s1, o);
              }
              const bool kl = k0 + key < span_keys;
              if (sub == 0) {
                wp[r0 * kBK + key] = kl ? s0 * s.scale : kNegInf;
                if (two) wp[(r0 + 1) * kBK + key] = kl ? s1 * s.scale : kNegInf;
              }
            }
            __syncwarp();
            const bool live = k0 + lane < span_keys;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int rr = r0 + h;
              if (h == 0 || two) {
                const float x = wp[rr * kBK + lane];
                const float m_old = wml[3 * rr], l_old = wml[3 * rr + 1];
                const float m_new = fmaxf(m_old, warp_max(x));
                const float p = live ? expf(x - m_new) : 0.f;
                const float alpha = expf(m_old - m_new);
                const float l_new = l_old * alpha + warp_sum(p);
                __syncwarp();  // every lane has read what lane 0 rewrites
                wp[rr * kBK + lane] = p;
                if (lane == 0) {
                  wml[3 * rr] = m_new;
                  wml[3 * rr + 1] = l_new;
                  wml[3 * rr + 2] = alpha;
                }
              }
            }
            __syncwarp();
          }
          // P V: each V row read once for the warp's rows, 8 dims a lane
          // (lanes past D read nothing)
#pragma unroll
          for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
            if (rr >= nr) break;  // warp-uniform
            const float a = wml[3 * rr + 2];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[rr][i] *= a;
          }
          const int d0 = 8 * lane;
          if (d0 < s.D) {
#pragma unroll 4
            for (int key = 0; key < kBK; ++key) {
              float vv[8];
              load_vals<TKV, 8>(vst + key * lay.pitch + d0 * sizeof(TKV), vv);
              if (SZ != kSzNone) {
                const float4 z = zt[key];
#pragma unroll
                for (int i = 0; i < 8; ++i) vv[i] = vv[i] * z.z + z.w;
              }
#pragma unroll
              for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
                if (rr >= nr) break;  // warp-uniform
                const float pj = wp[rr * kBK + key];
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[rr][i] += pj * vv[i];
              }
            }
          }
          __syncwarp();  // the tile's p read before the next tile's scores
        }
      }
    }
    const int tn = t + 2;  // the round this iteration issues
    if (tn < n_rounds) {
      const int stage = tn & 1;
      if (t >= 0) __syncthreads();  // every warp is done with round t
      if (tid < kRK) {
        const int key = tn * kRK + tid;
        const bool live = key < span_keys;
        long long pid = 0, row = 0;
        if (live) rows.locate(b, ent, s0 + key, pid, row);
        s_row[stage * kRK + tid] = row;
        if (SZ != kSzNone) {
          const long long o = 2 * ((SZ == kSzPage ? pid : row) * s.KV + g);
          float* dst = reinterpret_cast<float*>(s_sz + stage * kRK + tid);
          if (s.sz_vb == 8) {
            cp_async8(dst, live ? static_cast<const void*>(ksz + o) : any,
                      live ? 8 : 0);
            cp_async8(dst + 2, live ? static_cast<const void*>(vsz + o) : any,
                      live ? 8 : 0);
          } else {
            s_sz[stage * kRK + tid] =
                live ? make_float4(ksz[o], ksz[o + 1], vsz[o], vsz[o + 1])
                     : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        ent = ent_next;
        ent_next = key + 2 * kRK < span_keys
                       ? rows.entry(b, s0 + key + 2 * kRK) : 0;
      }
      __syncthreads();  // s_row of round tn
      unsigned char* kst = ring + stage * 2 * kRK * lay.pitch;
      unsigned char* vst = kst + kRK * lay.pitch;
      for (int h = 0; h < kTPR; ++h) {
        // a tile past the span's keys is never computed: its group is
        // committed empty (so the waits' counts hold) and copies nothing
        const int j_end = tn * kRK + h * kBK < span_keys ? (h + 1) * kBK : 0;
        for (int j = tid / per + h * kBK, c = tid % per; j < j_end;
             j += dj + (c + dc >= per),
                 c = c + dc >= per ? c + dc - per : c + dc) {
          const int off = c * s.vb;
          const char* ksrc = any;
          const char* vsrc = any;
          int n = 0;
          if (tn * kRK + j < span_keys) {
            n = max(0, min(s.vb, row_bytes - off));
            if (n) {
              const long long o = (s_row[stage * kRK + j] * s.KV + g) * s.D;
              ksrc = reinterpret_cast<const char*>(kp + o) + off;
              vsrc = reinterpret_cast<const char*>(vp + o) + off;
            }
          }
          cp_chunk(kst + j * lay.pitch + off, ksrc, n, s.vb);
          cp_chunk(vst + j * lay.pitch + off, vsrc, n, s.vb);
        }
        cp_async_commit();  // tile h of round tn
      }
    } else {
#pragma unroll
      for (int h = 0; h < kTPR; ++h) cp_async_commit();  // empty groups
    }
  }
  // no copy is left in flight when the merge's factors reuse the ring
  // (the groups of tiles past the span, never waited for above, are
  // empty); the partials' barrier orders this for every thread
  cp_async_wait<0>();
  if constexpr (kWide) {
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      m[rr] = wml[3 * rr];
      l[rr] = wml[3 * rr + 1];
    }
  }

  // the accumulator's dims of this lane: lane + 32 i, or 8 lane + i at
  // D > 128
  auto dim = [&](int i) { return kWide ? 8 * lane + i : lane + 32 * i; };
  const long long slot = b * s.KV + g;
  if (n_used == 1) {
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = rr * n_warps + warp;
      if (r >= rep) break;
      const float l_safe = fmaxf(l[rr], kMinDenom);
      if (lse != nullptr && lane == 0)
        lse[b * s.H + g * rep + r] = m[rr] + logf(l[rr]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = dim(i);
        if (d < s.D)
          out[(b * s.H + g * rep + r) * s.D + d] =
              from_float<T>(acc[rr][i] / l_safe);
      }
    }
    return;
  }

  // partials of this span: rows ((slot * n_span + sp) * rep + r)
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int r = rr * n_warps + warp;
    if (r >= rep) break;
    const long long prow = (slot * s.n_span + sp) * rep + r;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = dim(i);
      if (d < s.D) part[prow * s.D + d] = acc[rr][i];
    }
    if (lane == 0)
      *reinterpret_cast<float2*>(part_ml + prow * 2) = make_float2(m[rr], l[rr]);
  }
  // the block's partials, then one thread's ticket with release and
  // acquire at gpu scope (the barrier orders the other threads' writes
  // before it and the merge's reads after it)
  __syncthreads();
  if (tid == 0) {
    int t;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
                 : "=r"(t) : "l"(tickets + slot), "r"(1) : "memory");
    s_last = t == n_used - 1;
    if (s_last) tickets[slot] = 0;  // every used span has taken its ticket
  }
  __syncthreads();
  if (!s_last) return;

  // the last span block merges the used spans' partials in span order,
  // online: o = sum_u e^(m_u - M) acc_u / max(sum_u e^(m_u - M) l_u,
  // 1e-30) with the running max M, the same arithmetic whichever way its
  // loads go
  const long long p0 = slot * s.n_span * rep;
  if (n_used <= kMergeDirect) {
    // few spans: each element loads every span's (m, l, acc) at once
    for (int idx = tid; idx < rep * s.D; idx += n_thr) {
      const int r = idx / s.D;
      const int d = idx - r * s.D;
      float mu[kMergeDirect], lu[kMergeDirect], au[kMergeDirect];
#pragma unroll
      for (int j = 0; j < kMergeDirect; ++j) {
        const long long pr = p0 + min(j, n_used - 1) * rep + r;
        mu[j] = __ldcg(part_ml + pr * 2);
        lu[j] = __ldcg(part_ml + pr * 2 + 1);
        au[j] = __ldcg(part + pr * s.D + d);
      }
      float M = kNegInf, Lsum = 0.f, o = 0.f;
#pragma unroll
      for (int j = 0; j < kMergeDirect; ++j) {
        if (j >= n_used) break;
        const float m_new = fmaxf(M, mu[j]);
        const float c = expf(M - m_new);
        const float w = expf(mu[j] - m_new);
        Lsum = Lsum * c + w * lu[j];
        o = o * c + w * au[j];
        M = m_new;
      }
      out[(b * s.H + g * rep + r) * s.D + d] =
          from_float<T>(o / fmaxf(Lsum, kMinDenom));
      if (lse != nullptr && d == 0) lse[b * s.H + g * rep + r] = M + logf(Lsum);
    }
    return;
  }
  // many spans: a row's factors are the same for every dim, so (m, l) of
  // each (row, span) are staged in shared memory, one thread a row runs
  // the running max and sum over them and keeps each span's (rescale,
  // weight), then every output element sums its spans' partials with
  // those factors, the loads of all its elements in flight together
  for (int idx = tid; idx < rep * n_used; idx += n_thr) {
    const int u = idx / rep;
    const int r = idx - u * rep;
    s_cw[r * kMaxSpans + u] =
        __ldcg(reinterpret_cast<const float2*>(part_ml) + p0 + idx);
  }
  __syncthreads();
  float2* s_ml = s_cw + rep * kMaxSpans;
  if (tid < rep) {
    float M = kNegInf, Lsum = 0.f;
    for (int u = 0; u < n_used; ++u) {
      const float2 ml = s_cw[tid * kMaxSpans + u];
      const float m_new = fmaxf(M, ml.x);
      const float c = expf(M - m_new);
      const float w = expf(ml.x - m_new);
      Lsum = Lsum * c + w * ml.y;
      M = m_new;
      s_cw[tid * kMaxSpans + u] = make_float2(c, w);
    }
    s_ml[tid] = make_float2(M, Lsum);
  }
  __syncthreads();
  const int n_el = rep * s.D;
  const float* pb = part + p0 * s.D;
  for (int e0 = tid; e0 < n_el; e0 += n_thr * kMergeElems) {
    float o[kMergeElems];
    int cr[kMergeElems];
#pragma unroll
    for (int i = 0; i < kMergeElems; ++i) {
      const int e = e0 + i * n_thr;
      o[i] = 0.f;
      cr[i] = e < n_el ? e / s.D * kMaxSpans : 0;
    }
#pragma unroll 2  // 8 spans deep spilled under the 5-warp register cap
    for (int u = 0; u < n_used; ++u) {
      const float* pu = pb + static_cast<long long>(u) * n_el;
#pragma unroll
      for (int i = 0; i < kMergeElems; ++i) {
        const int e = e0 + i * n_thr;
        if (e < n_el) {
          const float2 cw = s_cw[cr[i] + u];
          o[i] = o[i] * cw.x + cw.y * __ldcg(pu + e);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMergeElems; ++i) {
      const int e = e0 + i * n_thr;
      if (e < n_el) {
        const int r = e / s.D;
        const int d = e - r * s.D;
        const float2 ML = s_ml[r];
        out[(b * s.H + g * rep + r) * s.D + d] =
            from_float<T>(o[i] / fmaxf(ML.y, kMinDenom));
        if (lse != nullptr && d == 0)
          lse[b * s.H + g * rep + r] = ML.x + logf(ML.y);
      }
    }
  }
}

template <typename Rows>
struct Args {
  const void *q, *kp, *vp, *ksz, *vsz, *lengths;
  void* out;
  void *part, *part_ml, *tickets;
  int B, smem;
  Shape s;
  Rows rows;
  cudaStream_t stream;
  void* lse = nullptr;  // (B, H) float32 log-sum-exp, or none
};

template <typename T, typename TKV, int SZ, int DPL, typename Rows>
int launch(const Args<Rows>& a) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const Shape& s = a.s;
  if (s.span < kBK || s.span % kBK || s.n_span < 1 ||
      s.n_span > kMaxSpans ||
      (s.vb != 16 && s.vb != 4 && s.vb != 1) ||
      (s.sz_vb != 8 && s.sz_vb != 1))
    return bad;
  const Smem lay(s.D, sizeof(TKV), s.H / s.KV);
  if (lay.total != a.smem) return bad;
  auto kernel = decode_split_kernel<T, TKV, SZ, DPL, Rows>;
  cudaError_t err = allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(s.KV, a.B, s.n_span);
  kernel<<<grid, 32 * block_warps(s.D, s.H / s.KV), lay.total, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const float*>(a.ksz),
      static_cast<const float*>(a.vsz), a.rows,
      static_cast<const int*>(a.lengths), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), static_cast<float*>(a.part), static_cast<float*>(a.part_ml),
      static_cast<int*>(a.tickets), s);
  return static_cast<int>(cudaGetLastError());
}

// instantiate over the accumulator width each lane owns (ceil(D/32))
template <typename T, typename TKV, int SZ, typename Rows>
int launch_d(const Args<Rows>& a) {
  switch (lane_width(a.s.D)) {
    case 1: return launch<T, TKV, SZ, 1>(a);
    case 2: return launch<T, TKV, SZ, 2>(a);
    case 4: return launch<T, TKV, SZ, 4>(a);
    case 8: return launch<T, TKV, SZ, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace decode
}  // namespace repro
