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
// Design: the slot's key range is split into spans of `span` positions
// (64 by default; the launch plan, `kernels/decode_attention/paged.py`
// `decode_plan`), one block per (KV head, slot, span), grid (KV, B,
// n_span) with n_span from the capacity, so the host never reads the
// lengths. The span length depends on neither the row policy nor the
// capacity: paged and contiguous caches partition [0, length) the same
// way, and a paged fp engine stays bit-exact with a contiguous one.
// - A block first reads the slot's length, its span's block-table
//   entries (in parallel with the length: an entry at or past the length
//   is read but never dereferenced, so the table needs no clamp) and q,
//   which it stages as f32. A span past the length exits at once;
//   the key range is bounded by min(length, capacity), so a parked slot
//   reads its whole cache and never past it.
// - Then one round of copies: the span's (scale, zero) rows (8-byte
//   cp.async) and its K/V rows (16-byte cp.async where rows allow, else 4,
//   else synchronous bytes), all in flight together, in the cache's own
//   type, at a row pitch of an odd number of 16-byte chunks so that 32
//   lanes reading 32 rows 16 bytes at a time hit every bank once.
// - Per 32-key tile a warp runs the first design's arithmetic for each of
//   its query rows (lane j scores key j, dequantizing `q * scale + zero` in
//   registers; each lane owns ceil(D/32) head-dim values of the
//   accumulator), with the reference's -1e30 mask and the denominator
//   clamped at 1e-30: a slot whose keys fit in one span gets the first
//   design's sums exactly.
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
//   / max(sum_u e^(m_u - M) l_u, 1e-30) with the running max M.
// - On request (`lse` not null) each (row, query head) also writes its
//   float32 log-sum-exp m + log(l) over the scaled logits, M + log(L)
//   after a merge, and -1e30 for a slot of length 0, so that a caller can
//   merge the outputs of disjoint key blocks (the sequence-sharded decode
//   over a mesh) with weights e^(lse - max lse), a length-0 block's
//   exactly 0. The output is the same with or without it.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace repro {
namespace decode {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRowsPerWarp = 4;  // rep = H / KV <= 16
constexpr int kBK = 32;             // keys per tile: one per lane
constexpr int kMaxKeysPerThread = 2;  // span <= 2 * kThreads

enum SzMode : int { kSzNone = 0, kSzPage = 1, kSzToken = 2 };

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
  int stage, sz, rows, q, total;
  __host__ __device__ Smem(int span, int D, int esize, int rep) {
    chunks = (D * esize + 15) / 16;
    pitch = 16 * (chunks | 1);
    dq = chunks * (16 / esize);
    stage = 2 * span * pitch;  // [k, v][span] rows
    sz = span * 16;            // [span] (k scale, k zero, v scale, v zero)
    rows = span * 8;           // [span] cache row of each key
    q = rep * dq * 4;          // [rep][dq] f32
    total = stage + sz + rows + q;
  }
};

struct Shape {
  int H, KV, D, span, n_span, vb, sz_vb;
  float scale;
};

template <typename T, typename TKV, int SZ, int DPL, typename Rows>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const float* __restrict__ ksz,
    const float* __restrict__ vsz, const Rows rows,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ part, float* __restrict__ part_ml,
    int* __restrict__ tickets, Shape s) {
  constexpr int kE = 16 / static_cast<int>(sizeof(TKV));  // per chunk
  extern __shared__ __align__(16) unsigned char smem_dec[];
  __shared__ int s_last;
  const int rep = s.H / s.KV;
  const Smem lay(s.span, s.D, sizeof(TKV), rep);
  unsigned char* kst = smem_dec;
  unsigned char* vst = kst + s.span * lay.pitch;
  float4* s_sz = reinterpret_cast<float4*>(smem_dec + lay.stage);
  long long* s_row = reinterpret_cast<long long*>(smem_dec + lay.stage +
                                                  lay.sz);
  float* qs = reinterpret_cast<float*>(smem_dec + lay.stage + lay.sz +
                                       lay.rows);

  const int g = blockIdx.x;
  const long long b = blockIdx.y;
  const int sp = blockIdx.z;
  const int s0 = sp * s.span;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cap = rows.capacity();

  // the slot's length, the span's table entries and q, all in flight
  // together; only the live keys' entries are dereferenced below
  const int len = lengths[b];
  int ent[kMaxKeysPerThread];
#pragma unroll
  for (int u = 0; u < kMaxKeysPerThread; ++u) {
    const int j = tid + u * kThreads;
    ent[u] = j < s.span && s0 + j < cap ? rows.entry(b, s0 + j) : 0;
  }
  for (int idx = tid; idx < rep * lay.dq; idx += kThreads) {
    const int r = idx / lay.dq;
    const int d = idx - r * lay.dq;
    qs[idx] = d < s.D ? to_float(q[(b * s.H + g * rep + r) * s.D + d]) : 0.f;
  }
  const int n_keys = max(0, min(len, cap));
  if (sp > 0 && s0 >= n_keys) return;  // the span is past the length
  if (n_keys == 0) {
    // length 0: the reference's softmax over all-masked logits weighs
    // every key 1, so it writes the mean of V over the rows it reads,
    // the same for each query head of the group (span 0 alone, once)
    const int n_rows = rows.empty_rows();
    for (int d = tid; d < s.D; d += kThreads) {
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
  const int n_used = max(1, (n_keys + s.span - 1) / s.span);
  const int span_keys = max(0, min(s.span, n_keys - s0));

  // one round of copies: the live keys' (scale, zero) rows, per page or
  // per token, and their K/V rows; dead keys are zero-filled
  const char* any = reinterpret_cast<const char*>(kp);  // for empty copies
#pragma unroll
  for (int u = 0; u < kMaxKeysPerThread; ++u) {
    const int j = tid + u * kThreads;
    if (j >= s.span) break;
    const bool live = j < span_keys;
    long long pid = 0, row = 0;
    if (live) rows.locate(b, ent[u], s0 + j, pid, row);
    s_row[j] = row;
    if (SZ != kSzNone) {
      const long long o = 2 * ((SZ == kSzPage ? pid : row) * s.KV + g);
      float* dst = reinterpret_cast<float*>(s_sz + j);
      if (s.sz_vb == 8) {
        cp_async8(dst, live ? static_cast<const void*>(ksz + o) : any,
                  live ? 8 : 0);
        cp_async8(dst + 2, live ? static_cast<const void*>(vsz + o) : any,
                  live ? 8 : 0);
      } else {
        s_sz[j] = live ? make_float4(ksz[o], ksz[o + 1], vsz[o], vsz[o + 1])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  __syncthreads();  // s_row is written
  const int row_bytes = s.D * static_cast<int>(sizeof(TKV));
  const int per = lay.chunks * 16 / s.vb;  // copies per staged row
  // a thread's copies are chunks tid, tid + kThreads, ...: its first
  // (row, chunk) and the step, so the loop does not divide
  const int dj = kThreads / per, dc = kThreads - dj * per;
  for (int j = tid / per, c = tid % per; j < s.span;
       j += dj + (c + dc >= per), c = c + dc >= per ? c + dc - per : c + dc) {
    const int off = c * s.vb;
    const char* ksrc = any;
    const char* vsrc = any;
    int n = 0;
    if (j < span_keys) {
      n = max(0, min(s.vb, row_bytes - off));
      if (n) {
        const long long o = (s_row[j] * s.KV + g) * s.D;
        ksrc = reinterpret_cast<const char*>(kp + o) + off;
        vsrc = reinterpret_cast<const char*>(vp + o) + off;
      }
    }
    cp_chunk(kst + j * lay.pitch + off, ksrc, n, s.vb);
    cp_chunk(vst + j * lay.pitch + off, vsrc, n, s.vb);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp], acc[kMaxRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  for (int k0 = 0; k0 < span_keys; k0 += kBK) {
    const int j = k0 + lane;  // this lane's key in the span
    const bool live = j < span_keys;
    const float4 zj = SZ != kSzNone ? s_sz[j] : make_float4(1.f, 0.f, 1.f, 0.f);
    const unsigned char* krow = kst + j * lay.pitch;
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;
      if (r >= rep) break;  // warp-uniform
      const float* qr = qs + r * lay.dq;
      float sc = 0.f;
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
      for (int jj = 0; jj < kBK; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        const TKV* vrow =
            reinterpret_cast<const TKV*>(vst + (k0 + jj) * lay.pitch);
        float vsc = 1.f, vz = 0.f;
        if (SZ != kSzNone) {
          const float4 z = s_sz[k0 + jj];
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
  }

  const long long slot = b * s.KV + g;
  if (n_used == 1) {
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;
      if (r >= rep) break;
      const float l_safe = fmaxf(l[rr], kMinDenom);
      if (lse != nullptr && lane == 0)
        lse[b * s.H + g * rep + r] = m[rr] + logf(l[rr]);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
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
    const int r = rr * kWarps + warp;
    if (r >= rep) break;
    const long long prow = (slot * s.n_span + sp) * rep + r;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
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
  // online (the running max rescales what is summed so far), the loads of
  // four spans in flight together
  for (int idx = tid; idx < rep * s.D; idx += kThreads) {
    const int r = idx / s.D;
    const int d = idx - r * s.D;
    const long long p0 = slot * s.n_span * rep + r;
    float M = kNegInf, L = 0.f, o = 0.f;
    for (int u0 = 0; u0 < n_used; u0 += 4) {
      float mu[4], lu[4], au[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long pr = p0 + min(u0 + j, n_used - 1) * rep;
        mu[j] = __ldcg(part_ml + pr * 2);
        lu[j] = __ldcg(part_ml + pr * 2 + 1);
        au[j] = __ldcg(part + pr * s.D + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (u0 + j >= n_used) break;
        const float m_new = fmaxf(M, mu[j]);
        const float c = expf(M - m_new);
        const float w = expf(mu[j] - m_new);
        L = L * c + w * lu[j];
        o = o * c + w * au[j];
        M = m_new;
      }
    }
    out[(b * s.H + g * rep + r) * s.D + d] =
        from_float<T>(o / fmaxf(L, kMinDenom));
    if (lse != nullptr && d == 0) lse[b * s.H + g * rep + r] = M + logf(L);
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
  if (s.span < kBK || s.span % kBK || s.span > kMaxKeysPerThread * kThreads ||
      s.n_span < 1 ||
      (s.vb != 16 && s.vb != 4 && s.vb != 1) ||
      (s.sz_vb != 8 && s.sz_vb != 1))
    return bad;
  const Smem lay(s.span, s.D, sizeof(TKV), s.H / s.KV);
  if (lay.total != a.smem) return bad;
  auto kernel = decode_split_kernel<T, TKV, SZ, DPL, Rows>;
  cudaError_t err = allow_smem(kernel, lay.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(s.KV, a.B, s.n_span);
  kernel<<<grid, kThreads, lay.total, a.stream>>>(
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
