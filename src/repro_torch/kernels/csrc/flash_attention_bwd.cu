// Dense GQA flash-attention backward (training).
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py
// `_flash_bwd` (the custom_vjp of `flash_mha`), which runs
// `chunked._bwd_inner`: P recomputed from the forward's saved logsumexp,
// dq in a pass over query tiles, dk/dv in a pass over key tiles. The
// plain version here is `kernels/flash_attention/chunked.py` `_bwd_inner`.
//
// Inputs q (B,Sq,H,D), k/v (B,Skv,KV,D), out and dout (B,Sq,H,D) in one
// dtype (float32 or bfloat16), lse (B,H,Sq) float32 as `flash_mha`'s
// forward writes it; grads dq, dk, dv in the input dtype, every sum in
// float32.
//
// Bound: per unmasked (query, key) pair the backward does 10 * D
// operations (S = QK^T and dP = dO V again, dq, dk, dv), against q, k, v,
// out, dout read once and dq, dk, dv written once. At smollm-360m's train
// shape (bf16, B 8, S 256, 15 / 5 heads, D 64: 2.5e9 operations, 21 MB)
// the data sheet's bound is the bytes, 6.3 us, with the operations at
// the bf16 tensor-core rate 2.6 us; at S 1024 the operations.
//
// Both dtypes: no atomics, every output element written by one thread in
// a fixed order (the warps that share an output merge in a fixed order),
// so two calls give the same bits.
//
// bf16 (the training path): two kernels on the tensor cores, P and dS
// recomputed in each, as `chunked._bwd_inner` does (seven products where
// FlashAttention-2 has five, since its dq atomics are gone).
// - Rows are (query position, head of the KV group) pairs, row = qi * rep
//   + head, as in the forward (`csrc/flash_attention.cu`): one staged K/V
//   tile serves every head of the group, and in the dk/dv pass the sum
//   over the group's heads is part of dS^T Q's and P^T dO's k dimension.
//   The grid goes over (batch row, KV head) x tiles, the tiles with the
//   most causal work first.
// - `flash_bwd_dq_mma_kernel`: 64 rows a block (4 warps of 16 rows).
//   It stages q, dO and O, sums delta = rowsum(dO * O) per row (writing it
//   and the row's lse in the row layout for the other pass), then walks
//   the 64-key tiles up to its causal frontier: S = Q K^T and dP = dO V^T
//   (mma.sync m16n8k16 bf16 -> f32, ldmatrix), P = exp(S scale - lse),
//   dS = P (dP - delta) scale, dq += dS K with dS as a bf16 hi + lo pair.
// - `flash_bwd_dkv_mma_kernel`: 16 keys a block in 4 row groups (above
//   D 128, 2 row groups of 2 column groups, which split dk/dv's columns):
//   each warp takes every 4th (2nd) 16-row chunk of the 64-row tiles from
//   the first that sees its first key: S^T =
//   K Q^T, dP^T = V dO^T, then dv += P^T dO and dk += dS^T Q with P^T and
//   dS^T as hi + lo pairs; the row groups merge in order at the end.
// - P and dS enter products as bf16 hi + lo pairs (about 16 bits), as the
//   reference computes these products in float32. q/k/v/dO are bf16
//   already; every accumulator is float32.
// - Copies: a double-buffered cp.async ring (16 bytes a copy where the
//   rows allow), each thread stepping its own chunk column's pointers;
//   rows past the ends and the padding columns zero-filled.
// - D is padded to a multiple of 16 with zeros (any D <= 256).
// - Measured (`chip_smoke.py`, NVIDIA H100 80GB HBM3, 700 W): 0.069 ms
//   at the train shape (dq 0.022, dk/dv 0.040), 16x the FMA body's
//   1.084, 1.6x SDPA's backward (0.042); a bf16 smollm-360m step spends
//   2.1-2.3 ms in it instead of 34.6. `scripts/kernel_phases.py`:
//   the heaviest causal dk/dv block walks 12 row tiles at about 3 us
//   each, a chunk's products and softmax a nearly serial chain of some
//   440 instructions; neither 8-warp blocks (fewer staged bytes), TMA
//   bulk copies, nor other rows and keys per block (32 or 16 rows a dq
//   block, 32 or 64 keys a dk/dv block) moved it (PERF.md).
//
// float32 (the sweep's 1e-4 gate and the float32 training run's 1e-3 /
// 1e-4, which bf16 products cannot meet): the first design, kept as it
// was, on the FMA units out of shared memory (about 1.1 ms at the shape
// above in float32's bytes):
// - `flash_bwd_delta_kernel`: delta = rowsum(dO * O) per (b, h, query),
//   one warp per row, into a float32 scratch (B, H, Sq).
// - `flash_bwd_dq_kernel`: one block per (16 query rows, query head,
//   batch row), 4 warps of 4 rows; K/V tiles of 32 keys staged as float32
//   in shared memory (odd row pitch: the 32 lanes' rows hit 32 banks);
//   lane j takes key j: s, p = exp(s - lse), dp = dO . v_j, ds = p (dp -
//   delta) scale; dq += ds K through shuffles, each lane owning
//   ceil(D / 32) head-dim columns. Causal tiles past the block's last
//   query (with kv_offset) are never loaded.
// - `flash_bwd_dkv_kernel`: one block per (32 keys, KV head, batch row)
//   with its K/V rows staged once; it walks the R = H / KV query heads of
//   its group and their 16-row query tiles (causal: from the first query
//   that sees its first key), computes the tile's p and ds (lane = key),
//   then dv += P^T dO and dk += dS^T Q into float32 accumulators in shared
//   memory, each thread owning fixed (key, column) entries.
// D is any value up to 256 (the loops run to D; the shuffled dq columns
// mask d >= D); S need not be a multiple of a tile.

#include <climits>

#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------- float32: FMA body
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per tile
constexpr int kBK = 32;                     // keys per tile: one per lane
constexpr int kPP = kBK + 1;                // p / ds tile row pitch

template <typename T>
__device__ __forceinline__ float ld(const T* p, long long i) {
  return repro::to_float(p[i]);
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s += a[d] * b[d];
  return s;
}

// delta[(b * H + h) * Sq + qi] = sum_d dout * out, one warp per row
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ out,
                           const T* __restrict__ dout,
                           float* __restrict__ delta, long long rows, int Sq,
                           int H, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += ld(dout, row * D + d) * ld(out, row * D + d);
  s = repro::warp_sum(s);
  if (lane == 0) {
    // row = (b * Sq + qi) * H + h
    const long long b = row / (static_cast<long long>(Sq) * H);
    const int rem = static_cast<int>(row - b * Sq * H);
    const int qi = rem / H;
    delta[(b * H + (rem - qi * H)) * Sq + qi] = s;
  }
}

// rows [q0, q0 + kBQ) of query head h: q and dout rows into shared memory
// as float32 (zero past Sq)
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ q,
                                           const T* __restrict__ dout,
                                           float* qs, float* dos, long long b,
                                           int h, int q0, int Sq, int H,
                                           int D) {
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int qi = q0 + r;
    float a = 0.f, c = 0.f;
    if (qi < Sq) {
      const long long o = ((b * Sq + qi) * H + h) * D + d;
      a = ld(q, o);
      c = ld(dout, o);
    }
    qs[idx] = a;
    dos[idx] = c;
  }
}

// keys [k0, k0 + kBK) of KV head g into shared memory as float32 at row
// pitch Dp (zero past Skv)
template <typename T>
__device__ __forceinline__ void stage_keys(const T* __restrict__ k,
                                           const T* __restrict__ v, float* ks,
                                           float* vs, long long b, int g,
                                           int k0, int Skv, int KV, int D,
                                           int Dp) {
  for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
    const int j = idx / D;
    const int d = idx - j * D;
    const int kj = k0 + j;
    float a = 0.f, c = 0.f;
    if (kj < Skv) {
      const long long o = ((b * Skv + kj) * KV + g) * D + d;
      a = ld(k, o);
      c = ld(v, o);
    }
    ks[j * Dp + d] = a;
    vs[j * Dp + d] = c;
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Skv, int H, int KV, int D, float scale,
                        int causal, int kv_offset) {
  extern __shared__ float smem[];
  const int Dp = repro::odd_pitch(D);
  float* qs = smem;            // [kBQ][D]
  float* dos = qs + kBQ * D;   // [kBQ][D]
  float* ks = dos + kBQ * D;   // [kBK][Dp]
  float* vs = ks + kBK * Dp;   // [kBK][Dp]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int g = h / (H / KV);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  stage_rows(q, dout, qs, dos, b, h, q0, Sq, H, D);
  float lse_r[kRowsPerWarp], del_r[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    const long long o = (b * H + h) * Sq + qi;
    lse_r[rr] = qi < Sq ? lse[o] : 0.f;
    del_r[rr] = qi < Sq ? delta[o] : 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end =
      causal ? max(0, min(Skv, kv_offset + q_last + 1)) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    stage_keys(k, v, ks, vs, b, g, k0, Skv, KV, D, Dp);
    __syncthreads();
    const int kj = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      if (qi >= Sq) break;  // warp-uniform
      float ds = 0.f;
      if (kj < k_end && (!causal || kj <= kv_offset + qi)) {
        const float s = dot(qs + r * D, ks + lane * Dp, D) * scale;
        const float dp = dot(dos + r * D, vs + lane * Dp, D);
        const float p = expf(s - lse_r[rr]);
        ds = p * (dp - del_r[rr]) * scale;
      }
      for (int jj = 0; jj < kBK; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] += dsj * ks[jj * Dp + d];
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi >= Sq) break;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D)
        dq[((b * Sq + qi) * H + h) * D + d] = repro::from_float<T>(acc[rr][i]);
    }
  }
}

// shared-memory floats of the dk/dv kernel: staged K/V (pitch Dp), one
// query tile's q and dout rows, its p and ds tiles, lse and delta rows,
// and the dk / dv accumulators
__host__ __device__ inline int dkv_smem_floats(int D) {
  return 2 * kBK * repro::odd_pitch(D) + 2 * kBQ * D + 2 * kBQ * kPP +
         2 * kBQ + 2 * kBK * D;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                         int D, float scale, int causal, int kv_offset) {
  extern __shared__ float smem[];
  const int Dp = repro::odd_pitch(D);
  float* ks = smem;               // [kBK][Dp]
  float* vs = ks + kBK * Dp;      // [kBK][Dp]
  float* qs = vs + kBK * Dp;      // [kBQ][D]
  float* dos = qs + kBQ * D;      // [kBQ][D]
  float* ps = dos + kBQ * D;      // [kBQ][kPP]
  float* dss = ps + kBQ * kPP;    // [kBQ][kPP]
  float* lse_s = dss + kBQ * kPP;  // [kBQ]
  float* del_s = lse_s + kBQ;     // [kBQ]
  float* dka = del_s + kBQ;       // [kBK][D]
  float* dva = dka + kBK * D;     // [kBK][D]

  const int k0 = blockIdx.x * kBK;
  const int g = blockIdx.y;
  const long long b = blockIdx.z;
  const int rep = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  stage_keys(k, v, ks, vs, b, g, k0, Skv, KV, D, Dp);
  for (int e = tid; e < kBK * D; e += kThreads) dka[e] = dva[e] = 0.f;
  // the first query tile holding a query that sees key k0
  const int q_start =
      causal ? max(0, k0 - kv_offset) / kBQ * kBQ : 0;
  const int kj = k0 + lane;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    for (int q0 = q_start; q0 < Sq; q0 += kBQ) {
      __syncthreads();  // the previous query tile is consumed
      stage_rows(q, dout, qs, dos, b, h, q0, Sq, H, D);
      if (tid < kBQ) {
        const int qi = q0 + tid;
        const long long o = (b * H + h) * Sq + qi;
        lse_s[tid] = qi < Sq ? lse[o] : 0.f;
        del_s[tid] = qi < Sq ? delta[o] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        const int qi = q0 + r;
        float p = 0.f, ds = 0.f;
        if (qi < Sq && kj < Skv && (!causal || kj <= kv_offset + qi)) {
          const float s = dot(qs + r * D, ks + lane * Dp, D) * scale;
          const float dp = dot(dos + r * D, vs + lane * Dp, D);
          p = expf(s - lse_s[r]);
          ds = p * (dp - del_s[r]) * scale;
        }
        ps[r * kPP + lane] = p;
        dss[r * kPP + lane] = ds;
      }
      __syncthreads();
      // dv[j][d] += sum_r p[r][j] dout[r][d]; dk[j][d] += sum_r ds[r][j] q[r][d]
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int j = e / D;
        const int d = e - j * D;
        float a = dva[e], c = dka[e];
#pragma unroll 4
        for (int r = 0; r < kBQ; ++r) {
          a += ps[r * kPP + j] * dos[r * D + d];
          c += dss[r * kPP + j] * qs[r * D + d];
        }
        dva[e] = a;
        dka[e] = c;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < kBK * D; e += kThreads) {
    const int j = e / D;
    const int d = e - j * D;
    if (k0 + j < Skv) {
      const long long o = ((b * Skv + k0 + j) * KV + g) * D + d;
      dk[o] = repro::from_float<T>(dka[e]);
      dv[o] = repro::from_float<T>(dva[e]);
    }
  }
}

// ------------------------------------------- bf16: tensor-core body
constexpr int kMmaThreads = 128;  // 4 warps a block in both passes
constexpr int kKeyTile = 64;      // dq pass: keys per staged K/V tile
constexpr int kRowTile = 64;      // dk/dv pass: rows per staged q/dO tile
constexpr int kDqRows = 64;       // dq pass: rows a block, 16 a warp
constexpr int kDkvKeys = 16;      // dk/dv pass: keys a block

// Shared-memory bytes of the two tensor-core passes; every region starts
// 16-byte aligned. `bwd_plan` in Python mirrors it. The dk/dv pass's row
// groups merge at the end through the (then free) tile ring, one group
// at a time, which it always holds.
struct MmaSmem {
  int dq, dkv;
  __host__ __device__ explicit MmaSmem(int D) {
    const int qp = 2 * (((D + 15) & ~15) + 8);  // bf16 row pitch, bytes
    // q and dO rows, then [2 tiles][k, v][kKeyTile] rows
    dq = 2 * kDqRows * qp + 2 * 2 * kKeyTile * qp;
    // k and v rows, then [2 tiles][q, dO][kRowTile] rows, then
    // [2 tiles][lse, delta][kRowTile] floats
    dkv = 2 * kDkvKeys * qp + 2 * 2 * kRowTile * qp + 2 * 2 * kRowTile * 4;
  }
};

struct MmaShape {
  int Sq, Skv, H, KV, D;
  int vb, causal, kv_offset;
  int rows_p;           // a KV head's rows in ml_rows, Sq * rep to 64
  float scale;
};

// A thread's share of staging a tile's rows into shared memory (bf16 row
// pitch qp elements, zero-padded to dp columns), per = 2 dp / vb copies of
// vb bytes a row. Where per divides the block's 128 threads (`fast`), a
// thread copies chunk tid % per (nb of its vb bytes inside the row's
// 2 D) of rows tid / per, tid / per + 128 / per, ..., stepping its
// pointers; otherwise chunks tid, tid + 128, ... of the tile, each row
// found anew.
struct Share {
  int per, c_off, nb, j0, dj, vb, D;
  bool fast;
  __device__ Share(int dp, int D_, int vb_) : vb(vb_), D(D_) {
    per = 2 * dp / vb;
    fast = kMmaThreads % per == 0;
    c_off = (threadIdx.x % per) * vb;
    nb = max(0, min(vb, 2 * D - c_off));
    j0 = threadIdx.x / per;
    dj = kMmaThreads / per;
  }
};

// rows j < n of a tile into dst: row j is src(j), or zeros where src(j)
// is null (the general path)
template <typename Src>
__device__ __forceinline__ void stage_any(__nv_bfloat16* dst, int n, int qp,
                                          const Share& sh, const void* any,
                                          Src src) {
  for (int idx = threadIdx.x; idx < n * sh.per; idx += kMmaThreads) {
    const int j = idx / sh.per;
    const int off = (idx - j * sh.per) * sh.vb;
    const __nv_bfloat16* row = src(j);
    const char* from = static_cast<const char*>(any);
    int nb = 0;
    if (row != nullptr) {
      nb = max(0, min(sh.vb, 2 * sh.D - off));
      if (nb) from = reinterpret_cast<const char*>(row) + off;
    }
    repro::cp_chunk(reinterpret_cast<char*>(dst + j * qp) + off, from, nb,
                    sh.vb);
  }
}

// keys k0 + j (j < n) of one KV head into dst: key `key` at
// base + key * stride elements, zeros from key k_end on
__device__ __forceinline__ void stage_keys(__nv_bfloat16* dst, int n, int qp,
                                           const Share& sh,
                                           const __nv_bfloat16* base,
                                           long long stride, int k0,
                                           int k_end, const void* any) {
  if (!sh.fast) {
    stage_any(dst, n, qp, sh, any, [&](int j) -> const __nv_bfloat16* {
      return k0 + j < k_end ? base + (k0 + j) * stride : nullptr;
    });
    return;
  }
  char* d = reinterpret_cast<char*>(dst + sh.j0 * qp) + sh.c_off;
  const char* src =
      reinterpret_cast<const char*>(base + (k0 + sh.j0) * stride) + sh.c_off;
  const long long step = 2 * stride * sh.dj;  // bytes
  for (int j = sh.j0; j < n; j += sh.dj) {
    const bool ok = k0 + j < k_end;
    repro::cp_chunk(d, ok ? src : static_cast<const char*>(any),
                    ok ? sh.nb : 0, sh.vb);
    d += 2 * qp * sh.dj;
    src += step;
  }
}

// rows row0 + j (j < n) of a KV head's Sq * rep rows (row = query
// position qi * rep + head hh of the group) into dst: row (qi, hh) at
// base + (qi * H + hh) * D elements, base the group's first head at query
// 0; zeros from row n_rows on
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int n, int qp,
                                           const Share& sh,
                                           const __nv_bfloat16* base,
                                           int row0, int n_rows, int rep,
                                           int H, const void* any) {
  if (!sh.fast) {
    stage_any(dst, n, qp, sh, any, [&](int j) -> const __nv_bfloat16* {
      const int row = row0 + j;
      if (row >= n_rows) return nullptr;
      const int qi = row / rep;
      return base + (static_cast<long long>(qi) * H + row - qi * rep) * sh.D;
    });
    return;
  }
  int row = row0 + sh.j0;
  int qi = row / rep;
  int hh = row - qi * rep;
  const int step_q = sh.dj / rep;
  const int step_h = sh.dj - step_q * rep;
  char* d = reinterpret_cast<char*>(dst + sh.j0 * qp) + sh.c_off;
  for (int j = sh.j0; j < n; j += sh.dj) {
    const bool ok = row < n_rows;
    const char* src =
        ok ? reinterpret_cast<const char*>(
                 base + (static_cast<long long>(qi) * H + hh) * sh.D) +
                 sh.c_off
           : static_cast<const char*>(any);
    repro::cp_chunk(d, src, ok ? sh.nb : 0, sh.vb);
    d += 2 * qp * sh.dj;
    row += sh.dj;
    qi += step_q;
    hh += step_h;
    if (hh >= rep) {
      hh -= rep;
      ++qi;
    }
  }
}

// dq pass (and delta). Block (x, y): batch row x / KV, KV head x % KV,
// and the kDqRows rows of row tile gridDim.y - 1 - y of the group's
// Sq * rep rows (row = query position * rep + head of the group; the last
// tiles, which see the most keys under the causal mask, start first). Its
// 4 warps take 16 rows each. A warp first sums delta = rowsum(dO * O) of
// its rows (and writes it, and the row's lse, in the row layout for the
// dk/dv pass), then walks the 64-key tiles up to the block's causal
// frontier in 32-key halves: S = Q K^T and dP = dO V^T on the tensor
// cores, P = exp(S scale - lse), dS = P (dP - delta) scale, dq += dS K
// with dS as a bf16 hi + lo pair. Each row's dq has one owning warp.
template <int DMAX, bool FULL>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ ml_rows, __nv_bfloat16* __restrict__ dq,
    MmaShape s) {
  constexpr int kNT = DMAX / 8;  // 8-wide d tiles of dq
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = tid >> 5;  // the warp's rows: 16 rg .. 16 rg + 15
  const int rep = s.H / s.KV;
  const int dp = FULL ? DMAX : (s.D + 15) & ~15;
  // 16-deep k steps over d: a constant where D fills DMAX (FULL), so
  // that no step of the unrolled products waits on a branch
  const int kd = FULL ? DMAX / 16 : dp / 16;
  const int qp = dp + 8;   // bf16 row pitch (elements)
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_bwd);
  __nv_bfloat16* sdo = sq + kDqRows * qp;
  __nv_bfloat16* ring = sdo + kDqRows * qp;  // [2][k, v][kKeyTile][qp]

  const int g = blockIdx.x % s.KV;
  const long long b = blockIdx.x / s.KV;
  const int n_rows = s.Sq * rep;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int q_last = (min(row0 + kDqRows, n_rows) - 1) / rep;
  const int k_end =
      s.causal ? max(0, min(s.Skv, s.kv_offset + q_last + 1)) : s.Skv;
  const int n_tiles = (k_end + kKeyTile - 1) / kKeyTile;

  const Share sh(dp, s.D, s.vb);
  const long long kv0 = (b * s.Skv * s.KV + g) * s.D;  // key 0's row
  const long long kv_step = static_cast<long long>(s.KV) * s.D;
  const long long hq0 = (b * s.Sq * s.H + g * rep) * s.D;  // row 0's
  __nv_bfloat16* so = ring + 2 * kKeyTile * qp;  // O: tile 1's slot
  // K and V of key tile t into ring slot t & 1
  auto issue = [&](int t) {
    __nv_bfloat16* kt = ring + (t & 1) * 2 * kKeyTile * qp;
    stage_keys(kt, kKeyTile, qp, sh, k + kv0, kv_step, t * kKeyTile, k_end,
               k);
    stage_keys(kt + kKeyTile * qp, kKeyTile, qp, sh, v + kv0, kv_step,
               t * kKeyTile, k_end, k);
  };

  // q and dO rows, and O rows in tile 1's slot (free until tile 1 is
  // issued) for delta; then tile 0
  stage_rows(sq, kDqRows, qp, sh, q + hq0, row0, n_rows, rep, s.H, k);
  stage_rows(sdo, kDqRows, qp, sh, dout + hq0, row0, n_rows, rep, s.H, k);
  stage_rows(so, kDqRows, qp, sh, out + hq0, row0, n_rows, rep, s.H, k);
  repro::cp_async_commit();
  if (n_tiles > 0) issue(0);
  repro::cp_async_commit();

  // rows of this lane: r0 = 16 rg + lane / 4 and r0 + 8
  const int r0 = rg * 16 + (lane >> 2);
  bool row_ok[2];
  int qpos[2];
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r0 + 8 * h;
    row_ok[h] = row < n_rows;
    qpos[h] = -1;
    lse_r[h] = 0.f;
    if (row_ok[h]) {
      const int qi = row / rep;
      const int hq = g * rep + (row - qi * rep);
      lse_r[h] = lse[(b * s.H + hq) * s.Sq + qi];
      qpos[h] = s.kv_offset + qi;
    }
  }
  // the warp's last key: halves above it are masked for all its rows
  const int w_row = row0 + rg * 16;
  const int warp_kmax =
      w_row >= n_rows ? -1
      : s.causal      ? s.kv_offset + min(w_row + 15, n_rows - 1) / rep
                      : s.Skv;
  // a row's live keys are those below lim; exp(x) as exp2(x log2 e)
  constexpr float kLog2e = 1.4426950408889634f;
  const float sl2 = s.scale * kLog2e;
  int lim[2];
  float lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lim[h] = !row_ok[h] ? 0 : s.causal ? min(k_end, qpos[h] + 1) : k_end;
    lse2[h] = lse_r[h] * kLog2e;
  }

  float acc[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // delta of the warp's 16 rows: lane l sums half (l / 16) of row l % 16's
  // columns, 8 at a time (the zero-padded columns and rows add nothing);
  // lanes r0 and r0 + 8 then hold the lane's two rows
  repro::cp_async_wait<1>();
  __syncthreads();  // q, dO and O landed everywhere
  {
    const int rl = rg * 16 + (lane & 15);
    float dsum = 0.f;
    for (int d = (lane >> 4) * (dp / 2); d < ((lane >> 4) + 1) * (dp / 2);
         d += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(sdo + rl * qp + d);
      const uint4 y = *reinterpret_cast<const uint4*>(so + rl * qp + d);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
        const float2 b2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
        dsum += a2.x * b2.x + a2.y * b2.y;
      }
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 16);
    del_r[0] = __shfl_sync(0xffffffffu, dsum, lane >> 2);
    del_r[1] = __shfl_sync(0xffffffffu, dsum, (lane >> 2) + 8);
    // lanes 4i hold rows i and i + 8's lse
    const float l0 = __shfl_sync(0xffffffffu, lse_r[0], (lane & 7) * 4);
    const float l1 = __shfl_sync(0xffffffffu, lse_r[1], (lane & 7) * 4);
    const int row = row0 + rl;
    if (lane < 16 && row < n_rows) {
      float* ml = ml_rows + (b * s.KV + g) * s.rows_p + row;
      ml[0] = lane < 8 ? l0 : l1;
      ml[static_cast<long long>(gridDim.x) * s.rows_p] = dsum;
    }
  }
  __syncthreads();  // tile 1's slot free again

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed everywhere
    const __nv_bfloat16* kt = ring + (t & 1) * 2 * kKeyTile * qp;
    const __nv_bfloat16* vt = kt + kKeyTile * qp;
#pragma unroll 1
    for (int kh = 0; kh < kKeyTile / 32; ++kh) {
      const int kb = t * kKeyTile + kh * 32;  // the half's first key
      // warp-uniform: the half is masked for all its rows
      if (kb > warp_kmax || kb >= k_end) continue;
      // S = Q K^T and dP = dO V^T for the warp's 16 rows x 32 keys
      float sc[4][4], dpv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = dpv[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks) {
        if (ks < kd) {
          uint32_t a[4], ad[4];
          const int ao = (rg * 16 + (lane & 15)) * qp + ks * 16 +
                         (lane >> 4) * 8;
          repro::ldsm_x4(a, sq + ao);
          repro::ldsm_x4(ad, sdo + ao);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bk[4], bv[4];
            const int bo = (kh * 32 + np * 16 + (lane & 7) +
                            ((lane >> 4) & 1) * 8) * qp +
                           ks * 16 + ((lane >> 3) & 1) * 8;
            repro::ldsm_x4(bk, kt + bo);
            repro::ldsm_x4(bv, vt + bo);
            repro::mma_bf16(sc[2 * np], a, bk[0], bk[1]);
            repro::mma_bf16(sc[2 * np + 1], a, bk[2], bk[3]);
            repro::mma_bf16(dpv[2 * np], ad, bv[0], bv[1]);
            repro::mma_bf16(dpv[2 * np + 1], ad, bv[2], bv[3]);
          }
        }
      }
      // P and dS in the accumulator layout (sc now holds dS)
      const int kl = kb + 2 * (lane & 3);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = exp2f(fmaf(sc[nt][e], sl2, -lse2[h]));
          sc[nt][e] = kl + nt * 8 + (e & 1) < lim[h]
                          ? p * (dpv[nt][e] - del_r[h]) * s.scale
                          : 0.f;
        }
      }
      // dq += dS K: dS's accumulators are the A fragments, 16 keys a
      // step, as a bf16 hi + lo pair; K transposed by ldmatrix
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
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
            repro::ldsm_x4_t(bb, kt + (kh * 32 + kk * 16 + (lane & 7) +
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
    __syncthreads();  // tile t's slot free for tile t + 2
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int row = row0 + r0 + 8 * h;
    const int qi = row / rep;
    const int hq = g * rep + (row - qi * rep);
    __nv_bfloat16* o = dq + ((b * s.Sq + qi) * s.H + hq) * s.D;
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const int d = i * 8 + 2 * (lane & 3);
      if (d + 1 < s.D && (s.D & 1) == 0) {  // a bf16 pair, 4-byte aligned
        *reinterpret_cast<uint32_t*>(o + d) =
            repro::pack_bf16(acc[i][2 * h], acc[i][2 * h + 1]);
      } else {
        if (d < s.D) o[d] = __float2bfloat16_rn(acc[i][2 * h]);
        if (d + 1 < s.D) o[d + 1] = __float2bfloat16_rn(acc[i][2 * h + 1]);
      }
    }
  }
}

// dk/dv pass. Block (x, y): batch row x / KV, KV head x % KV, keys
// kDkvKeys y .. kDkvKeys y + 15 (the first keys, which the most rows see
// under the causal mask, start first). Its 4 warps are 4 / kDG row
// groups times kDG column groups (2 at DMAX 256, where dk and dv of 16
// keys x 256 columns do not fit a warp's registers, else 1). It walks the row tiles of 64
// rows from the first row whose query sees the block's first key, with
// their lse and delta from the row layout the dq pass wrote; a warp takes
// the tile's 16-row chunks of its row group: S^T = K Q^T and dP^T = V dO^T
// for the block's 16 keys (the column groups compute them alike), P^T =
// exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale, then dv += P^T dO
// and dk += dS^T Q over its column tiles, P^T and dS^T as bf16 hi + lo
// pairs. The rows run over (query, head of the group) pairs, so the sum
// over the group's heads is part of the products' k dimension. The row
// groups' dk, dv merge in group order through shared memory.
template <int DMAX, bool FULL>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ ml_rows, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, MmaShape s) {
  constexpr int kDG = DMAX > 128 ? 2 : 1;          // column groups
  constexpr int kCT = (DMAX / 16 + kDG - 1) / kDG;  // column tiles a warp
  constexpr int kRG = 4 / kDG;                      // row groups
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp % kRG;
  const int dg = warp / kRG;
  const int rep = s.H / s.KV;
  const int dp = FULL ? DMAX : (s.D + 15) & ~15;
  const int kd = FULL ? DMAX / 16 : dp / 16;  // as in the dq pass
  const int qp = dp + 8;
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_bwd);
  __nv_bfloat16* sv = sk + kDkvKeys * qp;
  __nv_bfloat16* ring = sv + kDkvKeys * qp;  // [2][q, dO][kRowTile][qp]
  float* sml = reinterpret_cast<float*>(ring + 2 * 2 * kRowTile * qp);

  const int g = blockIdx.x % s.KV;
  const long long b = blockIdx.x / s.KV;
  const int k0 = blockIdx.y * kDkvKeys;
  const int n_rows = s.Sq * rep;
  // the first row tile holding a row whose query sees key k0
  const int row_start =
      s.causal ? min(s.Sq, max(0, k0 - s.kv_offset)) * rep : 0;
  const int t_lo = row_start / kRowTile;
  const int t_hi = (n_rows + kRowTile - 1) / kRowTile;

  const Share sh(dp, s.D, s.vb);
  const long long kv0 = (b * s.Skv * s.KV + g) * s.D;
  const long long kv_step = static_cast<long long>(s.KV) * s.D;
  const long long hq0 = (b * s.Sq * s.H + g * rep) * s.D;  // row 0's
  // the head's lse and delta rows (64 a tile, 256-byte aligned)
  const float* lse_rows = ml_rows + (b * s.KV + g) * s.rows_p;
  const float* del_rows =
      lse_rows + static_cast<long long>(gridDim.x) * s.rows_p;
  // q / dO rows, lse and delta of row tile t into ring slot (t - t_lo) & 1
  auto issue = [&](int t) {
    const int slot = (t - t_lo) & 1;
    __nv_bfloat16* qt = ring + slot * 2 * kRowTile * qp;
    float* ml = sml + slot * 2 * kRowTile;
    stage_rows(qt, kRowTile, qp, sh, q + hq0, t * kRowTile, n_rows, rep,
               s.H, k);
    stage_rows(qt + kRowTile * qp, kRowTile, qp, sh, dout + hq0,
               t * kRowTile, n_rows, rep, s.H, k);
    // 16 chunks of 4 floats each of lse and delta (rows past n_rows hold
    // whatever the scratch held: the masks select them away)
    if (tid < 2 * kRowTile / 4) {
      const int c = tid % (kRowTile / 4);
      repro::cp_async16(ml + tid * 4,
                        (tid < kRowTile / 4 ? lse_rows : del_rows) +
                            t * kRowTile + c * 4,
                        16);
    }
  };

  float acc[2][kCT][2][4];  // [dk, dv][column tile][8-wide half][4]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int c = 0; c < kCT; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][c][i][e] = 0.f;

  stage_keys(sk, kDkvKeys, qp, sh, k + kv0, kv_step, k0, s.Skv, k);
  stage_keys(sv, kDkvKeys, qp, sh, v + kv0, kv_step, k0, s.Skv, k);
  if (t_lo < t_hi) issue(t_lo);
  repro::cp_async_commit();

  // the lane's keys k0 + lane / 4 (+8) are live for rows from thr on
  // (row / rep >= key - kv_offset under the causal mask); a warp skips
  // a chunk whose last row is below the first key's threshold
  constexpr float kLog2e = 1.4426950408889634f;
  const float sl2 = s.scale * kLog2e;
  int thr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + (lane >> 2) + 8 * h;
    thr[h] = key >= s.Skv ? INT_MAX
             : s.causal  ? max(0, key - s.kv_offset) * rep
                         : 0;
  }
  const int thr_w =
      k0 >= s.Skv ? INT_MAX
      : s.causal  ? max(0, k0 - s.kv_offset) * rep
                  : 0;
  for (int t = t_lo; t < t_hi; ++t) {
    if (t + 1 < t_hi) {
      issue(t + 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, first, k and v) landed everywhere
    const int slot = (t - t_lo) & 1;
    const __nv_bfloat16* qt = ring + slot * 2 * kRowTile * qp;
    const __nv_bfloat16* dt = qt + kRowTile * qp;
    const float* lse_s = sml + slot * 2 * kRowTile;
    const float* del_s = lse_s + kRowTile;
#pragma unroll 1
    for (int rc = rg; rc < kRowTile / 16; rc += kRG) {
      const int c_row = t * kRowTile + rc * 16;  // the chunk's first row
      // warp-uniform: no row left, or (causal) the chunk's last query
      // sees none of the block's keys
      if (c_row >= n_rows || min(c_row + 15, n_rows - 1) < thr_w) continue;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 rows
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DMAX / 16; ++ks) {
        if (ks < kd) {
          uint32_t a[4], av[4], bq[4], bd[4];
          const int ao = (lane & 15) * qp + ks * 16 + (lane >> 4) * 8;
          repro::ldsm_x4(a, sk + ao);
          repro::ldsm_x4(av, sv + ao);
          const int bo = (rc * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * qp +
                         ks * 16 + ((lane >> 3) & 1) * 8;
          repro::ldsm_x4(bq, qt + bo);
          repro::ldsm_x4(bd, dt + bo);
          repro::mma_bf16(st[0], a, bq[0], bq[1]);
          repro::mma_bf16(st[1], a, bq[2], bq[3]);
          repro::mma_bf16(dpt[0], av, bd[0], bd[1]);
          repro::mma_bf16(dpt[1], av, bd[2], bd[3]);
        }
      }
      // P^T into st, dS^T into dpt: element (key k0 + lane / 4 (+8),
      // row c_row + 8 nt + 2 (lane % 4) (+1))
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int rl = rc * 16 + nt * 8 + 2 * (lane & 3) + c;
          const int row = t * kRowTile + rl;
          const float l2 = lse_s[rl] * kLog2e;
          const float dl = del_s[rl];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + c;
            const bool live = row >= thr[h] && row < n_rows;
            const float p =
                live ? exp2f(fmaf(st[nt][e], sl2, -l2)) : 0.f;
            st[nt][e] = p;
            dpt[nt][e] = live ? p * (dpt[nt][e] - dl) * s.scale : 0.f;
          }
        }
      }
      // A fragments of P^T and dS^T (16 keys x 16 rows), hi + lo
      uint32_t ph[4], pl[4], dh[4], dl[4];
      repro::pack_bf16_split(st[0][0], st[0][1], ph[0], pl[0]);
      repro::pack_bf16_split(st[0][2], st[0][3], ph[1], pl[1]);
      repro::pack_bf16_split(st[1][0], st[1][1], ph[2], pl[2]);
      repro::pack_bf16_split(st[1][2], st[1][3], ph[3], pl[3]);
      repro::pack_bf16_split(dpt[0][0], dpt[0][1], dh[0], dl[0]);
      repro::pack_bf16_split(dpt[0][2], dpt[0][3], dh[1], dl[1]);
      repro::pack_bf16_split(dpt[1][0], dpt[1][1], dh[2], dl[2]);
      repro::pack_bf16_split(dpt[1][2], dpt[1][3], dh[3], dl[3]);
      // dv += P^T dO, dk += dS^T Q over the warp's column tiles (rows as
      // the k dimension: dO and q transposed by ldmatrix)
      const int bo = (rc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * qp +
                     (lane >> 4) * 8;
#pragma unroll
      for (int c = 0; c < kCT; ++c) {
        const int ct = dg * kCT + c;
        if (ct < kd) {
          uint32_t bd[4], bq[4];
          repro::ldsm_x4_t(bd, dt + bo + ct * 16);
          repro::ldsm_x4_t(bq, qt + bo + ct * 16);
          repro::mma_bf16(acc[1][c][0], ph, bd[0], bd[1]);
          repro::mma_bf16(acc[1][c][0], pl, bd[0], bd[1]);
          repro::mma_bf16(acc[1][c][1], ph, bd[2], bd[3]);
          repro::mma_bf16(acc[1][c][1], pl, bd[2], bd[3]);
          repro::mma_bf16(acc[0][c][0], dh, bq[0], bq[1]);
          repro::mma_bf16(acc[0][c][0], dl, bq[0], bq[1]);
          repro::mma_bf16(acc[0][c][1], dh, bq[2], bq[3]);
          repro::mma_bf16(acc[0][c][1], dl, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // tile t's slot free for tile t + 2
  }
  repro::cp_async_wait<0>();

  {
    // row groups 1, 2, .. add onto group 0's dk, dv in turn, through the
    // ring: the slot of the warp's column group dg holds its column tiles
    // below kd, w = min(kCT, kd) tiles of 2 x 2 x 4 floats a lane
    const int w = min(kCT, kd);
    const int n_c = min(kCT, kd - dg * kCT);  // the warp's tiles below kd
    float* mine = reinterpret_cast<float*>(ring) + dg * 16 * w * 32;
    for (int j = 1; j < kRG; ++j) {
      __syncthreads();  // the ring (then the last slot) is free
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int c = 0; c < kCT; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (rg == j && c < n_c)
              *reinterpret_cast<float4*>(
                  mine + (((m * w + c) * 2 + i) * 32 + lane) * 4) =
                  make_float4(acc[m][c][i][0], acc[m][c][i][1],
                              acc[m][c][i][2], acc[m][c][i][3]);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int c = 0; c < kCT; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (rg == 0 && c < n_c) {
              const float4 x = *reinterpret_cast<const float4*>(
                  mine + (((m * w + c) * 2 + i) * 32 + lane) * 4);
              acc[m][c][i][0] += x.x;
              acc[m][c][i][1] += x.y;
              acc[m][c][i][2] += x.z;
              acc[m][c][i][3] += x.w;
            }
    }
    if (rg > 0) return;
  }

  // write the block's keys k0 + lane / 4 (+8) in the warp's column tiles
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + (lane >> 2) + 8 * h;
    if (key >= s.Skv) continue;
    const long long o = ((b * s.Skv + key) * s.KV + g) * s.D;
#pragma unroll
    for (int c = 0; c < kCT; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = (dg * kCT + c) * 16 + i * 8 + 2 * (lane & 3);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          __nv_bfloat16* x = (m ? dv : dk) + o;
          const float* a = acc[m][c][i];
          if (d + 1 < s.D && (s.D & 1) == 0) {
            *reinterpret_cast<uint32_t*>(x + d) =
                repro::pack_bf16(a[2 * h], a[2 * h + 1]);
          } else {
            if (d < s.D) x[d] = __float2bfloat16_rn(a[2 * h]);
            if (d + 1 < s.D) x[d + 1] = __float2bfloat16_rn(a[2 * h + 1]);
          }
        }
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  int B, Sq, Skv, H, KV, D;
  float scale;
  int causal, kv_offset, vb, smem_dq, smem_dkv;
  cudaStream_t stream;
};

// delta = rowsum(dO * O) into the f32 scratch (B, H, Sq)
template <typename T>
int launch_delta(const Args& a) {
  const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                              a.stream>>>(
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), rows, a.Sq, a.H, a.D);
  return static_cast<int>(cudaGetLastError());
}

template <int DPL>
int launch_fma(const Args& a) {
  using T = float;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const int dq_smem = static_cast<int>(
      sizeof(float) * (2 * kBQ * a.D + 2 * kBK * repro::odd_pitch(a.D)));
  const int dkv_smem = static_cast<int>(sizeof(float) * dkv_smem_floats(a.D));
  if (dq_smem != a.smem_dq || dkv_smem != a.smem_dkv) return bad;
  cudaError_t err;
  // no query rows: no delta and no dq to write; the dk/dv kernel still
  // runs and writes zeros (it finds no query tile)
  if (a.Sq > 0) {
    int e = launch_delta<T>(a);
    if (e) return e;
    auto dq_kernel = flash_bwd_dq_kernel<T, DPL>;
    err = repro::allow_smem(dq_kernel, dq_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<<<dim3((a.Sq + kBQ - 1) / kBQ, a.H, a.B), kThreads, dq_smem,
                a.stream>>>(q, k, v, dout, lse, delta,
                            static_cast<T*>(a.dq), a.Sq, a.Skv, a.H, a.KV,
                            a.D, a.scale, a.causal, a.kv_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  if (a.Skv == 0) return 0;
  auto dkv_kernel = flash_bwd_dkv_kernel<T>;
  err = repro::allow_smem(dkv_kernel, dkv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dim3((a.Skv + kBK - 1) / kBK, a.KV, a.B), kThreads, dkv_smem,
               a.stream>>>(q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
                           static_cast<T*>(a.dv), a.Sq, a.Skv, a.H, a.KV,
                           a.D, a.scale, a.causal, a.kv_offset);
  return static_cast<int>(cudaGetLastError());
}

// kDqRows rows a dq block, kDkvKeys keys a dk/dv block; delta holds the
// lse and delta rows, (2, B * KV, rows_p) f32.
template <int DMAX, bool FULL>
int launch_mma(const Args& a) {
  using T = __nv_bfloat16;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (a.vb != 16 && a.vb != 4 && a.vb != 1) return bad;
  const MmaSmem lay(a.D);
  if (lay.dq != a.smem_dq || lay.dkv != a.smem_dkv) return bad;
  const int n_rows = a.Sq * (a.H / a.KV);
  const MmaShape s{a.Sq,     a.Skv,       a.H,
                   a.KV,     a.D,         a.vb,
                   a.causal, a.kv_offset, (n_rows + 63) / 64 * 64,
                   a.scale};
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  float* ml_rows = static_cast<float*>(a.delta);
  const unsigned groups = static_cast<unsigned>(a.B) * a.KV;
  cudaError_t err;
  if (a.Sq > 0) {
    auto dq_kernel = flash_bwd_dq_mma_kernel<DMAX, FULL>;
    err = repro::allow_smem(dq_kernel, lay.dq);
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<<<dim3(groups, (n_rows + kDqRows - 1) / kDqRows),
                kMmaThreads, lay.dq, a.stream>>>(
        q, k, v, static_cast<const T*>(a.out), dout,
        static_cast<const float*>(a.lse), ml_rows, static_cast<T*>(a.dq), s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.Skv == 0) return 0;
  auto dkv_kernel = flash_bwd_dkv_mma_kernel<DMAX, FULL>;
  err = repro::allow_smem(dkv_kernel, lay.dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dim3(groups, (a.Skv + kDkvKeys - 1) / kDkvKeys),
               kMmaThreads, lay.dkv, a.stream>>>(
      q, k, v, dout, ml_rows, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Skv,KV,D), out/dout (B,Sq,H,D) contiguous in
// `dtype` (kF32 | kBF16), lse (B,H,Sq) f32; writes dq (B,Sq,H,D), dk/dv
// (B,Skv,KV,D) in `dtype` and the f32 scratch `delta`: float32 delta
// (B,H,Sq), bf16 the lse and delta rows (2, B * KV, rows_p), rows_p =
// Sq * H / KV rounded up to 64. Launches on `stream`: float32 three
// (delta, dq, dk/dv), bf16 two (dq with delta, dk/dv). The launch plan
// (`bwd_plan` in kernels/flash_attention/flash_attention.py): bf16 takes
// the cp.async width vb (16, 4 or 1: synchronous) of the staged rows;
// float32 ignores it. Both passes' dynamic shared-memory bytes are
// checked against the kernels' own layouts.
// Returns cudaGetLastError() of the launches (cudaErrorInvalidValue for
// an operand or plan the kernels do not take).
extern "C" int repro_flash_mha_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int Sq, int Skv, int H, int KV,
                                   int D, int dtype, float scale, int causal,
                                   int kv_offset, int vb, int smem_dq,
                                   int smem_dkv, void* stream) {
  if (B == 0) return 0;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (D <= 0 || KV <= 0 || H % KV) return bad;
  const Args a{q,  k,     v,      out,       lse, dout,    dq,
               dk, dv,    delta,  B,         Sq,  Skv,     H,
               KV, D,     scale,  causal,    kv_offset,    vb,
               smem_dq,   smem_dkv, static_cast<cudaStream_t>(stream)};
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
    // D padded to 16 equal to the instantiated width (32, 64, 128, 256:
    // every served head dim), or below it
    if (dp == 32) return launch_mma<32, true>(a);
    if (dp == 64) return launch_mma<64, true>(a);
    if (dp == 128) return launch_mma<128, true>(a);
    if (dp == 256) return launch_mma<256, true>(a);
    if (dp < 32) return launch_mma<32, false>(a);
    if (dp < 64) return launch_mma<64, false>(a);
    if (dp < 128) return launch_mma<128, false>(a);
    if (dp < 256) return launch_mma<256, false>(a);
  }
  return bad;
}
