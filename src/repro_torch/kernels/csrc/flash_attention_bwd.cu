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
// the bf16 tensor-core rate 2.6 us; at S 1024 the operations. This first
// body runs them on the FMA units out of shared memory, not on the tensor
// cores, and takes about 1.1 ms there (H100, CUDA events): it is right
// and simple first (making it fast with mma / wgmma is a later change).
//
// Design: three kernels on the caller's stream, no atomics, every output
// element written by one thread in a fixed order, so two calls give the
// same bits.
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

#include "common.cuh"

namespace {

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

struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  int B, Sq, Skv, H, KV, D;
  float scale;
  int causal, kv_offset;
  cudaStream_t stream;
};

template <typename T, int DPL>
int launch(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  cudaError_t err;
  // no query rows: no delta and no dq to write; the dk/dv kernel still
  // runs and writes zeros (it finds no query tile)
  if (a.Sq > 0) {
    const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
    flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256,
                                0, a.stream>>>(static_cast<const T*>(a.out),
                                               dout, delta, rows, a.Sq, a.H,
                                               a.D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const size_t dq_smem =
        sizeof(float) * (2 * kBQ * a.D + 2 * kBK * repro::odd_pitch(a.D));
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
  const size_t dkv_smem = sizeof(float) * dkv_smem_floats(a.D);
  auto dkv_kernel = flash_bwd_dkv_kernel<T>;
  err = repro::allow_smem(dkv_kernel, dkv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<dim3((a.Skv + kBK - 1) / kBK, a.KV, a.B), kThreads, dkv_smem,
               a.stream>>>(q, k, v, dout, lse, delta, static_cast<T*>(a.dk),
                           static_cast<T*>(a.dv), a.Sq, a.Skv, a.H, a.KV,
                           a.D, a.scale, a.causal, a.kv_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a) {
  switch (repro::lane_width(a.D)) {
    case 1: return launch<T, 1>(a);
    case 2: return launch<T, 2>(a);
    case 4: return launch<T, 4>(a);
    case 8: return launch<T, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory (bytes) the dk/dv kernel takes at head dim D; the wrapper
// reads it to refuse a D past the card's limit.
extern "C" int repro_flash_mha_bwd_smem(int D) {
  return static_cast<int>(sizeof(float)) * dkv_smem_floats(D);
}

// q (B,Sq,H,D), k/v (B,Skv,KV,D), out/dout (B,Sq,H,D) contiguous in
// `dtype` (kF32 | kBF16), lse (B,H,Sq) f32; writes dq (B,Sq,H,D), dk/dv
// (B,Skv,KV,D) in `dtype` and the f32 scratch delta (B,H,Sq). Three
// launches on `stream`. Returns cudaGetLastError() of the launches
// (cudaErrorInvalidValue for an operand the kernels do not take).
extern "C" int repro_flash_mha_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int B, int Sq, int Skv, int H, int KV,
                                   int D, int dtype, float scale, int causal,
                                   int kv_offset, void* stream) {
  if (B == 0) return 0;
  if (D <= 0 || KV <= 0 || H % KV) return cudaErrorInvalidValue;
  const Args a{q,  k,  v,   out, lse,     dout,      dq,
               dk, dv, delta, B, Sq,      Skv,       H,
               KV, D,  scale, causal,     kv_offset, static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kF32) return dispatch<float>(a);
  if (dtype == repro::kBF16) return dispatch<__nv_bfloat16>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
