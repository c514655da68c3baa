// Mamba2 chunked SSD forward (state-space duality, arXiv:2405.21060).
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py `_kernel` (grid (B, H,
// n_chunks) with the chunk axis sequential, the (P, N) state carried in
// VMEM scratch across chunks, three MXU products per chunk).
//
// Per (batch b, head h), over chunks of kQ = 64 positions:
//   cum    = inclusive cumsum of A_h * dt                (<= 0)
//   S[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j         (j <= i, else 0)
//   y_i    = sum_j S[i,j] x_j + exp(cum_i) C_i . state^T + D_h x_i
//   state  = exp(cum_last) state
//            + sum_j x_j (x) (exp(cum_last - cum_j) dt_j B_j)
// Every exponent is <= 0, so no max subtraction is needed. The arithmetic
// is float32 (x, B, C and y float32 or bf16; dt, A, D and the states
// float32) except the cumsum, which is kept in float64: a decay
// exp(cum_i - cum_j) is the difference of two sums that reach |A dt| x 64
// and more, and in float32 that difference loses the digits that terms in
// the hundreds (C.B at N = 128) then multiply.
//
// Bound: operations. At the engine's prefill shape (B=1, S=128, H=48,
// P=64, N=128, bf16) one call moves about 3.2 MB (0.96 us at 3.35 TB/s)
// and does about 0.5 GFLOP of float32 work on CUDA cores (7.5 us at
// 67 TFLOP/s), so the float32 FMA rate is the limit.
//
// Design: one block of 256 threads per (b, h); a loop over chunks inside
// the block takes the place of the TPU's sequential grid axis, and the
// state stays in shared memory for the whole loop (64 x 128 floats =
// 32 KB at full width). The chunk length is the kernel's own choice, 64:
// with kQ = 128 the B, C, x, state and score tiles would take 256 KB, over
// the 227 KB a block may use; at 64 they take 133 KB. The SSD
// decomposition is exact for any chunk length, and the last chunk is
// masked (dt, x, B, C read as 0 past S) instead of shrinking the chunk, so
// ragged prompt lengths cost no extra chunks. Each product is a 64 x 64
// output tile over the 16 x 16 threads, 4 x 4 outputs per thread in
// registers; P and N are walked in tiles of 64 (smaller ones zero-padded
// in shared memory). Row pitches are odd, so the 16 rows a half-warp reads
// at one column sit on 16 different banks. Plain FMAs on CUDA cores;
// tensor-core tiles come later. At batch 1 the grid is H = 48 blocks on
// 132 SMs: splitting P across blocks is the first thing to change.

#include "common.cuh"

namespace {

constexpr int kQ = 64;         // chunk length (positions per loop step)
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // output tile side: 16 threads x 4

// shared-memory layout of one block, in floats
struct Layout {
  int PP, NN;  // P and N rounded up to kTile
  int pp, pn;  // odd row pitches of the [.][P] and [.][N] tiles
  int cum, b, c, x, st, s, dt, w, total;
};

__host__ __device__ inline Layout layout(int P, int N) {
  Layout L;
  L.PP = (P + kTile - 1) / kTile * kTile;
  L.NN = (N + kTile - 1) / kTile * kTile;
  L.pp = L.PP + 1;
  L.pn = L.NN + 1;
  L.cum = 0;                       // cumsum   [kQ] doubles (8-B aligned)
  L.b = 2 * kQ;                    // B chunk  [kQ][pn]
  L.c = L.b + kQ * L.pn;           // C chunk  [kQ][pn]
  L.x = L.c + kQ * L.pn;           // x chunk  [kQ][pp]
  L.st = L.x + kQ * L.pp;          // state    [PP][pn]
  L.s = L.st + L.PP * L.pn;        // scores   [kQ][kQ + 1]
  L.dt = L.s + kQ * (kQ + 1);      // dt       [kQ]
  L.w = L.dt + kQ;                 // exp(total - cum) dt  [kQ]
  L.total = L.w + kQ;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ D,
                   const float* __restrict__ h0, T* __restrict__ y,
                   float* __restrict__ hT, int S, int H, int P, int G,
                   int N) {
  extern __shared__ float smem[];
  const Layout L = layout(P, N);
  float* Bs = smem + L.b;
  float* Cs = smem + L.c;
  float* Xs = smem + L.x;
  float* St = smem + L.st;
  float* Ss = smem + L.s;
  float* dts = smem + L.dt;
  double* cums = reinterpret_cast<double*>(smem + L.cum);
  float* ws = smem + L.w;
  constexpr int ps = kQ + 1;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a_h = A[h];
  const float d_h = D ? D[h] : 0.f;

  for (int i = tid; i < L.PP * L.pn; i += kThreads) {
    const int p = i / L.pn, n = i % L.pn;
    St[i] = (h0 && p < P && n < N)
                ? h0[((static_cast<size_t>(b) * H + h) * P + p) * N + n]
                : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int len = min(kQ, S - c0);
    // ---- load the chunk, zero past S and in the tile padding
    for (int i = tid; i < kQ * L.NN; i += kThreads) {
      const int t = i / L.NN, n = i % L.NN;
      float bv = 0.f, cv = 0.f;
      if (t < len && n < N) {
        const size_t off =
            ((static_cast<size_t>(b) * S + c0 + t) * G + g) * N + n;
        bv = repro::to_float(Bm[off]);
        cv = repro::to_float(Cm[off]);
      }
      Bs[t * L.pn + n] = bv;
      Cs[t * L.pn + n] = cv;
    }
    for (int i = tid; i < kQ * L.PP; i += kThreads) {
      const int t = i / L.PP, p = i % L.PP;
      float xv = 0.f;
      if (t < len && p < P)
        xv = repro::to_float(
            x[((static_cast<size_t>(b) * S + c0 + t) * H + h) * P + p]);
      Xs[t * L.pp + p] = xv;
    }
    if (tid < kQ)
      dts[tid] = tid < len
                     ? dt[(static_cast<size_t>(b) * S + c0 + tid) * H + h]
                     : 0.f;
    __syncthreads();

    // ---- inclusive cumsum of A * dt in float64: warp 0, two per lane
    if (tid < 32) {
      const double a0 = a_h * dts[2 * tid], a1 = a_h * dts[2 * tid + 1];
      double s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += v;
      }
      double prev = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) prev = 0.0;
      cums[2 * tid] = prev + a0;
      cums[2 * tid + 1] = prev + a0 + a1;
    }
    __syncthreads();
    const double total = cums[kQ - 1];
    if (tid < kQ)
      ws[tid] = expf(static_cast<float>(total - cums[tid])) * dts[tid];

    // ---- scores S[i][j], i = ty + 16a, j = tx + 16c
    {
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * L.pn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * L.pn + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * a, j = tx + 16 * c;
          Ss[i * ps + j] =
              j <= i ? acc[a][c] *
                           expf(static_cast<float>(cums[i] - cums[j])) *
                           dts[j]
                     : 0.f;
        }
    }
    __syncthreads();

    // ---- y[i][p], i = ty + 16a, p = pb + tx + 16c (state before update)
    for (int pb = 0; pb < P; pb += kTile) {
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < len; ++j) {
        float sv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a] = Ss[(ty + 16 * a) * ps + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = Xs[j * L.pp + pb + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            intra[a][c] = fmaf(sv[a], xv[c], intra[a][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ty + 16 * a) * L.pn + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = St[(pb + tx + 16 * c) * L.pn + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            inter[a][c] = fmaf(cv[a], sv[c], inter[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i >= len) continue;
        const float ec = expf(static_cast<float>(cums[i]));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = pb + tx + 16 * c;
          if (p >= P) continue;
          const float v =
              intra[a][c] + ec * inter[a][c] + d_h * Xs[i * L.pp + p];
          y[((static_cast<size_t>(b) * S + c0 + i) * H + h) * P + p] =
              repro::from_float<T>(v);
        }
      }
    }
    __syncthreads();

    // ---- state[p][n] = exp(total) state + sum_j x_j[p] w_j B_j[n],
    //      p = pb + ty + 16a, n = nb + tx + 16c (padding stays zero)
    const float et = expf(static_cast<float>(total));
    for (int pb = 0; pb < P; pb += kTile)
      for (int nb = 0; nb < N; nb += kTile) {
        float acc[4][4] = {};
        for (int j = 0; j < len; ++j) {
          const float wj = ws[j];
          float xv[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            xv[a] = Xs[j * L.pp + pb + ty + 16 * a] * wj;
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[j * L.pn + nb + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float* sp = St + (pb + ty + 16 * a) * L.pn + nb + tx + 16 * c;
            *sp = fmaf(et, *sp, acc[a][c]);
          }
      }
    __syncthreads();
  }

  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    hT[((static_cast<size_t>(b) * H + h) * P + p) * N + n] = St[p * L.pn + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* D, const void* h0, void* y, void* hT,
           int Bz, int S, int H, int P, int G, int N, cudaStream_t stream) {
  const size_t smem = layout(P, N).total * sizeof(float);
  auto kernel = ssd_fwd_kernel<T>;
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, Bz), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(hT), S, H, P, G, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory one block takes for head dim P and state size N.
extern "C" long long repro_ssd_smem_bytes(int P, int N) {
  return static_cast<long long>(layout(P, N).total) * sizeof(float);
}

// x (Bz,S,H,P), B/C (Bz,S,G,N) and y (Bz,S,H,P) of dtype code `dtype`
// (csrc/common.cuh); dt (Bz,S,H), A (H), D (H) or null, h0 (Bz,H,P,N) or
// null, hT (Bz,H,P,N) float32; all contiguous on the device. Returns
// cudaGetLastError() of the launch.
extern "C" int repro_ssd_fwd(int dtype, const void* x, const void* dt,
                             const void* A, const void* Bm, const void* Cm,
                             const void* D, const void* h0, void* y,
                             void* hT, int Bz, int S, int H, int P, int G,
                             int N, void* stream) {
  if (Bz == 0 || H == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return launch<float>(x, dt, A, Bm, Cm, D, h0, y, hT, Bz, S, H, P, G,
                           N, s);
    case repro::kBF16:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, h0, y, hT, Bz, S, H,
                                   P, G, N, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
