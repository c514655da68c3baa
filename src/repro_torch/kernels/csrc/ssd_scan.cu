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
// Every exponent is <= 0, so no max subtraction is needed. The cumsum is
// kept in float64: a decay exp(cum_i - cum_j) is the difference of two
// sums that reach |A dt| x 64 and more, and in float32 that difference
// loses the digits that terms in the hundreds (C.B at N = 128) then
// multiply. The chunk length is the kernel's own choice, 64 (the SSD
// decomposition is exact for any chunk length), and the last chunk is
// masked (dt, x, B, C read as 0 past S) instead of shrinking the chunk, so
// ragged prompt lengths cost no extra chunks. One launch per call; every
// sum has a fixed order (no atomics), so a call is deterministic.
//
// Two bodies, chosen by the wrapper's launch plan
// (`kernels/ssd_scan/ssd_scan.py` `launch_plan`):
//
// ssd_mma_kernel (bf16 x, B and C, N <= 128; the serving path). Bound:
// bytes. At the engine's prefill shape (B=1, S=128, H=48, P=64, N=128)
// one call moves about 3.24 MB (0.97 us at 3.35 TB/s); its products on
// the bf16 tensor cores, hi + lo pairs counted twice, take about 0.3 us
// at 989 TFLOP/s. The first design (one block of float32 FMAs per (b,
// h)) ran 48 blocks on 132 SMs at 20x that bound. Design:
// - Grid (P / PB, H, B): a block owns PB (16, 32 or 64) columns of the
//   head's P, so batch 1 fills the card; each block recomputes its
//   head's C.B^T scores, which on the tensor cores cost about as much as
//   one PB-wide product. 8 warps in two roles that run side by side on
//   each chunk: row warp w < 4 owns chunk rows 16w..16w+15 of the scores
//   and of y (it reads the state as it was before the chunk), state warp
//   4 + w owns columns [w NN/4, (w+1) NN/4) of the state and updates
//   them; N is rounded up to NN = 64 or 128 at compile time, so every
//   loop over it unrolls.
// - mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix (csrc/mma.cuh). The
//   scores C.B^T take bf16 C and B as they are (exact); causal tiles past
//   the warp's rows are skipped. The decayed scores S (float32) enter
//   S.x as a bf16 hi + lo pair straight from the accumulators, the
//   float32 state enters C.state^T as hi + lo bf16 copies in shared
//   memory, and the state update takes (exp(total - cum_j) dt_j x_j) as
//   hi + lo against B exact: each float32 operand keeps about 16 bits,
//   every product is exact in float32 and every sum is float32.
// - The float32 state stays in registers for the whole scan, in the
//   accumulator layout of the update's mma (decayed in place, then the
//   chunk's terms added), and is written back as hi + lo after each
//   chunk for the next chunk's C.state^T.
// - Staging: B, C and the block's x columns as raw bf16 rows through
//   cp.async (16 bytes where rows and bases allow, else 4, else
//   synchronous bytes; zero-filled past S, N and P), in a two-stage ring
//   so the next chunk's copies are in flight while this chunk computes
//   (one stage where shared memory would not hold two); copy loops step
//   (row, chunk) without integer division. Row pitches are odd multiples
//   of 16 bytes, so ldmatrix's eight rows meet eight bank groups.
//
// ssd_fma_kernel (float32 inputs, and bf16 with N > 128). Bound:
// operations: about 0.5 GFLOP of float32 FMAs at the prefill shape (7.5
// us at 67 TFLOP/s). One block of 256 threads per (b, h); the state stays
// in shared memory (64 x 128 floats = 32 KB at full width); each product
// is a 64 x 64 output tile over 16 x 16 threads, 4 x 4 outputs each in
// registers; P and N are walked in tiles of 64 (smaller ones zero-padded
// in shared memory); odd row pitches. It keeps the float32 path's sums
// as they were, for the float32 gates that hold the kernel to the plain
// version.

#include "common.cuh"
#include "mma.cuh"

namespace {

// ------------------------------------------------------------------ FMA
namespace fma {


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
    ssd_fma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
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

}  // namespace fma

// ------------------------------------------------------ tensor cores
namespace tc {

constexpr int kQ = 64;          // chunk length
constexpr int kRowWarps = 4;    // warp w < 4: chunk rows 16w .. 16w + 15
constexpr int kThreads = 32 * 2 * kRowWarps;  // then 4 state warps
constexpr int kMaxN = 128;

// shared-memory layout of one block, in bytes; every region 16-byte
// aligned, the mirror of `launch_plan` in kernels/ssd_scan/ssd_scan.py
struct Layout {
  int NN;     // N rounded up to 64 (each warp's state columns: 2 x 16-wide)
  int bp;     // B/C/state row pitch: NN + 8 bf16 (odd x 16 bytes)
  int xp;     // x row pitch: PB + 8 bf16 (odd x 16 bytes)
  int b, c, x, dt, stage;  // one stage of a chunk: B, C, x rows and dt
  int st_hi, st_lo, cum, w, total;
  __host__ __device__ Layout(int PB, int N, int stages) {
    NN = (N + 63) / 64 * 64;
    bp = (NN + 8) * 2;
    xp = (PB + 8) * 2;
    b = 0;
    c = kQ * bp;
    x = 2 * kQ * bp;
    dt = x + kQ * xp;
    stage = dt + kQ * 4;
    st_hi = stages * stage;
    st_lo = st_hi + PB * bp;
    cum = st_lo + PB * bp;  // [kQ] doubles
    w = cum + kQ * 8;       // [kQ] floats: exp(total - cum_j) dt_j
    total = w + kQ * 4;
  }
};

// kQ rows of `staged` bytes at `pitch` from rows of `stride` bytes; row j
// (< n_rows) holds `valid` bytes of data, the rest of every row is zero.
// A thread's copies are chunks tid, tid + kThreads, ...: it steps (row,
// chunk) without dividing.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int pitch,
                                           const unsigned char* src,
                                           long long stride, int valid,
                                           int staged, int n_rows, int vb,
                                           int tid) {
  const int per = staged / vb;
  const int dj = kThreads / per, dc = kThreads - dj * per;
  for (int j = tid / per, c = tid % per; j < kQ;
       j += dj + (c + dc >= per), c = c + dc >= per ? c + dc - per : c + dc) {
    const int off = c * vb;
    const unsigned char* s = src;
    int n = 0;
    if (j < n_rows) {
      n = max(0, min(vb, valid - off));
      if (n) s = src + j * stride + off;
    }
    repro::cp_chunk(dst + j * pitch + off, s, n, vb);
  }
}

__device__ __forceinline__ uint32_t* at32(unsigned char* base, int row,
                                          int pitch, int col) {
  return reinterpret_cast<uint32_t*>(base + row * pitch + col * 2);
}

template <int PB, int NN>
__global__ void __launch_bounds__(kThreads) ssd_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ h0, __nv_bfloat16* __restrict__ y,
    float* __restrict__ hT, int S, int H, int P, int G, int N, int stages,
    int vb_bc, int vb_x) {
  constexpr int MT = PB / 16;  // 16-row tiles of the block's state rows
  constexpr int YT = PB / 8;   // 8-column tiles of the block's y columns
  constexpr int NK = NN / 16;  // k steps of 16 over N
  constexpr int NT = NN / 32;  // a state warp's 8-column tiles (2 or 4)
  extern __shared__ __align__(16) unsigned char smem_ssd[];
  const Layout L(PB, N, stages);
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gc = 2 * (lane & 3);
  const bool row_warp = warp < kRowWarps;
  const int nb = (warp - kRowWarps) * (NN / 4);  // a state warp's columns
  const float a_h = A[h];
  const float d_h = D ? D[h] : 0.f;
  unsigned char* st_hi = smem_ssd + L.st_hi;
  unsigned char* st_lo = smem_ssd + L.st_lo;
  double* cums = reinterpret_cast<double*>(smem_ssd + L.cum);
  float* ws = reinterpret_cast<float*>(smem_ssd + L.w);

  // a state warp's part of the state (rows p0 + 16 mt + gr (+8), columns
  // nb + 8 nt + gc (+1)), in the update mma's accumulator layout
  float st[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * mt + gr + 8 * (e >> 1);
        const int n = nb + 8 * nt + gc + (e & 1);
        st[mt][nt][e] =
            h0 && !row_warp && p < P && n < N
                ? h0[((static_cast<long long>(b) * H + h) * P + p) * N + n]
                : 0.f;
      }

  const int n_chunks = (S + kQ - 1) / kQ;
  const int x_valid = 2 * max(0, min(PB, P - p0));
  auto fetch = [&](int c0, int sb) {
    unsigned char* base = smem_ssd + sb * L.stage;
    const int len = min(kQ, S - c0);
    const long long r0 = static_cast<long long>(b) * S + c0;
    stage_rows(base + L.b, L.bp,
               reinterpret_cast<const unsigned char*>(Bm + (r0 * G + g) * N),
               2LL * G * N, 2 * N, 2 * NN, len, vb_bc, tid);
    stage_rows(base + L.c, L.bp,
               reinterpret_cast<const unsigned char*>(Cm + (r0 * G + g) * N),
               2LL * G * N, 2 * N, 2 * NN, len, vb_bc, tid);
    stage_rows(base + L.x, L.xp,
               reinterpret_cast<const unsigned char*>(
                   x + (r0 * H + h) * P + p0),
               2LL * H * P, x_valid, 2 * PB, len, vb_x, tid);
    if (tid < kQ)
      repro::cp_async4(base + L.dt + 4 * tid,
                       dt + (r0 + (tid < len ? tid : 0)) * H + h,
                       tid < len ? 4 : 0);
  };
  // the state as hi + lo bf16 rows [PB][NN], each state warp its columns
  auto write_state = [&]() {
    if (row_warp) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * mt + gr + 8 * hh, col = nb + 8 * nt + gc;
          uint32_t hi, lo;
          repro::pack_bf16_split(st[mt][nt][2 * hh], st[mt][nt][2 * hh + 1],
                                 hi, lo);
          *at32(st_hi, r, L.bp, col) = hi;
          *at32(st_lo, r, L.bp, col) = lo;
        }
  };

  if (n_chunks > 0) fetch(0, 0);
  repro::cp_async_commit();
  write_state();
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * kQ;
    const int len = min(kQ, S - c0);
    const int sb = stages == 2 ? (ci & 1) : 0;
    const bool next = ci + 1 < n_chunks;
    if (stages == 2 && next) {
      fetch(c0 + kQ, sb ^ 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's rows and the state copy landed
    unsigned char* base = smem_ssd + sb * L.stage;
    const unsigned char* Bs = base + L.b;
    const unsigned char* Cs = base + L.c;
    const unsigned char* Xs = base + L.x;
    const float* dts = reinterpret_cast<const float*>(base + L.dt);

    // ---- inclusive cumsum of A * dt in float64 (warp 0, two per lane),
    //      then w_j = exp(total - cum_j) dt_j
    if (warp == 0) {
      const double a0 = a_h * dts[2 * lane], a1 = a_h * dts[2 * lane + 1];
      double sum = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, sum, o);
        if (lane >= o) sum += v;
      }
      double prev = __shfl_up_sync(0xffffffffu, sum, 1);
      if (lane == 0) prev = 0.0;
      cums[2 * lane] = prev + a0;
      cums[2 * lane + 1] = prev + a0 + a1;
      __syncwarp();
      const double tot = cums[kQ - 1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * lane + e;
        ws[j] = expf(static_cast<float>(tot - cums[j])) * dts[j];
      }
    }
    __syncthreads();

    if (row_warp) {
      // ---- scores C.B^T (rows 16 warp .., keys up to the warp's last
      //      row) and C.state^T (state hi and lo in their own sums), one
      //      pass over N
      float sc[8][4], yv[YT][4], yl[YT][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
      for (int i = 0; i < YT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[i][e] = yl[i][e] = 0.f;
      const int bro = (lane & 7) + ((lane >> 4) & 1) * 8;  // B-fragment row
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        uint32_t a[4];
        repro::ldsm_x4(a, Cs + (16 * warp + (lane & 15)) * L.bp +
                              (ks * 16 + (lane >> 4) * 8) * 2);
        const int bco = (ks * 16 + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np <= warp) {  // causal: no keys past the warp's rows
            uint32_t bb[4];
            repro::ldsm_x4(bb, Bs + (np * 16 + bro) * L.bp + bco);
            repro::mma_bf16(sc[2 * np], a, bb[0], bb[1]);
            repro::mma_bf16(sc[2 * np + 1], a, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int pp = 0; pp < PB / 16; ++pp) {
          uint32_t bh[4], bl[4];
          repro::ldsm_x4(bh, st_hi + (pp * 16 + bro) * L.bp + bco);
          repro::ldsm_x4(bl, st_lo + (pp * 16 + bro) * L.bp + bco);
          repro::mma_bf16(yv[2 * pp], a, bh[0], bh[1]);
          repro::mma_bf16(yl[2 * pp], a, bl[0], bl[1]);
          repro::mma_bf16(yv[2 * pp + 1], a, bh[2], bh[3]);
          repro::mma_bf16(yl[2 * pp + 1], a, bl[2], bl[3]);
        }
      }
      // ---- decay and mask the scores; the inter term times exp(cum_i)
      const int i0 = 16 * warp + gr;
      const double cum0 = cums[i0], cum1 = cums[i0 + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * (e >> 1);
          const int j = 8 * nt + gc + (e & 1);
          sc[nt][e] = j <= i ? sc[nt][e] *
                                   expf(static_cast<float>(
                                       (e < 2 ? cum0 : cum1) - cums[j])) *
                                   dts[j]
                             : 0.f;
        }
      }
      const float ec0 = expf(static_cast<float>(cum0));
      const float ec1 = expf(static_cast<float>(cum1));
#pragma unroll
      for (int t = 0; t < YT; ++t) {
        yv[t][0] = ec0 * (yv[t][0] + yl[t][0]);
        yv[t][1] = ec0 * (yv[t][1] + yl[t][1]);
        yv[t][2] = ec1 * (yv[t][2] + yl[t][2]);
        yv[t][3] = ec1 * (yv[t][3] + yl[t][3]);
        yl[t][0] = yl[t][1] = yl[t][2] = yl[t][3] = 0.f;
      }
      // ---- y += S x: S's accumulators are the A fragments (16 keys a
      //      step), as a bf16 hi + lo pair; x transposed by ldmatrix
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp) continue;
        uint32_t ah[4], al[4];
        repro::pack_bf16_split(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
        repro::pack_bf16_split(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
        repro::pack_bf16_split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2],
                               al[2]);
        repro::pack_bf16_split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3],
                               al[3]);
#pragma unroll
        for (int pp = 0; pp < PB / 16; ++pp) {
          uint32_t bb[4];
          repro::ldsm_x4_t(bb, Xs + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * L.xp +
                                   (pp * 16 + (lane >> 4) * 8) * 2);
          repro::mma_bf16(yv[2 * pp], ah, bb[0], bb[1]);
          repro::mma_bf16(yl[2 * pp], al, bb[0], bb[1]);
          repro::mma_bf16(yv[2 * pp + 1], ah, bb[2], bb[3]);
          repro::mma_bf16(yl[2 * pp + 1], al, bb[2], bb[3]);
        }
      }
      // ---- y = . + D x, rows past S and columns past P dropped
#pragma unroll
      for (int t = 0; t < YT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + 8 * (e >> 1);
          const int p = 8 * t + gc + (e & 1);
          if (i < len && p0 + p < P) {
            const float xv = __bfloat162float(
                *reinterpret_cast<const __nv_bfloat16*>(Xs + i * L.xp +
                                                         2 * p));
            y[((static_cast<long long>(b) * S + c0 + i) * H + h) * P + p0 +
              p] = __float2bfloat16_rn(yv[t][e] + yl[t][e] + d_h * xv);
          }
        }
    } else {
      // ---- state = exp(total) state + (w x)^T B over the warp's
      //      columns: A = (w_j x_j)^T from x transposed by ldmatrix, as
      //      hi + lo; runs beside the row warps' y of the same chunk
      const float et = expf(static_cast<float>(cums[kQ - 1]));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[mt][nt][e] *= et;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (16 * kk >= len) continue;  // rows past S add zero
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t r[4];
          repro::ldsm_x4_t(r, Xs + (kk * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       L.xp +
                                   (mt * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 16 * kk + gc + 8 * (q >> 1);
            const __nv_bfloat162 v =
                *reinterpret_cast<const __nv_bfloat162*>(&r[q]);
            repro::pack_bf16_split(__low2float(v) * ws[j],
                                   __high2float(v) * ws[j + 1], ah[mt][q],
                                   al[mt][q]);
          }
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          repro::ldsm_x4_t(bb, Bs + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * L.bp +
                                   (nb + np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            repro::mma_bf16(st[mt][2 * np], ah[mt], bb[0], bb[1]);
            repro::mma_bf16(st[mt][2 * np], al[mt], bb[0], bb[1]);
            repro::mma_bf16(st[mt][2 * np + 1], ah[mt], bb[2], bb[3]);
            repro::mma_bf16(st[mt][2 * np + 1], al[mt], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and the state copy
    write_state();
    if (stages == 1 && next) {
      fetch(c0 + kQ, 0);
      repro::cp_async_commit();
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * mt + gr + 8 * (e >> 1);
        const int n = nb + 8 * nt + gc + (e & 1);
        if (!row_warp && p < P && n < N)
          hT[((static_cast<long long>(b) * H + h) * P + p) * N + n] =
              st[mt][nt][e];
      }
}

}  // namespace tc

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *D, *h0;
  void *y, *hT;
  int Bz, S, H, P, G, N, pb, stages, vb_bc, vb_x;
  long long smem;
  cudaStream_t stream;
};

template <typename T>
int launch_fma(const Args& a) {
  const size_t smem = fma::layout(a.P, a.N).total * sizeof(float);
  if (static_cast<long long>(smem) != a.smem)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fma::ssd_fma_kernel<T>;
  const cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.H, a.Bz), fma::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const T*>(a.Cm), static_cast<const float*>(a.D),
      static_cast<const float*>(a.h0), static_cast<T*>(a.y),
      static_cast<float*>(a.hT), a.S, a.H, a.P, a.G, a.N);
  return static_cast<int>(cudaGetLastError());
}

template <int PB, int NN>
int launch_mma(const Args& a) {
  const tc::Layout L(PB, a.N, a.stages);
  if (L.total != a.smem || L.NN != NN)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tc::ssd_mma_kernel<PB, NN>;
  const cudaError_t err = repro::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  kernel<<<dim3((a.P + PB - 1) / PB, a.H, a.Bz), tc::kThreads, L.total,
           a.stream>>>(
      static_cast<const bf*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const bf*>(a.Bm),
      static_cast<const bf*>(a.Cm), static_cast<const float*>(a.D),
      static_cast<const float*>(a.h0), static_cast<bf*>(a.y),
      static_cast<float*>(a.hT), a.S, a.H, a.P, a.G, a.N, a.stages, a.vb_bc,
      a.vb_x);
  return static_cast<int>(cudaGetLastError());
}

template <int PB>
int launch_mma_n(const Args& a) {
  return a.N <= 64 ? launch_mma<PB, 64>(a) : launch_mma<PB, 128>(a);
}

}  // namespace

// x (Bz,S,H,P), B/C (Bz,S,G,N) and y (Bz,S,H,P) of dtype code `dtype`
// (csrc/common.cuh); dt (Bz,S,H), A (H), D (H) or null, h0 (Bz,H,P,N) or
// null, hT (Bz,H,P,N) float32; all contiguous on the device. The launch
// plan (`launch_plan` in kernels/ssd_scan/ssd_scan.py): `pb` 0 for the FMA
// body, else the tensor-core body's P columns per block (16, 32 or 64;
// bf16, N <= 128) with `stages` (1 or 2) chunk buffers and cp.async
// widths vb_bc (B/C rows) and vb_x (x rows): 16, 4 or 1 (synchronous);
// `smem` the plan's dynamic shared-memory bytes, checked against the
// body's own layout. Returns cudaGetLastError() of the launch
// (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int repro_ssd_fwd(int dtype, const void* x, const void* dt,
                             const void* A, const void* Bm, const void* Cm,
                             const void* D, const void* h0, void* y,
                             void* hT, int Bz, int S, int H, int P, int G,
                             int N, int pb, int stages, int vb_bc, int vb_x,
                             long long smem, void* stream) {
  if (Bz == 0 || H == 0) return 0;
  const Args a{x,  dt, A,  Bm, Cm,     D,      h0,    y,    hT,
               Bz, S,  H,  P,  G,      N,      pb,    stages, vb_bc,
               vb_x, smem, static_cast<cudaStream_t>(stream)};
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (pb == 0) {
    if (dtype == repro::kF32) return launch_fma<float>(a);
    if (dtype == repro::kBF16) return launch_fma<__nv_bfloat16>(a);
    return bad;
  }
  auto width_ok = [](int v) { return v == 16 || v == 4 || v == 1; };
  if (dtype != repro::kBF16 || N > tc::kMaxN || !width_ok(vb_bc) ||
      !width_ok(vb_x) || (stages != 1 && stages != 2))
    return bad;
  switch (pb) {
    case 16: return launch_mma_n<16>(a);
    case 32: return launch_mma_n<32>(a);
    case 64: return launch_mma_n<64>(a);
    default: return bad;
  }
}
