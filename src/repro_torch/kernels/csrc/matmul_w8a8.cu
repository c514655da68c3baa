// W8A8 int8 matmul: int8 (M, K) @ int8 (K, N) -> int32, then the float32
// dequant epilogue float(acc) * sa[m] * sb[n].
//
// Replaces: src/repro/kernels/matmul_w8a8/matmul_w8a8.py
// `matmul_w8a8_pallas` (128 x 128 output blocks on the MXU, an int32 VMEM
// accumulator carried over the sequential K grid axis, the dequant on the
// last K step; its wrapper zero-pads ragged shapes to block multiples).
//
// Bound: bytes at the serving shapes (M * K + K * N operand bytes, 4 * (M
// + N) of scales and 4 * M * N of float32 output over 3.35e12 B/s: 14 MB,
// 4.2 us at M=1024, K=960, N=2560, three quarters of it the output);
// operations (2 * M * N * K over 1979e12 op/s on the int8 tensor cores)
// only for K in the thousands. The first design ran __dp4a on the CUDA
// cores at 20x the byte bound.
//
// Design: int8 mma.sync m16n8k32 (s8 x s8 -> s32, exact in any order)
// fed by ldmatrix. A block of 8 warps (2 x 4) computes a BM x BN output
// tile (128 x 128, or 64 x 128 / 32 x 64 where the big tile leaves SMs
// idle; `launch_plan` in kernels/matmul_w8a8/matmul_w8a8.py), each warp a
// (BM / 2) x (BN / 4) piece in int32 registers; a loop over K tiles of 64
// takes the place of the sequential grid axis.
// - Staging: a four-stage cp.async ring of the A tile (rows of K) and the
//   B tile (rows of N, as they arrive), both zero-filled past M, N and K,
//   so the wrapper pads nothing (16-byte copies where rows and bases
//   allow, else 4, else synchronous bytes). Row pitches are odd
//   multiples of 16 bytes, so ldmatrix's eight rows meet eight bank
//   groups.
// - B arrives (K, N) row major, but the mma takes each thread's four k
//   of one column n in a register, and ldmatrix .trans moves 16-bit
//   elements, i.e. pairs of columns. So the B tile's rows are staged in
//   a permuted k order (within 16 rows: k 0,1,4,5,8,9,12,13 then
//   2,3,6,7,10,11,14,15): one ldmatrix .x4 .trans then hands lane (gr,
//   t) the bytes (k 4t, 4t+1) and (k 4t+2, 4t+3) of columns 2c and 2c+1
//   (c = the tile's column pair gr), and two byte permutes make the two
//   B fragments of an "even" and an "odd" 8-column mma tile. No
//   transpose pass, no second barrier per K tile.
// - Epilogue in the reference's order with __fmul_rn, which no FMA can
//   merge: the result equals the plain version's bit for bit. The even
//   and odd tiles interleave their columns, so each lane holds four
//   consecutive floats of two rows and writes each as one 16-byte store.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBK = 64;        // K bytes per tile
constexpr int kStages = 4;     // K tiles in the cp.async ring
constexpr int kWarps = 8;      // 2 (M) x 4 (N)
constexpr int kThreads = 32 * kWarps;
constexpr int kAPitch = 80;    // A row: 64 bytes of K + 16

// shared-memory layout of one block, in bytes (the Python plan mirrors it)
struct Layout {
  int bp, a, b, total;
  __host__ __device__ Layout(int BM, int BN) {
    bp = BN + 16;                 // B row pitch: BN bytes + 16
    a = 0;                        // [stage][BM][kAPitch]
    b = kStages * BM * kAPitch;   // [stage][kBK][bp], rows in b_row order
    total = b + kStages * kBK * bp;
  }
};

// the staged row of B's k-th row within a K tile: within each 16 rows,
// k = 4q + 2h + l (h, l in {0, 1}) sits at row 2q + l + 8h
__device__ __forceinline__ int b_row(int k) {
  return (k & ~15) + ((k >> 2) & 3) * 2 + (k & 1) + ((k >> 1) & 1) * 8;
}

template <int WM, int WN>
__global__ void __launch_bounds__(kThreads)
    matmul_w8a8_mma_kernel(const int8_t* __restrict__ a,
                           const int8_t* __restrict__ b,
                           const float* __restrict__ sa,
                           const float* __restrict__ sb,
                           float* __restrict__ out, int M, int N, int K,
                           int vb_a, int vb_b, bool out_vec) {
  constexpr int BM = 32 * WM, BN = 32 * WN;
  extern __shared__ __align__(16) unsigned char smem_mm[];
  const Layout L(BM, BN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int gr = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_kt = (K + kBK - 1) / kBK;

  // copies of vb bytes: log2 of the copies per row, for shifts
  const int lg_a = vb_a == 16 ? 4 : vb_a == 4 ? 2 : 0;
  const int lg_b = vb_b == 16 ? 4 : vb_b == 4 ? 2 : 0;
  const int a_sh = 6 - lg_a;                        // kBK = 64 bytes
  const int b_sh = (BN == 128 ? 7 : 6) - lg_b;      // BN bytes
  auto fetch = [&](int kt, int sb_) {
    const int k0 = kt * kBK;
    const int kv = min(kBK, K - k0);
    // A: BM rows of kBK bytes
    unsigned char* As = smem_mm + L.a + sb_ * BM * kAPitch;
    for (int idx = tid; idx < BM << a_sh; idx += kThreads) {
      const int r = idx >> a_sh, off = (idx & ((1 << a_sh) - 1)) << lg_a;
      const int n = m0 + r < M ? max(0, min(vb_a, kv - off)) : 0;
      const int8_t* src =
          n ? a + static_cast<long long>(m0 + r) * K + k0 + off : a;
      repro::cp_chunk(As + r * kAPitch + off, src, n, vb_a);
    }
    // B: kBK rows of BN bytes, in b_row order
    unsigned char* Bs = smem_mm + L.b + sb_ * kBK * L.bp;
    const int nv = N - n0;
    for (int idx = tid; idx < kBK << b_sh; idx += kThreads) {
      const int r = idx >> b_sh, off = (idx & ((1 << b_sh) - 1)) << lg_b;
      const int n = r < kv ? max(0, min(vb_b, nv - off)) : 0;
      const int8_t* src =
          n ? b + static_cast<long long>(k0 + r) * N + n0 + off : b;
      repro::cp_chunk(Bs + b_row(r) * L.bp + off, src, n, vb_b);
    }
  };

  // acc[i][2 jp] and acc[i][2 jp + 1]: the even and odd columns of the
  // warp's 16 columns wn * 8 WN + 16 jp ..
  int acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the ring: tiles kt + 1 .. kt + kStages - 1 in flight while tile kt
  // computes; one commit group per tile (empty past the last)
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_kt) fetch(t, t);
    repro::cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int sbuf = kt % kStages;
    repro::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + kStages - 1 < n_kt)
      fetch(kt + kStages - 1, (kt + kStages - 1) % kStages);
    repro::cp_async_commit();
    const unsigned char* As = smem_mm + L.a + sbuf * BM * kAPitch;
    const unsigned char* Bs = smem_mm + L.b + sbuf * kBK * L.bp;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[WM][4];
#pragma unroll
      for (int i = 0; i < WM; ++i)
        repro::ldsm_x4(af[i], As + (wm * 16 * WM + i * 16 + (lane & 15)) *
                                       kAPitch +
                                   ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int jp = 0; jp < WN / 2; ++jp) {
        // staged rows ks * 32 + lane: matrices (k 0-15 of the step: rows
        // 0-7, 8-15; k 16-31: rows 16-23, 24-31) x the 16 columns
        uint32_t r[4];
        repro::ldsm_x4_t(r, Bs + (ks * 32 + lane) * L.bp + wn * 8 * WN +
                                jp * 16);
        const uint32_t b0e = __byte_perm(r[0], r[1], 0x6420);
        const uint32_t b0o = __byte_perm(r[0], r[1], 0x7531);
        const uint32_t b1e = __byte_perm(r[2], r[3], 0x6420);
        const uint32_t b1o = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
        for (int i = 0; i < WM; ++i) {
          repro::mma_s8(acc[i][2 * jp], af[i], b0e, b1e);
          repro::mma_s8(acc[i][2 * jp + 1], af[i], b0o, b1o);
        }
      }
    }
    // the next iteration's first barrier orders these reads before this
    // stage's buffers are written again
  }

  // ---- epilogue: lane (gr, t4) holds columns 4 t4 .. 4 t4 + 3 of the
  //      16 (even tile: 4 t4, 4 t4 + 2; odd: 4 t4 + 1, 4 t4 + 3) in rows
  //      gr and gr + 8
#pragma unroll
  for (int i = 0; i < WM; ++i) {
#pragma unroll
    for (int jp = 0; jp < WN / 2; ++jp) {
      const int nc = n0 + wn * 8 * WN + jp * 16 + 4 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * 16 * WM + i * 16 + gr + 8 * hh;
        if (m >= M) continue;
        float f[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int n = nc + c;
          const int v = acc[i][2 * jp + (c & 1)][2 * hh + (c >> 1)];
          f[c] = n < N ? __fmul_rn(__fmul_rn(__int2float_rn(v), sa[m]),
                                   sb[n])
                       : 0.f;
        }
        float* o = out + static_cast<long long>(m) * N + nc;
        if (out_vec && nc + 3 < N) {
          *reinterpret_cast<float4*>(o) = make_float4(f[0], f[1], f[2], f[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (nc + c < N) o[c] = f[c];
        }
      }
    }
  }
}

template <int WM, int WN>
int launch(const int8_t* a, const int8_t* b, const float* sa,
           const float* sb, float* out, int M, int N, int K, int vb_a,
           int vb_b, bool out_vec, long long smem, cudaStream_t stream) {
  constexpr int BM = 32 * WM, BN = 32 * WN;
  const Layout L(BM, BN);
  if (L.total != smem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = matmul_w8a8_mma_kernel<WM, WN>;
  const cudaError_t err = repro::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, L.total, stream>>>(a, b, sa, sb, out, M, N, K,
                                              vb_a, vb_b, out_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) and b (K, N) int8, sa (M,) and sb (N,) float32, out (M, N)
// float32, all contiguous on the device. The launch plan (`launch_plan`
// in kernels/matmul_w8a8/matmul_w8a8.py): block tile bm x bn (128 x 128,
// 64 x 128 or 32 x 64), cp.async widths vb_a (A rows) and vb_b (B rows):
// 16, 4 or 1 (synchronous); `smem` the plan's dynamic shared-memory
// bytes, checked against the kernel's own layout. Returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for a plan the
// kernel does not take).
extern "C" int repro_matmul_w8a8(const void* a, const void* b, const void* sa,
                                 const void* sb, void* out, int M, int N,
                                 int K, int bm, int bn, int vb_a, int vb_b,
                                 long long smem, void* stream) {
  if (M == 0 || N == 0) return 0;
  auto width_ok = [](int v) { return v == 16 || v == 4 || v == 1; };
  if (!width_ok(vb_a) || !width_ok(vb_b))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool out_vec =
      N % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* fa = static_cast<const float*>(sa);
  const auto* fb = static_cast<const float*>(sb);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128)
    return launch<4, 4>(a8, b8, fa, fb, o, M, N, K, vb_a, vb_b, out_vec,
                        smem, s);
  if (bm == 64 && bn == 128)
    return launch<2, 4>(a8, b8, fa, fb, o, M, N, K, vb_a, vb_b, out_vec,
                        smem, s);
  if (bm == 32 && bn == 64)
    return launch<1, 2>(a8, b8, fa, fb, o, M, N, K, vb_a, vb_b, out_vec,
                        smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
