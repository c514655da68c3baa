// W8A8 int8 matmul: int8 (M, K) @ int8 (K, N) -> int32, then the float32
// dequant epilogue float(acc) * sa[m] * sb[n].
//
// Replaces: src/repro/kernels/matmul_w8a8/matmul_w8a8.py
// `matmul_w8a8_pallas` (128 x 128 output blocks on the MXU, an int32 VMEM
// accumulator carried over the sequential K grid axis, the dequant on the
// last K step; its wrapper zero-pads ragged shapes to block multiples).
//
// Bound: operations for large M (2 * M * N * K int8 ops over 1979e12
// op/s on the tensor cores), bytes for decode-like M (M * K + K * N
// operand bytes, 4 * (M + N) of scales and 4 * M * N of float32 output
// over 3.35e12 B/s).
//
// Design (a first, simple kernel: right before fast). One block per 64 x
// 64 output tile, 256 threads, each owning a 4 x 4 micro-tile of int32
// accumulators in registers; the K loop inside the block takes the place
// of the sequential grid axis. Each step stages a 64 x 64 A tile (rows of
// K) and a 64 x 64 B tile TRANSPOSED (columns of K, packed with
// __byte_perm from four rows) in shared memory as 32-bit words of four
// consecutive k, so one __dp4a multiplies four int8 pairs and adds them
// to the int32 accumulator, exactly. Rows are padded to 17 words so that
// the 16 columns a warp reads sit on distinct banks. Ragged M, N and K
// are zero-filled on load and masked on store (zero rows and columns
// contract to zero), so the wrapper pads nothing. The epilogue multiplies
// in the reference's order with __fmul_rn, which no FMA can merge: the
// result equals the plain version's bit for bit. Next: int8 tensor cores
// (mma.sync m16n8k32 or wgmma) with cp.async/TMA staging.

#include "common.cuh"

namespace {

constexpr int kTile = 64;          // M, N and K extent of one tile
constexpr int kWords = kTile / 4;  // 32-bit words of k per tile row
constexpr int kPitch = kWords + 1;
constexpr int kThreads = 256;

// four bytes k..k+3 of row r of a (rows, cols) int8 matrix, zero outside;
// `vec`: cols % 4 == 0 and the base 4-byte aligned, so a word load is
// aligned wherever k % 4 == 0
__device__ __forceinline__ int load_word(const int8_t* __restrict__ x,
                                         int rows, int cols, int r, int k,
                                         bool vec) {
  if (r >= rows || k >= cols) return 0;
  const int8_t* p = x + static_cast<long long>(r) * cols + k;
  if (vec) return *reinterpret_cast<const int*>(p);
  int w = 0;
  for (int b = 0; b < 4 && k + b < cols; ++b)
    w |= static_cast<int>(static_cast<uint8_t>(p[b])) << (8 * b);
  return w;
}

__global__ void __launch_bounds__(kThreads)
    matmul_w8a8_kernel(const int8_t* __restrict__ a,
                       const int8_t* __restrict__ b,
                       const float* __restrict__ sa,
                       const float* __restrict__ sb, float* __restrict__ out,
                       int M, int N, int K, bool a_vec, bool b_vec) {
  __shared__ int As[kTile][kPitch];  // As[m][kw]: a[m0+m][k0+4kw .. +3]
  __shared__ int Bs[kTile][kPitch];  // Bs[n][kw]: b[k0+4kw .. +3][n0+n]
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kTile) {
    // A: thread t loads row t / 4, words 4 * (t % 4) .. + 3
    {
      const int r = t / 4, w0 = 4 * (t % 4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        As[r][w0 + j] = load_word(a, M, K, m0 + r, k0 + 4 * (w0 + j), a_vec);
    }
    // B: thread t loads rows k0 + 4 * kq .. + 3 at columns n0 + 4 * nq ..
    // + 3 and transposes the 4 x 4 bytes into one word per column
    {
      const int kq = t % 16, nq = t / 16;
      const int k = k0 + 4 * kq, n = n0 + 4 * nq;
      const int r0 = load_word(b, K, N, k, n, b_vec);
      const int r1 = load_word(b, K, N, k + 1, n, b_vec);
      const int r2 = load_word(b, K, N, k + 2, n, b_vec);
      const int r3 = load_word(b, K, N, k + 3, n, b_vec);
      const int t0 = __byte_perm(r0, r1, 0x5140);  // r0c0 r1c0 r0c1 r1c1
      const int t1 = __byte_perm(r2, r3, 0x5140);  // r2c0 r3c0 r2c1 r3c1
      const int t2 = __byte_perm(r0, r1, 0x7362);  // r0c2 r1c2 r0c3 r1c3
      const int t3 = __byte_perm(r2, r3, 0x7362);
      Bs[4 * nq + 0][kq] = __byte_perm(t0, t1, 0x5410);
      Bs[4 * nq + 1][kq] = __byte_perm(t0, t1, 0x7632);
      Bs[4 * nq + 2][kq] = __byte_perm(t2, t3, 0x5410);
      Bs[4 * nq + 3][kq] = __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < kWords; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float s = sa[m];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N)
        out[static_cast<long long>(m) * N + n] =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), s), sb[n]);
    }
  }
}

}  // namespace

// a (M, K) and b (K, N) int8, sa (M,) and sb (N,) float32, out (M, N)
// float32, all contiguous on the device. Returns cudaGetLastError() of the
// launch.
extern "C" int repro_matmul_w8a8(const void* a, const void* b, const void* sa,
                                 const void* sb, void* out, int M, int N,
                                 int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  const bool a_vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 3) == 0;
  const bool b_vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(b) & 3) == 0;
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  matmul_w8a8_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<float*>(out), M, N, K, a_vec, b_vec);
  return static_cast<int>(cudaGetLastError());
}
