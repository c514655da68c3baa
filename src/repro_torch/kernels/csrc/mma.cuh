// Warp-level tensor-core and asynchronous-copy primitives (sm_80+, built
// for sm_90a): bf16 mma.sync m16n8k16 with f32 accumulation, int8
// mma.sync m16n8k32 with int32 accumulation, ldmatrix
// fragment loads from shared memory, and cp.async global -> shared copies
// with zero fill.
//
// Fragment layouts of mma.m16n8k16 (lane = threadIdx.x % 32, gr = lane / 4,
// gc = 2 * (lane % 4)):
//   A (16x16, row major), 4 registers of 2 bf16: a0 (gr, gc..gc+1),
//     a1 (gr+8, gc..), a2 (gr, gc+8..), a3 (gr+8, gc+8..)
//   B (16x8, k x n), 2 registers: b0 (k = gc..gc+1, n = gr),
//     b1 (k = gc+8.., n = gr)
//   C/D (16x8 f32), 4 floats: c0, c1 (gr, gc..gc+1), c2, c3 (gr+8, gc..)
// The low half of a packed register holds the lower column (or k) index.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats -> one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats as a bf16 pair (hi) and the bf16 pair of what hi missed
// (lo): hi + lo carries about 16 significant bits of each value
__device__ __forceinline__ void pack_bf16_split(float lo_col, float hi_col,
                                                uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(lo_col - __low2float(h), hi_col - __high2float(h));
}

// d += a * b, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, int8 inputs, int32 accumulators (exact in any order).
// m16n8k32 fragments (gr = lane / 4, t = lane % 4): A (16x32, row
// major) a0 (row gr, k 4t..4t+3), a1 (gr+8, 4t..), a2 (gr, 16+4t..), a3
// (gr+8, 16+4t..), the lowest k in the lowest byte; B (32x8, k x n) b0
// (k 4t..4t+3, n gr), b1 (k 16+4t.., n gr); C/D as the f32 layout above
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives its (row gr, columns gc..gc+1)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same, transposed: register i receives (rows gc..gc+1, column gr)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// copy n of `bytes` bytes (n <= bytes; the rest of dst is zero-filled);
// src and dst aligned to `bytes`, src a valid global address even when
// n == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}
// one chunk of a staged row: vb = 16 or 4 is a cp.async of that width
// (the first n bytes copied, the rest zero-filled), 1 a synchronous byte
__device__ __forceinline__ void cp_chunk(void* dst, const void* src, int n,
                                         int vb) {
  if (vb == 16)
    cp_async16(dst, src, n);
  else if (vb == 4)
    cp_async4(dst, src, n);
  else
    *static_cast<unsigned char*>(dst) =
        n ? *static_cast<const unsigned char*>(src) : 0;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace repro
