// Page writer: land whole page tiles in the physical KV page pool in place.
//
// Replaces: src/repro/kernels/page_io/page_io.py `write_pages_pallas`
// (aliased Pallas page writer of the bucket prefill insert).
//
// Bound: bytes. It reads each tile once and writes it once; there is no
// arithmetic. On the H100 the least time is 2 * nb * n_wp * M bytes over
// 3.35 TB/s.
//
// Design: one block per (chunk of a page's M bytes, written page, stack
// level) — the grid is the copy, there is no sequential axis. Each thread
// moves 16 bytes per load/store when the page rows are 16-byte aligned
// (int8 payload pages and f32 (scale, zero) rows of the serving pools
// are), with a byte loop for an unaligned page or a ragged tail. The pool
// is written in place, so nothing needs aliasing; physical page ids are
// unique by the pager's contract, so no two blocks write one page. An id
// outside [0, P) is dropped rather than written, so a bad table entry can
// never write out of bounds. The kernel allocates nothing and does not
// synchronise.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = kThreads * 16;  // bytes one block copies

__global__ void __launch_bounds__(kThreads)
    write_pages_kernel(char* __restrict__ pool, const char* __restrict__ tiles,
                       const int* __restrict__ phys, long long P,
                       long long n_wp, long long M) {
  const long long j = blockIdx.y;  // written page
  const long long i = blockIdx.z;  // stack level
  const int p = phys[j];
  if (p < 0 || p >= P) return;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long n = (M - c0 < kChunk) ? M - c0 : kChunk;
  char* dst = pool + (i * P + p) * M + c0;
  const char* src = tiles + (i * n_wp + j) * M + c0;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const long long nv = n / 16;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (long long v = threadIdx.x; v < nv; v += kThreads) d4[v] = s4[v];
    done = nv * 16;
  }
  for (long long b = done + threadIdx.x; b < n; b += kThreads) dst[b] = src[b];
}

}  // namespace

// pool (nb, P, M bytes) and tiles (nb, n_wp, M bytes) contiguous, phys
// (n_wp,) int32 on the device. Returns cudaGetLastError() of the launch.
extern "C" int repro_write_pages(void* pool, const void* tiles,
                                 const void* phys, long long nb, long long P,
                                 long long n_wp, long long M, void* stream) {
  if (nb == 0 || n_wp == 0 || M == 0) return 0;
  dim3 grid(static_cast<unsigned>((M + kChunk - 1) / kChunk),
            static_cast<unsigned>(n_wp), static_cast<unsigned>(nb));
  write_pages_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pool), static_cast<const char*>(tiles),
      static_cast<const int*>(phys), P, n_wp, M);
  return static_cast<int>(cudaGetLastError());
}
