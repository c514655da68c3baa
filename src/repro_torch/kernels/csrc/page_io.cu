// Grouped page copy: move whole pages between page pools, tiles and the
// pinned host twin of the pool, several leaves in one launch.
//
// Replaces: src/repro/kernels/page_io/page_io.py `write_pages_pallas`
// (aliased Pallas page writer of the bucket prefill insert). The same
// body carries the substrate's page_out / page_in streams
// (src/repro/serving/substrate/tier_substrate.py `page_out` / `page_in`,
// jitted gathers and scatters there), whose one end is pinned host memory
// reached through its mapped device pointer, and the fleet's handoff copy
// between two engines' pools (src/repro/serving/fleet/roles.py
// `copy_pages`), where both ends are device memory and both id vectors
// are given.
//
// A launch takes up to kMaxSegs segments by value (`__grid_constant__`,
// no host-to-device copy). Segment s copies, for every level i < nb and
// page j < n,
//     dst[i, dst_ids ? dst_ids[j] : j, :M] = src[i, src_ids ? src_ids[j] : j, :M]
// (M bytes per page; dst has P_dst pages a level, src P_src). An id
// outside [0, P) drops the page: nothing is read or written for it, so a
// bad table entry can never write out of bounds. Destination ids are
// unique by the pager's contract, so no two work items write one page.
//
// Bound: bytes. Each page is read once and written once; there is no
// arithmetic. At the bucket insert's shape (SmolLM-360M: 32 levels, 8
// pages of 5120 B payload and 40 B (scale, zero) rows, k and v) that is
// 5.28 MB, 1.58 us at 3.35 TB/s: the copy is one DRAM round trip plus the
// launch, so the design is about bytes in flight, not bandwidth.
//
// Grid (x, segment): block (x, y) walks tiles x, x + gridDim.x, ... of
// segment y, each of kThreads * kUnroll vectors; the grid fills the SMs
// once. A block reads its segment's fields with one uniform parameter
// lookup (no search over segments: each dependent lookup is a
// constant-cache round trip before the first load can go out), and a
// vector's page and offset come from multiply-shift divisions the
// planner precomputes. A thread issues its kUnroll loads before any
// store, so 64 B a thread are in flight. The vector width follows each
// segment's alignment (16 B for payload pages, 8 B for the 40-byte
// (scale, zero) rows, down to 1 B only for a row whose size or base
// needs it); every row is a whole number of vectors, so there is no tail
// loop. The segment's page ids are staged in shared memory once per
// block; the first tile's loads are issued before that barrier when they
// need no ids. (Whole-page TMA bulk copies, one thread per page, measured
// slower at the bucket insert's shape: PERF.md.)
// The kernel allocates nothing and does not synchronise.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxSegs = 32;  // segments one launch takes by value
constexpr int kIdCap = 4096;  // page ids a block stages in shared memory

// descriptor layout shared with `page_io.py` (int64 words)
constexpr int kHeader = 4;
constexpr int kSegFields = 17;

// q = v / d for v < 2^31, as (v * mul) >> shift (`page_io._magic`)
struct Div {
  unsigned d, mul;
  int shift;
};

__device__ __forceinline__ unsigned div_by(unsigned v, const Div& x) {
  return static_cast<unsigned>((static_cast<unsigned long long>(v) * x.mul) >>
                               x.shift);
}

struct Seg {
  char* dst;
  const char* src;
  const int* dst_ids;  // null: page j
  const int* src_ids;
  unsigned P_dst, P_src, M;   // pages a level, bytes a page (the
                              // planner keeps nb * P and M under 2^31)
  unsigned n_vec;             // nb * n * M / vec (< 2^31)
  unsigned n_tiles;           // tiles of kThreads * kUnroll vectors
  Div per_page;               // vectors a page
  Div n;                      // pages a level
  int vec;                    // bytes a vector
  int stage;                  // ids staged in shared memory (2n <= kIdCap)
};

struct Group {
  Seg seg[kMaxSegs];
  int n_seg;
};

__device__ __forceinline__ int page_id(const Seg& s, const int* s_ids,
                                       const int* ids, unsigned j,
                                       unsigned at) {
  return s.stage ? s_ids[at + j] : __ldg(ids + j);
}

// a W-byte vector in the low bytes of a uint4 register (no local memory)
template <int W>
__device__ __forceinline__ uint4 ld(const char* p);
template <>
__device__ __forceinline__ uint4 ld<16>(const char* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <>
__device__ __forceinline__ uint4 ld<8>(const char* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  return make_uint4(x.x, x.y, 0u, 0u);
}
template <>
__device__ __forceinline__ uint4 ld<4>(const char* p) {
  return make_uint4(*reinterpret_cast<const unsigned*>(p), 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ uint4 ld<2>(const char* p) {
  return make_uint4(*reinterpret_cast<const unsigned short*>(p), 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ uint4 ld<1>(const char* p) {
  return make_uint4(*reinterpret_cast<const unsigned char*>(p), 0u, 0u, 0u);
}

template <int W>
__device__ __forceinline__ void st(char* p, uint4 v);
template <>
__device__ __forceinline__ void st<16>(char* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}
template <>
__device__ __forceinline__ void st<8>(char* p, uint4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y);
}
template <>
__device__ __forceinline__ void st<4>(char* p, uint4 v) {
  *reinterpret_cast<unsigned*>(p) = v.x;
}
template <>
__device__ __forceinline__ void st<2>(char* p, uint4 v) {
  *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(v.x);
}
template <>
__device__ __forceinline__ void st<1>(char* p, uint4 v) {
  *reinterpret_cast<unsigned char*>(p) = static_cast<unsigned char>(v.x);
}

// where this thread's vectors of a tile lie: level, page j and vector
// within the page
struct Where {
  unsigned lev[kUnroll], j[kUnroll], off[kUnroll];
  bool live[kUnroll];
};

// byte offset of page p of level lev: one 32 x 32 -> 64-bit multiply
__device__ __forceinline__ unsigned long long row_offset(unsigned lev,
                                                         unsigned p,
                                                         unsigned P,
                                                         const Seg& s) {
  return static_cast<unsigned long long>(lev * P + p) * s.M;
}

// the kUnroll vectors of `tile` this thread owns: v = base + u * kThreads
// + tid, neighbouring threads on neighbouring vectors. All loads go out
// before any store.
template <int W>
__device__ __forceinline__ void load_tile(const Seg& s, unsigned tile,
                                          const int* s_ids,
                                          uint4 (&buf)[kUnroll], Where& w) {
  const unsigned base = tile * (kThreads * kUnroll) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned v = base + u * kThreads;
    const unsigned row = div_by(v, s.per_page);
    w.off[u] = v - row * s.per_page.d;
    w.lev[u] = div_by(row, s.n);
    w.j[u] = row - w.lev[u] * s.n.d;
    w.live[u] = v < s.n_vec;
    if (!w.live[u]) continue;
    const int p = s.src_ids ? page_id(s, s_ids, s.src_ids, w.j[u], s.n.d)
                            : static_cast<int>(w.j[u]);
    if (p < 0 || static_cast<unsigned>(p) >= s.P_src) {
      w.live[u] = false;
      continue;
    }
    buf[u] = ld<W>(s.src + row_offset(w.lev[u], p, s.P_src, s) +
                   w.off[u] * W);
  }
}

template <int W>
__device__ __forceinline__ void store_tile(const Seg& s, const int* s_ids,
                                           const uint4 (&buf)[kUnroll],
                                           const Where& w) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (!w.live[u]) continue;
    const int p = s.dst_ids ? page_id(s, s_ids, s.dst_ids, w.j[u], 0)
                            : static_cast<int>(w.j[u]);
    if (p < 0 || static_cast<unsigned>(p) >= s.P_dst) continue;
    st<W>(s.dst + row_offset(w.lev[u], p, s.P_dst, s) + w.off[u] * W,
          buf[u]);
  }
}

__device__ __forceinline__ void load_any(const Seg& s, unsigned tile,
                                         const int* s_ids,
                                         uint4 (&buf)[kUnroll], Where& w) {
  switch (s.vec) {
    case 16: load_tile<16>(s, tile, s_ids, buf, w); break;
    case 8: load_tile<8>(s, tile, s_ids, buf, w); break;
    case 4: load_tile<4>(s, tile, s_ids, buf, w); break;
    case 2: load_tile<2>(s, tile, s_ids, buf, w); break;
    default: load_tile<1>(s, tile, s_ids, buf, w); break;
  }
}

__device__ __forceinline__ void store_any(const Seg& s, const int* s_ids,
                                          const uint4 (&buf)[kUnroll],
                                          const Where& w) {
  switch (s.vec) {
    case 16: store_tile<16>(s, s_ids, buf, w); break;
    case 8: store_tile<8>(s, s_ids, buf, w); break;
    case 4: store_tile<4>(s, s_ids, buf, w); break;
    case 2: store_tile<2>(s, s_ids, buf, w); break;
    default: store_tile<1>(s, s_ids, buf, w); break;
  }
}

// the segment's ids in shared memory: dst ids at [0, n), src ids at
// [n, 2n)
__device__ __forceinline__ void stage_ids(const Seg& s, int* s_ids) {
  for (unsigned i = threadIdx.x; i < s.n.d; i += blockDim.x) {
    if (s.dst_ids) s_ids[i] = __ldg(s.dst_ids + i);
    if (s.src_ids) s_ids[s.n.d + i] = __ldg(s.src_ids + i);
  }
}

// block (x, y) walks tiles x, x + gridDim.x, ... of segment y
__global__ void __launch_bounds__(kThreads)
    page_copy_kernel(const __grid_constant__ Group g) {
  __shared__ int s_ids[kIdCap];
  const Seg& s = g.seg[blockIdx.y];
  unsigned tile = blockIdx.x;
  if (tile >= s.n_tiles) return;
  uint4 buf[kUnroll];
  Where w;
  // the first tile's loads go out before the id barrier when its source
  // pages are addressed without ids (the tiles of a page write)
  bool pre = s.src_ids == nullptr;
  if (pre) load_any(s, tile, s_ids, buf, w);
  if (s.stage) stage_ids(s, s_ids);
  __syncthreads();
  for (; tile < s.n_tiles; tile += gridDim.x) {
    if (!pre) load_any(s, tile, s_ids, buf, w);
    pre = false;
    store_any(s, s_ids, buf, w);
  }
}

Group unpack(const long long* d) {
  Group g{};
  g.n_seg = static_cast<int>(d[0]);
  for (int k = 0; k < g.n_seg; ++k) {
    const long long* f = d + kHeader + k * kSegFields;
    Seg& x = g.seg[k];
    x.dst = reinterpret_cast<char*>(f[0]);
    x.src = reinterpret_cast<const char*>(f[1]);
    x.dst_ids = reinterpret_cast<const int*>(f[2]);
    x.src_ids = reinterpret_cast<const int*>(f[3]);
    x.P_dst = static_cast<unsigned>(f[4]);
    x.P_src = static_cast<unsigned>(f[5]);
    x.M = static_cast<unsigned>(f[6]);
    x.n_vec = static_cast<unsigned>(f[7]);
    x.n_tiles = static_cast<unsigned>(f[8]);
    x.per_page = {static_cast<unsigned>(f[9]), static_cast<unsigned>(f[10]),
                  static_cast<int>(f[11])};
    x.n = {static_cast<unsigned>(f[12]), static_cast<unsigned>(f[13]),
           static_cast<int>(f[14])};
    x.vec = static_cast<int>(f[15]);
    x.stage = static_cast<int>(f[16]);
  }
  return g;
}

}  // namespace

// The layout constants the wrapper checks its descriptor against.
extern "C" int repro_page_copy_layout(long long* out) {
  out[0] = kHeader;
  out[1] = kSegFields;
  out[2] = kMaxSegs;
  out[3] = kIdCap;
  out[4] = kThreads * kUnroll;
  return 0;
}

// One grouped page copy. `desc` is the host descriptor built by
// `page_io.plan` (int64 words, see the layout above), launched on
// (grid, n_seg) blocks. Returns cudaGetLastError() of the launch.
extern "C" int repro_page_copy(const long long* desc, int grid,
                               void* stream) {
  const Group g = unpack(desc);
  if (g.n_seg <= 0 || grid <= 0) return 0;
  page_copy_kernel<<<dim3(grid, g.n_seg), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// The device address of pinned host memory at `host`; an error (and no
// address) when the memory is not pinned and mapped.
extern "C" int repro_host_device_ptr(void* host, void** dev) {
  *dev = nullptr;
  return static_cast<int>(cudaHostGetDevicePointer(dev, host, 0));
}
