// Paged flash decode: one query token per slot and head against the
// physical KV page pool, through the slot's block table.
//
// Replaces: src/repro/kernels/decode_attention/paged.py
// `paged_flash_decode` (every decode step, once per layer).
//
// Bound: bytes — the slot's live pages of K and V (int8 payload plus its
// (scale, zero) rows on the serving pool), read once.
//
// Design: the decode body of `decode_body.cuh` (one block per (KV head,
// slot) computing all rep query heads, a loop over 32-key tiles, online
// softmax in registers, 16-byte row loads), with rows located through the
// block table: for each tile the first 32 threads resolve (physical page,
// in-page offset) and the page's or token's (scale, zero) into shared
// memory. The key loop is bounded by min(length, n_pages * page), so a
// parked slot never reads past its table. Three sub-scale modes, chosen by
// the sz rank as in the reference: none (fp pool), per page (P, KV, 2),
// per token (P, page, KV, 2).

#include "decode_body.cuh"

namespace {

using repro::decode::Args;
using repro::decode::PagedRows;
using repro::decode::kSzNone;
using repro::decode::kSzPage;
using repro::decode::kSzToken;
using repro::decode::launch_d;

template <typename T>
int launch_kv(const Args<PagedRows>& a, int kv_dtype, int sz_mode) {
  if (kv_dtype == repro::kI8) {
    if (sz_mode == kSzPage) return launch_d<T, int8_t, kSzPage>(a);
    if (sz_mode == kSzToken) return launch_d<T, int8_t, kSzToken>(a);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sz_mode != kSzNone) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == repro::kF32) return launch_d<T, float, kSzNone>(a);
  if (kv_dtype == repro::kBF16) return launch_d<T, __nv_bfloat16, kSzNone>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,H,D) in `q_dtype` (kF32 | kBF16); k/v pages (P,page,KV,D) in
// `kv_dtype` (kF32 | kBF16 | kI8); ksz/vsz f32 (P,KV,2) (sz_mode 1) or
// (P,page,KV,2) (sz_mode 2), unused for sz_mode 0; bt (B,n_pages) and
// lengths (B,) int32; out (B,H,D) in `q_dtype`. All contiguous, on the
// device. Returns cudaGetLastError() of the launch.
extern "C" int repro_paged_decode(const void* q, const void* kp,
                                  const void* vp, const void* ksz,
                                  const void* vsz, const void* bt,
                                  const void* lengths, void* out, int B, int H,
                                  int KV, int D, int page, int n_pages,
                                  int q_dtype, int kv_dtype, int sz_mode,
                                  float scale, void* stream) {
  if (B == 0) return 0;
  Args<PagedRows> a{q,  kp, vp, ksz, vsz, lengths, out, B, H, KV, D, scale,
                    PagedRows{static_cast<const int*>(bt), page, n_pages},
                    static_cast<cudaStream_t>(stream)};
  if (q_dtype == repro::kF32) return launch_kv<float>(a, kv_dtype, sz_mode);
  if (q_dtype == repro::kBF16)
    return launch_kv<__nv_bfloat16>(a, kv_dtype, sz_mode);
  return static_cast<int>(cudaErrorInvalidValue);
}
