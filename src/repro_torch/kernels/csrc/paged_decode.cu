// Paged flash decode: one query token per slot and head against the
// physical KV page pool, through the slot's block table.
//
// Replaces: src/repro/kernels/decode_attention/paged.py
// `paged_flash_decode` (every decode step, once per layer).
//
// Bound: bytes — the slot's live pages of K and V (int8 payload plus its
// (scale, zero) rows on the serving pool), read once.
//
// Design: the split decode body of `decode_body.cuh` (one block per (KV
// head, slot, span of key positions) computing all rep query heads; the
// span's table entries, (scale, zero) rows and K/V rows staged 32 keys a
// tile through a double-buffered cp.async ring; online softmax in
// registers; the partial spans merged in span order by the last block of
// each (slot, KV head), in the same launch), with rows located through
// the block table. The key range is
// bounded by min(length, n_pages * page), so a parked slot never reads
// past its table. Three sub-scale modes, chosen by the sz rank as in the
// reference: none (fp pool), per page (P, KV, 2), per token
// (P, page, KV, 2).

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
// device. The launch plan (`decode_plan` in kernels/decode_attention/
// paged.py): spans of `span` key positions while a slot needs at most
// `kMaxSpans` (32) of them (else longer spans, `span_len`), n_span =
// min(ceil(n_pages * page / span), kMaxSpans) blocks per (slot, KV head);
// scratch part (B*KV*n_span*rep, D) and
// part_ml (B*KV*n_span*rep, 2) f32, tickets (B*KV) int32, zero on entry
// and left zero; cp.async widths vb (K/V rows: 16, 4 or 1, synchronous)
// and sz_vb (8, or 1: synchronous); `smem` the plan's dynamic
// shared-memory bytes, checked against the kernel's own layout. Returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for an operand
// or plan the kernel does not take).
extern "C" int repro_paged_decode(
    const void* q, const void* kp, const void* vp, const void* ksz,
    const void* vsz, const void* bt, const void* lengths, void* out,
    void* part, void* part_ml, void* tickets, int B, int H, int KV, int D,
    int page, int n_pages, int q_dtype, int kv_dtype, int sz_mode,
    float scale, int span, int n_span, int vb, int sz_vb, int smem,
    void* stream) {
  if (B == 0) return 0;
  Args<PagedRows> a{q,       kp,      vp,   ksz,  vsz,
                    lengths, out,     part, part_ml, tickets,
                    B,       smem,
                    {H, KV, D, span, n_span, vb, sz_vb, scale},
                    PagedRows{static_cast<const int*>(bt), page, n_pages},
                    static_cast<cudaStream_t>(stream)};
  if (q_dtype == repro::kF32) return launch_kv<float>(a, kv_dtype, sz_mode);
  if (q_dtype == repro::kBF16)
    return launch_kv<__nv_bfloat16>(a, kv_dtype, sz_mode);
  return static_cast<int>(cudaErrorInvalidValue);
}
