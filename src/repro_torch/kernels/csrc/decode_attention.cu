// Flash decode: one query token per batch row and head against a
// CONTIGUOUS KV cache (B, S, KV, D) with a per-row valid length.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py
// `flash_decode` (the contiguous layout's decode step, the naive loop and
// the speculative draft model's scratch caches, once per layer).
//
// Bound: bytes — the row's first min(length, S) keys of K and V, read
// once, plus q and the output; 4 * D flops per (query head, key).
//
// Design: the same split body as the paged decode, shared through the
// template of `decode_body.cuh` with the row addressing as its policy (row
// b * S + t here, through the block table there): one block per (KV head,
// batch row, span of key positions) computes all rep = H / KV query
// heads, so each K/V row leaves device memory once per step where the
// Pallas grid (B, H, S / bk) re-reads it per query head; the span's K/V
// rows stream through a double-buffered ring of 32-key tiles, and the last
// block of each (row, KV head) merges the spans in span order in the same
// launch. The span
// partition is the paged decode's, so a contiguous engine and a paged fp
// engine compute the same sums. Keys stop at min(length, S) — parked
// rows arrive with length S + 1 and read the whole cache, never past it;
// a ragged last span (S not a multiple of 64, as the draft caches' S + k)
// is zero-filled and masked; 16-byte row copies where D * sizeof(T)
// allows, 4-byte or byte copies otherwise (D = 20 in bf16). The cache is
// in q's dtype, as the model's caches are. With `lse` the kernel also
// writes each (row, query head)'s float32 log-sum-exp (B * H * 4 more
// bytes), which the sequence-sharded decode over a mesh merges by.

#include "decode_body.cuh"

namespace {

using repro::decode::Args;
using repro::decode::DenseRows;
using repro::decode::kSzNone;
using repro::decode::launch_d;

}  // namespace

// q (B,H,D), k/v (B,S,KV,D), out (B,H,D), all in `dtype` (kF32 | kBF16);
// lengths (B,) int32; lse (B,H) float32 or null (not written). All
// contiguous, on the device. The launch plan, scratch and widths as for
// `repro_paged_decode`, with n_span = min(ceil(S / span), kMaxSpans) (no
// (scale, zero) rows). Returns cudaGetLastError() of the launch.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, void* lse,
                                  void* part, void* part_ml, void* tickets,
                                  int B, int H, int KV, int D, int S,
                                  int dtype, float scale, int span,
                                  int n_span, int vb, int smem,
                                  void* stream) {
  if (B == 0) return 0;
  Args<DenseRows> a{q,       k,     v,    nullptr, nullptr,
                    lengths, out,   part, part_ml, tickets,
                    B,       smem,
                    {H, KV, D, span, n_span, vb, 8, scale},
                    DenseRows{S}, static_cast<cudaStream_t>(stream), lse};
  if (dtype == repro::kF32) return launch_d<float, float, kSzNone>(a);
  if (dtype == repro::kBF16)
    return launch_d<__nv_bfloat16, __nv_bfloat16, kSzNone>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
