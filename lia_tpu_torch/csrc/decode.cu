// Decode attention over one per-layer plane of a bf16 (or fp32) KV cache that
// already holds this step's token (write-then-attend).
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_attention (_decode_kernel)
// and, at a layer offset into the stacked cache, decode_attention_stacked and
// decode_attention_stacked_dma (the same math). The body is decode_attn.cuh's
// kernel without the fresh-token merge: keys in [start, length) with length
// INCLUDING the current token, start = length - popcount(slot_mask[b]).
//
// The tiered scheduler's streamed layers (policy-3 tail, policy 0) run it once
// per layer per decode step. What bounds it on an H100: bytes, the [start,
// length) K and V rows of every (batch row, kv head), ~70 MB per launch at
// OPT-6.7B b16 with 273 slots and left pads (~21 us at 3.35 TB/s); see decode_attn.cuh
// for the design.
#include "decode_attn.cuh"

// kc/vc point at one [B, Nkv, S_max, D] plane (for the stacked entry the
// wrapper offsets them to layer layer_idx). Returns a cudaError_t value: 0 on
// a successful launch. D must be 64 or 128 and G = N / Nkv one of 1, 2, 4, 8.
extern "C" int lia_decode(const void* q, const void* kc, const void* vc, const void* slot_mask,
                          const void* lengths, int length_stride, void* out, int B, int N,
                          int Nkv, int S_max, int D, float sscale, int is_bf16, void* stream) {
  return lia_dec::dispatch<false>(q, nullptr, nullptr, kc, vc, slot_mask, lengths,
                                  length_stride, out, B, N, Nkv, S_max, D, sscale, is_bf16,
                                  stream);
}
