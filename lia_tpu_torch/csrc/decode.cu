// Decode attention over one per-layer plane of a bf16 (or fp32) KV cache that
// already holds this step's token (write-then-attend).
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_attention (_decode_kernel)
// and, at a layer offset into the stacked cache, decode_attention_stacked and
// decode_attention_stacked_dma (the same math). The body is decode_attn.cuh's
// kernel without the fresh-token merge: keys in [start, length) with length
// INCLUDING the current token, start = length - popcount(slot_mask[b]). A bf16
// call past G = 8 runs beam_attn.cuh's mma body over the same keys, each row a
// group of one beam with no tail and no fresh token.
//
// The tiered scheduler's streamed layers (policy-3 tail, policy 0) run it once
// per layer per decode step. What bounds it on an H100: bytes, the [start,
// length) K and V rows of every (batch row, kv head), ~70 MB per launch at
// OPT-6.7B b16 with 273 slots and left pads (~21 us at 3.35 TB/s); see decode_attn.cuh
// for the design.
#include "beam_attn.cuh"
#include "decode_attn.cuh"

// kc/vc point at one [B, Nkv, S_max, D] plane (for the stacked entry the
// wrapper offsets them to layer layer_idx). Returns a cudaError_t value: 0 on
// a successful launch. D must be 64, 80, 96, 128 or 256; G = N / Nkv any group:
// decode_attn.cuh's warp body, in blocks of up to 8 heads. The wrapper sends
// bf16 calls past G = 8 to lia_decode_groups.
extern "C" int lia_decode(const void* q, const void* kc, const void* vc, const void* slot_mask,
                          const void* lengths, int length_stride, void* out, int B, int N,
                          int Nkv, int S_max, int D, float sscale, int is_bf16, void* stream) {
  const lia_dec::Keys keys{static_cast<const uint8_t*>(slot_mask), S_max};
  return lia_dec::dispatch<false, lia_dec::kPlane>(q, nullptr, nullptr, kc, vc, keys, lengths,
                                         length_stride, out, B, N, Nkv, D, sscale, is_bf16,
                                         stream);
}

// The same function for bf16 past G = 8 on beam_attn.cuh's mma body: a row
// is a group of one beam with no tail and no fresh token, bpc = 1 (runs of 16
// heads), its keys split into `parts` (a workspace of parts * B * N * (D + 2)
// floats when parts > 1); every pointer 16-byte aligned; sms is the card's SM
// count.
extern "C" int lia_decode_groups(const void* q, const void* kc, const void* vc, const void* slot_mask,
                                 const void* lengths, int length_stride, void* out, void* ws, int parts, int bpc,
                                 int B, int N, int Nkv, int S_max, int D, int sms, float sscale, void* stream) {
  using lia_beam::bf16;
  const lia_beam::Keys keys{static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
                            static_cast<const uint8_t*>(slot_mask), S_max, nullptr, nullptr, 0, 1, nullptr,
                            length_stride};
  return lia_beam::dispatch(q, nullptr, nullptr, keys, lengths, out, ws, parts, B, N, Nkv, D, bpc, sms, sscale,
                            stream);
}
