// Decode attention over one layer of the stacked bf16 (or fp32) KV cache,
// with this step's fresh token merged last.
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_attention_fresh
// (_decode_fresh_kernel). The body is decode_attn.cuh's kernel with FRESH:
// keys in [start, length) of the cache plane, then the fresh key/value (not
// yet in the cache) merged as the last tile; length is past-only. A bf16 call
// past G = 8 (Falcon-7B's 71, ChatGLM3-6B's 16) runs beam_attn.cuh's mma body
// over the same keys, each row a group of one beam with no tail.
//
// What bounds it on an H100: bytes, ~71 MB per launch at OPT-6.7B b16 with
// ~272 past tokens (~21 us at 3.35 TB/s); see decode_attn.cuh for the design.
#include "beam_attn.cuh"
#include "decode_attn.cuh"

// kc/vc point at layer layer_idx of the stacked cache (the wrapper offsets
// them). Returns a cudaError_t value: 0 on a successful launch. D must be 64,
// 80, 96, 128 or 256; G = N / Nkv any group: decode_attn.cuh's warp body, one block a
// (kv head, row, run of up to 8 heads). The wrapper sends bf16 calls past G
// = 8 to lia_decode_fresh_groups.
extern "C" int lia_decode_fresh(const void* q, const void* kf, const void* vf, const void* kc,
                                const void* vc, const void* slot_mask, const void* lengths,
                                int length_stride, void* out, int B, int N, int Nkv, int S_max,
                                int D, float sscale, int is_bf16, void* stream) {
  const lia_dec::Keys keys{static_cast<const uint8_t*>(slot_mask), S_max};
  return lia_dec::dispatch<true, lia_dec::kPlane>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B,
                                        N, Nkv, D, sscale, is_bf16, stream);
}

// The same function for bf16 past G = 8 on beam_attn.cuh's mma body: a row
// is a group of one beam with no tail, bpc = 1 (runs of 16 heads), its keys
// split into `parts` (a workspace of parts * B * N * (D + 2) floats when
// parts > 1); every pointer 16-byte aligned; sms is the card's SM count.
extern "C" int lia_decode_fresh_groups(const void* q, const void* kf, const void* vf, const void* kc,
                                       const void* vc, const void* slot_mask, const void* lengths,
                                       int length_stride, void* out, void* ws, int parts, int bpc, int B,
                                       int N, int Nkv, int S_max, int D, int sms, float sscale, void* stream) {
  using lia_beam::bf16;
  const lia_beam::Keys keys{static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
                            static_cast<const uint8_t*>(slot_mask), S_max, nullptr, nullptr, 0, 1, nullptr,
                            length_stride};
  return lia_beam::dispatch(q, kf, vf, keys, lengths, out, ws, parts, B, N, Nkv, D, bpc, sms, sscale, stream);
}
