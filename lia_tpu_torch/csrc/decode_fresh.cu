// Decode attention over one layer of the stacked bf16 (or fp32) KV cache,
// with this step's fresh token merged last.
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_attention_fresh
// (_decode_fresh_kernel). The body is decode_attn.cuh's kernel with FRESH:
// keys in [start, length) of the cache plane, then the fresh key/value (not
// yet in the cache) merged as the last tile; length is past-only.
//
// What bounds it on an H100: bytes, ~71 MB per launch at OPT-6.7B b16 with
// ~272 past tokens (~21 us at 3.35 TB/s); see decode_attn.cuh for the design.
#include "decode_attn.cuh"

// kc/vc point at layer layer_idx of the stacked cache (the wrapper offsets
// them). Returns a cudaError_t value: 0 on a successful launch. D must be 64
// or 128 and G = N / Nkv one of 1, 2, 4, 8.
extern "C" int lia_decode_fresh(const void* q, const void* kf, const void* vf, const void* kc,
                                const void* vc, const void* slot_mask, const void* lengths,
                                int length_stride, void* out, int B, int N, int Nkv, int S_max,
                                int D, float sscale, int is_bf16, void* stream) {
  const lia_dec::Keys keys{static_cast<const uint8_t*>(slot_mask), S_max};
  return lia_dec::dispatch<true, lia_dec::kPlane>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B,
                                        N, Nkv, D, sscale, is_bf16, stream);
}
