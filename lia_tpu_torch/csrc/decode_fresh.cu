// Decode attention over one layer of the stacked bf16 (or fp32) KV cache,
// with this step's fresh token merged.
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_attention_fresh
// (_decode_fresh_kernel): keys in [start, length) of the cache plane, then the
// fresh key/value (not yet in the cache); length is past-only, start = length
// - popcount(slot_mask[b]).
//
// What bounds it on an H100: bytes, ~70 MB per launch at OPT-6.7B b16 with
// ~272 past tokens (~21 us at 3.35 TB/s). Three bodies, by the wrapper's plan
// (ops/cuda_attention.py: plane_plan):
// - bf16 at one query head a kv head (PLANE_MAX_GROUP): plane_attn.cuh (a
//   producer warp's cp.async.bulk ring of each row's contiguous K/V run,
//   consumers reading 16 bytes a lane, the fresh token opening one lane
//   group's softmax, a device-cut split whose merge launch takes the fresh
//   token); see that header for the design;
// - bf16 past it (Llama-3-8B's 4 query heads a kv head, ChatGLM3-6B's 16,
//   Falcon-7B's 71): beam_attn.cuh's mma body, each row a group of one beam
//   with no tail;
// - fp32 (tests and the CPU-parity tools; no model path on the card runs
//   fp32): decode_attn.cuh's warp body, the fresh token merged last.
#include "beam_attn.cuh"
#include "decode_attn.cuh"
#include "plane_attn.cuh"

// kc/vc point at layer layer_idx of the stacked cache (the wrapper offsets
// them). Returns a cudaError_t value: 0 on a successful launch. D must be 64,
// 80, 96, 112, 128 or 256 (slopes: ALiBi's, fp32 [N], or null). bf16: N == Nkv (one query head a kv head) on
// plane_attn.cuh's body with a ring of `stages`, its keys split into `parts`
// (a workspace of parts * B * N * (D + 2) floats when parts > 1); every
// pointer 16-byte aligned. fp32: any group on the warp body, parts 1 (ws and
// stages are not read).
extern "C" int lia_decode_fresh(const void* q, const void* kf, const void* vf, const void* kc,
                                const void* vc, const void* slot_mask, const void* lengths,
                                int length_stride, void* out, void* ws, int parts, int stages, int B, int N,
                                int Nkv, int S_max, int D, float sscale, int is_bf16, const void* slopes,
                                void* stream) {
  if (is_bf16)
    return lia_plane::dispatch<true>(q, kf, vf, kc, vc, slot_mask, S_max, lengths, length_stride, out, ws, parts,
                                     stages, B, N, Nkv, D, sscale, slopes, stream);
  if (parts != 1) return (int)cudaErrorInvalidValue;
  const lia_dec::Keys keys{static_cast<const uint8_t*>(slot_mask), S_max};
  return lia_dec::dispatch_f32<true, lia_dec::kPlane>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, N,
                                                      Nkv, D, sscale, slopes, stream);
}

// The same function for bf16 past PLANE_MAX_GROUP on beam_attn.cuh's mma
// body: a row is a group of one beam with no tail, bpc = 1 (runs of 16
// heads), its keys split into `parts` (a workspace of parts * B * N * (D + 2)
// floats when parts > 1); every pointer 16-byte aligned; sms is the card's SM
// count.
extern "C" int lia_decode_fresh_groups(const void* q, const void* kf, const void* vf, const void* kc,
                                       const void* vc, const void* slot_mask, const void* lengths,
                                       int length_stride, void* out, void* ws, int parts, int bpc, int B,
                                       int N, int Nkv, int S_max, int D, int sms, float sscale, const void* slopes,
                                       void* stream) {
  using lia_beam::bf16;
  const lia_beam::Keys keys{static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
                            static_cast<const uint8_t*>(slot_mask), S_max, nullptr, nullptr, 0, 1, nullptr,
                            length_stride};
  return lia_beam::dispatch(q, kf, vf, keys, lengths, out, ws, parts, B, N, Nkv, D, bpc, sms, sscale, slopes,
                            stream);
}

// Dynamic shared memory of one plane block (for the build report) at head dim
// D with a ring of `stages`.
extern "C" int lia_plane_smem_bytes(int D, int stages) {
  const int DP = lia::padded_dim(D);
  return DP ? lia_plane::smem_bytes(D, DP, stages) : 0;
}
