// Decode attention over one per-layer plane of a bf16 (or fp32) KV cache that
// already holds this step's token (write-then-attend).
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_attention (_decode_kernel)
// and, at a layer offset into the stacked cache, decode_attention_stacked and
// decode_attention_stacked_dma (_decode_stacked_kernel, _decode_dma_kernel:
// the same math). Keys [start, length) with length INCLUDING the current
// token, start = length - popcount(slot_mask[b]), no fresh-token merge.
//
// The tiered scheduler's streamed layers (policy-3 tail, policy 0) run it once
// per layer per decode step. What bounds it on an H100: bytes, the [start,
// length) K and V rows of every (batch row, kv head), ~70 MB per launch at
// OPT-6.7B b16 with 273 slots and left pads (~21 us at 3.35 TB/s). Three
// bodies, by the wrapper's plan (ops/cuda_attention.py: plane_plan):
// - bf16 at one query head a kv head (PLANE_MAX_GROUP): plane_attn.cuh (a
//   producer warp's cp.async.bulk ring of each row's contiguous K/V run,
//   consumers reading 16 bytes a lane, a device-cut split merged by a second
//   launch); see that header for the design;
// - bf16 past it (from two query heads a kv head, Llama-3-8B's four among
//   them): beam_attn.cuh's mma body, each row a group of one beam with no
//   tail and no fresh token;
// - fp32 (tests and the CPU-parity tools; no model path on the card runs
//   fp32): decode_attn.cuh's warp body.
#include "beam_attn.cuh"
#include "decode_attn.cuh"
#include "plane_attn.cuh"

// kc/vc point at one [B, Nkv, S_max, D] plane (for the stacked entry the
// wrapper offsets them to layer layer_idx). Returns a cudaError_t value: 0 on
// a successful launch. D must be 64, 80, 96, 112, 128 or 256; slopes are
// ALiBi's (fp32 [N]) or null. bf16: N == Nkv (one
// query head a kv head) on plane_attn.cuh's body with a ring of `stages`, its
// keys split into `parts` (a workspace of parts * B * N * (D + 2) floats when
// parts > 1); every pointer 16-byte aligned. fp32: any group on the warp
// body, parts 1 (ws and stages are not read).
extern "C" int lia_decode(const void* q, const void* kc, const void* vc, const void* slot_mask,
                          const void* lengths, int length_stride, void* out, void* ws, int parts, int stages,
                          int B, int N, int Nkv, int S_max, int D, float sscale, int is_bf16, const void* slopes,
                          void* stream) {
  if (is_bf16)
    return lia_plane::dispatch<false>(q, nullptr, nullptr, kc, vc, slot_mask, S_max, lengths, length_stride, out,
                                      ws, parts, stages, B, N, Nkv, D, sscale, slopes, stream);
  if (parts != 1) return (int)cudaErrorInvalidValue;
  const lia_dec::Keys keys{static_cast<const uint8_t*>(slot_mask), S_max};
  return lia_dec::dispatch_f32<false, lia_dec::kPlane>(q, nullptr, nullptr, kc, vc, keys, lengths, length_stride,
                                                       out, B, N, Nkv, D, sscale, slopes, stream);
}

// The same function for bf16 past PLANE_MAX_GROUP on beam_attn.cuh's mma
// body: a row is a group of one beam with no tail and no fresh token, bpc = 1
// (runs of 16 heads), its keys split into `parts` (a workspace of parts * B *
// N * (D + 2) floats when parts > 1); every pointer 16-byte aligned; sms is
// the card's SM count.
extern "C" int lia_decode_groups(const void* q, const void* kc, const void* vc, const void* slot_mask,
                                 const void* lengths, int length_stride, void* out, void* ws, int parts, int bpc,
                                 int B, int N, int Nkv, int S_max, int D, int sms, float sscale, const void* slopes,
                                 void* stream) {
  using lia_beam::bf16;
  const lia_beam::Keys keys{static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
                            static_cast<const uint8_t*>(slot_mask), S_max, nullptr, nullptr, 0, 1, nullptr,
                            length_stride};
  return lia_beam::dispatch(q, nullptr, nullptr, keys, lengths, out, ws, parts, B, N, Nkv, D, bpc, sms, sscale,
                            slopes, stream);
}

// Dynamic shared memory of one plane block (for the build report) at head dim
// D with a ring of `stages`.
extern "C" int lia_plane_smem_bytes(int D, int stages) {
  const int DP = lia::padded_dim(D);
  return DP ? lia_plane::smem_bytes(D, DP, stages) : 0;
}
