// Grouped-beam decode attention over one layer of an INT8 beam cache
// (per-token f32 scales): the group's shared prompt plane, then this beam's
// generated tail, then this step's fresh token, in one online softmax.
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_beam_attention_int8
// (_decode_beam_int8_kernel). The body is decode_int8_attn.cuh's kernel with
// the beam key source and the fresh token already dequantized: the K scale
// folds into the scores, s * (ks * scale*log2(e)); p * vs rounds to q's type
// before P.V; the fresh token merges in fp32. plen, tlen and the prompt mask
// are read on the device.
//
// What bounds it on an H100: bytes, the group prompt's int8 rows read once per
// group plus each beam's tail rows, ~10 MB a launch at OPT-6.7B width with 4
// groups of 4 beams over a 256-slot prompt (~3 us at 3.35 TB/s). One block a
// (kv head, group) holds the queries of all the group's beams (up to 8; more
// go to further blocks, in runs of 8 flat queries where a beam has more), so a group's prompt crosses from memory once; see
// decode_int8_attn.cuh for the design.
#include "decode_int8_attn.cuh"

// kpq/kps/vpq/vps point at layer layer_idx of the stacked prompt cache [L, B0,
// Nkv, S_p(, D)] and ktq/kts/vtq/vts at that layer of the tail [L, B, Nkv,
// T_max(, D)] (the wrapper offsets them; the codes 16-byte aligned); kf/vf are
// the dequantized fresh K/V [B, Nkv, 1, D] in q's type; prompt_mask is bool
// [B0, S_p]; prompt_len and tail_len are int32 scalars on the device. B = B0 *
// nb; a block holds bpc beams of a group (bpc * G <= 8), or with bpc = 1 a
// run of 8 of the group's flat queries (G > 8). parts > 1 splits each
// group's keys and needs ws, parts * B * N * (D + 2) floats (no memset); sms
// is the card's SM count. Returns a cudaError_t value: 0 on a successful
// launch. D must be 64, 80, 96, 112, 128 or 256 (slopes: ALiBi's, fp32 [N], or
// null); G = N / Nkv any group (the wrapper admits 1 .. 128).
extern "C" int lia_beam_decode_int8(const void* q, const void* kf, const void* vf,
                                    const void* kpq, const void* kps, const void* vpq,
                                    const void* vps, const void* ktq, const void* kts,
                                    const void* vtq, const void* vts, const void* prompt_mask,
                                    const void* prompt_len, const void* tail_len, void* out, void* ws,
                                    int parts, int bpc, int B, int nb, int N, int Nkv, int S_p,
                                    int T_max, int D, int sms, float sscale, int is_bf16, const void* slopes,
                                    void* stream) {
  if (nb <= 0 || B % nb != 0 || S_p <= 0 || T_max <= 0) return (int)cudaErrorInvalidValue;
  const lia_dec8::Keys keys{static_cast<const int8_t*>(kpq), static_cast<const float*>(kps),
                            static_cast<const int8_t*>(vpq), static_cast<const float*>(vps),
                            static_cast<const uint8_t*>(prompt_mask), S_p,
                            static_cast<const int8_t*>(ktq), static_cast<const float*>(kts),
                            static_cast<const int8_t*>(vtq), static_cast<const float*>(vts),
                            T_max, nb, static_cast<const int*>(tail_len)};
  return lia_dec8::dispatch<false, true>(q, kf, vf, keys, prompt_len, 0, out, ws, parts, B, N, Nkv, D,
                                         bpc, sms, sscale, is_bf16, slopes, stream);
}

// Dynamic shared memory of one block (for the build report) at head dim D
// with a ring of `stages`.
extern "C" int lia_dec8_smem_bytes(int D, int stages) {
  return lia_dec8::smem_bytes(lia::padded_dim(D), stages);
}

// Stages of the ring for a launch of `blocks` blocks on `sms` SMs.
extern "C" int lia_dec8_stages(int D, int blocks, int sms) {
  return lia_dec8::ring_stages(lia::padded_dim(D), blocks, sms);
}
