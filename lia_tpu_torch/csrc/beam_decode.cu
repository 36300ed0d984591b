// Grouped-beam decode attention over one layer of the beam cache, bf16 (or
// fp32): the group's shared prompt plane, then this beam's generated tail,
// then this step's fresh token, in one online softmax.
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_beam_attention
// (_decode_beam_kernel): keys [pstart_g, plen) of the prompt plane of group g
// = b / nb, then keys [0, tlen) of beam b's tail, then the fresh key/value
// (in no cache yet). plen, tlen and the prompt mask (pstart_g = plen -
// popcount(prompt_mask[g])) are read on the device, so a beam step never
// syncs with the host. A step with tlen = 0 (the first after the prompt)
// reads no tail row.
//
// What bounds it on an H100: bytes. The prompt rows are the bulk, and every
// beam of a group reads the same ones: read once per group, the prompt is
// ~14.5 MB of the ~18.7 MB a launch moves at OPT-6.7B width with 4 groups of
// 4 beams over a 256-slot prompt (~5.6 us at 3.35 TB/s); read once per beam
// it would be ~62 MB. A bf16 call runs beam_attn.cuh's body: one block a (kv
// head, group, chunk of up to 16 queries) reads the group's prompt once for
// all of them, through a cp.async ring and mma.sync, and the wrapper may
// split a group's keys into parts merged by a second launch. An fp32 call
// (tests and CPU-parity tools: no model path on the card runs fp32) runs
// decode_attn.cuh's warp body, one block a (beam, kv head), exact in fp32.
#include "beam_attn.cuh"
#include "decode_attn.cuh"

// kp/vp point at layer layer_idx of the stacked [L, B0, Nkv, S_p, D] prompt
// cache and kt/vt at that layer of the [L, B, Nkv, T_max, D] tail (the
// wrapper offsets them); kf/vf are [B, Nkv, 1, D]; prompt_mask is bool [B0,
// S_p]; prompt_len and tail_len are int32 scalars on the device. B = B0 * nb.
// bf16: a block holds bpc beams of a group (bpc * G <= 16), or with bpc = 1
// a run of 16 of the group's flat queries (G > 16); parts > 1 splits
// each group's keys and needs ws, parts * B * N * (D + 2) floats (no memset);
// sms is the card's SM count; q, kf/vf and the caches 16-byte aligned. fp32:
// parts must be 1 (bpc and sms are not read). Returns a cudaError_t value: 0
// on a successful launch. D must be 64, 80, 96, 112, 128 or 256 (slopes:
// ALiBi's, fp32 [N], or null) (bf16 blocks hold
// up to 8 queries at 256); G = N / Nkv any group (the wrapper admits 1 .. 128).
extern "C" int lia_beam_decode(const void* q, const void* kf, const void* vf, const void* kp,
                               const void* vp, const void* kt, const void* vt,
                               const void* prompt_mask, const void* prompt_len,
                               const void* tail_len, void* out, void* ws, int parts, int bpc, int B,
                               int nb, int N, int Nkv, int S_p, int T_max, int D, int sms,
                               float sscale, int is_bf16, const void* slopes, void* stream) {
  if (nb <= 0 || B % nb != 0 || S_p <= 0 || T_max <= 0) return (int)cudaErrorInvalidValue;
  if (!is_bf16) {  // the fp32 instantiations of the warp body only
    if (parts != 1 || Nkv <= 0 || N % Nkv != 0) return (int)cudaErrorInvalidValue;
    const lia_dec::Keys keys{static_cast<const uint8_t*>(prompt_mask), S_p, kt, vt,
                             T_max, nb, static_cast<const int*>(tail_len)};
    return lia_dec::launch_d<float, true, lia_dec::kBeam>(N / Nkv, q, kf, vf, kp, vp, keys, prompt_len, 0, out, B,
                                                          Nkv, D, sscale, slopes, static_cast<cudaStream_t>(stream));
  }
  using lia_beam::bf16;
  const lia_beam::Keys keys{static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
                            static_cast<const uint8_t*>(prompt_mask), S_p,
                            static_cast<const bf16*>(kt), static_cast<const bf16*>(vt),
                            T_max, nb, static_cast<const int*>(tail_len)};
  return lia_beam::dispatch(q, kf, vf, keys, prompt_len, out, ws, parts, B, N, Nkv, D, bpc, sms, sscale,
                            slopes, stream);
}

// Dynamic shared memory of one bf16 block (for the build report) at head dim
// D with a ring of `stages`.
extern "C" int lia_beam_smem_bytes(int D, int stages) {
  return lia_beam::smem_bytes(lia::padded_dim(D), stages);
}

// Stages of the bf16 body's ring for a launch of `blocks` blocks on `sms` SMs.
extern "C" int lia_beam_stages(int D, int blocks, int sms) {
  return lia_beam::ring_stages(lia::padded_dim(D), blocks, sms);
}
