// Grouped-beam decode attention over one layer of the beam cache, bf16 (or
// fp32): the group's shared prompt plane, then this beam's generated tail,
// then this step's fresh token, in one online softmax.
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_beam_attention
// (_decode_beam_kernel). The body is decode_attn.cuh's kernel with FRESH and
// the beam key source: keys [pstart_g, plen) of the prompt plane of group g =
// b / nb, then keys [0, tlen) of beam b's tail, as one contiguous virtual
// range, then the fresh key/value (in no cache yet). plen, tlen and the prompt
// mask (pstart_g = plen - popcount(prompt_mask[g])) are read on the device, so
// a beam step never syncs with the host. A step with tlen = 0 (the first after
// the prompt) reads no tail row.
//
// What bounds it on an H100: bytes. The prompt rows are the bulk, and every
// beam of a group reads the same ones: read once per group, the prompt is
// ~14.5 MB of the ~19 MB a launch moves at OPT-6.7B width with 4 groups of 4
// beams over a 256-slot prompt (~5.7 us at 3.35 TB/s); read once per beam it
// would be ~62 MB. Blocks run beams innermost (blockIdx.x = b), so the nb
// blocks of a (group, head) pair run side by side and the L2 serves nb - 1 of
// every nb prompt reads; see decode_attn.cuh for the rest of the design.
#include "decode_attn.cuh"

// kp/vp point at layer layer_idx of the stacked [L, B0, Nkv, S_p, D] prompt
// cache and kt/vt at that layer of the [L, B, Nkv, T_max, D] tail (the
// wrapper offsets them); kf/vf are [B, Nkv, 1, D]; prompt_mask is bool [B0,
// S_p]; prompt_len and tail_len are int32 scalars on the device. B = B0 * nb.
// Returns a cudaError_t value: 0 on a successful launch. D must be 64 or 128
// and G = N / Nkv one of 1, 2, 4, 8.
extern "C" int lia_beam_decode(const void* q, const void* kf, const void* vf, const void* kp,
                               const void* vp, const void* kt, const void* vt,
                               const void* prompt_mask, const void* prompt_len,
                               const void* tail_len, void* out, int B, int nb, int N, int Nkv,
                               int S_p, int T_max, int D, float sscale, int is_bf16,
                               void* stream) {
  if (nb <= 0 || B % nb != 0 || S_p <= 0 || T_max <= 0) return (int)cudaErrorInvalidValue;
  const lia_dec::Keys keys{static_cast<const uint8_t*>(prompt_mask), S_p, kt, vt,
                           T_max, nb, static_cast<const int*>(tail_len)};
  return lia_dec::dispatch<true, lia_dec::kBeam>(q, kf, vf, kp, vp, keys, prompt_len, 0, out, B,
                                                 N, Nkv, D, sscale, is_bf16, stream);
}
