// Paged decode attention: C queries per sequence over one layer of a paged KV
// pool, walking the block table, with this step's fresh chunk merged last.
//
// Replaces lia_tpu/ops/paged.py:paged_decode_attention (_paged_kernel). The
// body is decode_attn.cuh's kernel with the page-walk address: key t of row b
// sits at page table[b, t / bs], slot t % bs of the [nb, Nkv, bs, D] layer;
// keys [0, length_b) are valid, then chunk row c merges the fresh keys 0..c
// (the causal triangle inside the chunk). C = 1 is decode; C = k + 1 is
// speculative verify. Without a fresh chunk and with length 0 the output is 0.
// The block table and the lengths are read from device memory; pages past the
// frontier (the null page 0 in unused entries) are never read.
//
// What bounds it on an H100: bytes, the [0, length_b) K and V rows of every
// (batch row, kv head): ~71 MB per launch at OPT-6.7B b16 with ~272 cached
// tokens (~21 us at 3.35 TB/s), as decode_fresh.cu's; see decode_attn.cuh for
// the design.
#include "decode_attn.cuh"

// kc/vc point at layer layer_idx of the stacked [L, nb, Nkv, bs, D] pool (the
// wrapper offsets them); table is int32 [B, P]; kf/vf are [B, Nkv, C, D] or
// null when has_fresh is 0. Returns a cudaError_t value: 0 on a successful
// launch. D must be 64 or 128 and G = N / Nkv one of 1, 2, 4, 8.
extern "C" int lia_paged_decode(const void* q, const void* kf, const void* vf, const void* kc,
                                const void* vc, const void* table, const void* lengths,
                                int length_stride, void* out, int B, int C, int N, int Nkv, int P,
                                int bs, int D, float sscale, int is_bf16, int has_fresh,
                                void* stream) {
  if (P <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  const lia_dec::Keys keys{nullptr, 0, static_cast<const int*>(table), P, bs};
  if (has_fresh)
    return lia_dec::dispatch<true, lia_dec::kPaged>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B,
                                         C, N, Nkv, D, sscale, is_bf16, stream);
  return lia_dec::dispatch<false, lia_dec::kPaged>(q, nullptr, nullptr, kc, vc, keys, lengths, length_stride,
                                        out, B, C, N, Nkv, D, sscale, is_bf16, stream);
}
