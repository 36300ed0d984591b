// Decode attention over one layer of the stacked INT8 KV cache (per-token f32
// scales), with this step's fresh token merged last.
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_attention_fresh_int8
// (_decode_fresh_int8_kernel). The body is decode_int8_attn.cuh's kernel over
// a plane, with the raw fresh token: keys in [start, length) of the cache
// plane (length past-only), then the fresh key/value, which the kernel takes
// through their int8 round trip itself before they merge.
//
// What bounds it on an H100: bytes, half of the bf16 kernel's (int8 codes
// plus one f32 scale per 128-byte row): ~36 MB a launch at OPT-6.7B b16 with
// ~266 cached tokens a row (~11 us at 3.35 TB/s). One block a (kv head, row)
// holds the row's G queries; a producer warp streams the row's keys into an
// mbarrier ring with cp.async.bulk; see decode_int8_attn.cuh for the design.
#include "decode_int8_attn.cuh"

// kq/ks/vq/vs point at layer layer_idx of the stacked cache (the wrapper
// offsets them; the codes 16-byte aligned). parts > 1 splits each row's keys
// and needs ws, parts * B * N * (D + 2) floats (no memset); sms is the card's
// SM count (the ring's depth follows the blocks an SM). Returns a cudaError_t
// value: 0 on a successful launch. D must be 64, 80, 96, 112, 128 or 256 (slopes:
// ALiBi's, fp32 [N], or null); G = N / Nkv any group
// (the wrapper admits 1 .. 128), a row's heads in runs of up to 8 a block.
extern "C" int lia_decode_fresh_int8(const void* q, const void* kf, const void* vf,
                                     const void* kq, const void* ks, const void* vq,
                                     const void* vs, const void* slot_mask,
                                     const void* lengths, int length_stride, void* out, void* ws,
                                     int parts, int B, int N, int Nkv, int S_max, int D, int sms,
                                     float sscale, int is_bf16, const void* slopes, void* stream) {
  const lia_dec8::Keys keys{static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
                            static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
                            static_cast<const uint8_t*>(slot_mask), S_max};
  return lia_dec8::dispatch<true, false>(q, kf, vf, keys, lengths, length_stride, out, ws, parts, B, N,
                                         Nkv, D, 1, sms, sscale, is_bf16, slopes, stream);
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
