// Paged decode attention: C queries per sequence over one layer of a paged KV
// pool, walking the block table, with this step's fresh chunk merged last.
//
// Replaces lia_tpu/ops/paged.py:paged_decode_attention (_paged_kernel). Key t
// of row b sits at page table[b, t / bs], slot t % bs of the [nb, Nkv, bs, D]
// layer; keys [0, length_b) are valid, then chunk row c merges the fresh keys
// 0..c (the causal triangle inside the chunk). C = 1 is decode; C = k + 1 is
// speculative verify. Without a fresh chunk and with length 0 the output is 0.
// The block table and the lengths are read from device memory; pages past the
// frontier (the null page 0 in unused entries) are never read.
//
// What bounds it on an H100: bytes, the [0, length_b) K and V rows of every
// (batch row, kv head): ~71 MB per launch at OPT-6.7B b16 with ~272 cached
// tokens (~21 us at 3.35 TB/s). The body (paged_attn.cuh) stages the table in
// shared memory and copies whole pages ahead of the compute into an mbarrier
// ring with cp.async.bulk; see there for the design.
#include "paged_attn.cuh"

// kc/vc point at layer layer_idx of the stacked [L, nb, Nkv, bs, D] pool (the
// wrapper offsets them, 16-byte aligned); table is int32 [B, P]; kf/vf are
// [B, Nkv, C, D] or null when has_fresh is 0. parts > 1 splits each row's
// pages and needs ws, parts * B * C * N * (D + 2) floats (no memset). Returns
// a cudaError_t value: 0 on a successful launch. D must be 64, 80, 96, 112, 128
// or 256; slopes are ALiBi's (fp32 [N]) or null.
extern "C" int lia_paged_decode(const void* q, const void* kf, const void* vf, const void* kc,
                                const void* vc, const void* table, const void* lengths,
                                int length_stride, void* out, void* ws, int parts, int B, int C, int N,
                                int Nkv, int P, int bs, int D, float sscale, int is_bf16, int has_fresh,
                                const void* slopes, void* stream) {
  return lia_paged::dispatch(q, has_fresh ? kf : nullptr, has_fresh ? vf : nullptr, kc, vc, table, lengths,
                             length_stride, out, ws, parts, B, C, N, Nkv, P, bs, D, sscale, is_bf16, slopes, stream);
}

// Dynamic shared memory of one block (for the build report): element size,
// D (any the body takes: the ring holds rows D apart), bs and the queries a
// consumer warp holds (1 or 4).
extern "C" int lia_paged_smem_bytes(int es, int D, int bs, int qpw) {
  return lia_paged::Geo(es, D, bs, qpw).bytes;
}

// Stages of the block's page ring, as lia_paged_smem_bytes.
extern "C" int lia_paged_stages(int es, int D, int bs, int qpw) {
  return lia_paged::Geo(es, D, bs, qpw).stages;
}
