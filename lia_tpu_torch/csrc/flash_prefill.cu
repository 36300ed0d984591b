// Causal GQA flash attention over a left-padded prompt, bf16 in and out.
//
// Replaces lia_tpu/ops/pallas_attention.py:flash_attention_prefill (_flash_kernel).
// The body is flash_attn.cuh's kernel with base 0 and C = S_kv = S: row t
// attends keys [start, t], start = S - popcount(mask[b]) counted on the device.
//
// What bounds it on an H100: bytes. At OPT-6.7B b16 s256 the causal product
// is ~8.6 GFLOP per layer against ~134 MB of q/k/v/o (64 FLOP/byte, under the
// card's ~295 FLOP/byte balance point of bf16 tensor cores and HBM3), so the
// floor is ~40 us of memory traffic; see flash_attn.cuh for the design.
#include "flash_attn.cuh"

// Returns a cudaError_t value: 0 on a successful launch. The wrapper checks
// shapes, type and contiguity; D must be 64 or 128 and G = N / Nkv at most 64.
extern "C" int lia_flash_prefill(const void* q, const void* k, const void* v, const void* mask,
                                 void* out, int B, int S, int N, int Nkv, int D, float sscale,
                                 int window, void* stream) {
  return lia_flash::dispatch(q, k, v, mask, nullptr, 0, out, B, S, S, N, Nkv, D, sscale, window,
                             stream);
}
