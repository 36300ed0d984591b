// Causal GQA flash attention over a left-padded prompt, bf16 in and out.
//
// Replaces lia_tpu/ops/pallas_attention.py:flash_attention_prefill (_flash_kernel).
// The body is flash_attn.cuh's kernel with base 0 and C = S_kv = S: row t
// attends keys [start, t], start = S - popcount(mask[b]) counted on the device.
//
// What bounds it on an H100: bytes. At OPT-6.7B b16 s256 (32 heads, D = 128)
// the causal product is ~8.6 GFLOP per layer against ~134 MB of q, k, v and
// out (64 FLOP/byte, under the ~295 FLOP/byte at which the bf16 tensor cores
// and HBM3 balance), so the floor is ~0.040 ms of memory traffic. The body
// streams K/V tiles by TMA while wgmma runs on the tiles already landed, two
// blocks to an SM; the 2048 (row tile, head, row) tiles of that shape fill
// the card without a split, and shorter prompts split their walks (parts > 1).
#include "flash_attn.cuh"

// Returns a cudaError_t value: 0 on a successful launch. The wrapper checks
// shapes, type and contiguity and chooses `parts` and `nw` (consumer
// warpgroups a block, 1 or 2, and 1 at D = 256); D must be 64, 80, 96, 112, 128
// or 256, G = N / Nkv any group, parts > 1 needs a workspace of parts * B * S *
// N * (D + 2) floats, and slopes are ALiBi's (fp32 [N]) or null.
extern "C" int lia_flash_prefill(const void* q, const void* k, const void* v, const void* mask, void* out,
                                 void* ws, int parts, int nw, int B, int S, int N, int Nkv, int D, float sscale,
                                 int window, const void* slopes, void* stream) {
  return lia_flash::dispatch(q, k, v, mask, nullptr, 0, out, ws, parts, nw, B, S, S, N, Nkv, D, sscale, window,
                             slopes, stream);
}
