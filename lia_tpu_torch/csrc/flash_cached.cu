// Chunk-over-cache causal GQA flash attention, bf16 in and out: C prompt rows
// attend the cache plane that already holds them (chunked prefill, prefix-cache
// admission).
//
// Replaces lia_tpu/ops/pallas_attention.py:flash_attention_cached
// (_flash_cached_kernel). The body is flash_attn.cuh's kernel: chunk row t
// sits at slot base_b + t and attends keys [start_b, base_b + t] (with a
// window, only keys > base_b + t - window), start_b = base_b + C -
// popcount(slot_mask[b]); base_b (a scalar or [B]) and the slot mask are read
// from device memory, so an admission never syncs with the host. The three-loop
// kv walk of the TPU kernel (Mosaic runs both branches of a cond) and its
// block-divisibility rule are not carried over: tiles before start_b // 64 and
// past each row tile's frontier base_b + t are skipped, and S_max is any
// length.
//
// What bounds it on an H100: bytes. At OPT-6.7B (32 heads, D = 128), a
// 256-row chunk at base 768 of a 1024-slot plane moves ~21 MB of q, K, V and
// out (~0.0063 ms at 3.35 TB/s) for ~3.8 GFLOP (~0.004 ms of bf16 tensor-core
// work). K/V tiles stream by TMA under the wgmma products; that shape's 4 row
// tiles x 32 kv heads give one block to nearly every SM. A prefix-cache suffix
// of <= 64 rows has 32 such tiles, so the host splits each tile's walk into
// parts up to one block an SM, and a second launch merges their fp32 partials.
#include "flash_attn.cuh"

// bases: int32, [B] (base_stride 1) or one value (base_stride 0). Returns a
// cudaError_t value: 0 on a successful launch. The wrapper chooses `parts` and
// `nw` (consumer warpgroups a block, 1 or 2, and 1 at D = 256); D must be 64,
// 80, 96, 112, 128 or 256, G = N / Nkv any group (the wrapper admits 1 .. 128), parts > 1 needs a workspace of
// parts * B * C * N * (D + 2) floats, and slopes are ALiBi's (fp32 [N]) or null.
extern "C" int lia_flash_cached(const void* q, const void* k, const void* v, const void* slot_mask,
                                const void* bases, int base_stride, void* out, void* ws, int parts, int nw, int B,
                                int C, int S_max, int N, int Nkv, int D, float sscale, int window,
                                const void* slopes, void* stream) {
  return lia_flash::dispatch(q, k, v, slot_mask, bases, base_stride, out, ws, parts, nw, B, C, S_max, N, Nkv, D,
                             sscale, window, slopes, stream);
}
