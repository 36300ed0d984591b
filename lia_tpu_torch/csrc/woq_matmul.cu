// Weight-only quantized matmul: bf16 activations x int8, int4, NF4 or
// zero-point int4 weight codes, fp32 out.
//
// Replaces lia_tpu/ops/pallas_matmul.py:woq_matmul (_woq_kernel, _woq4_kernel,
// _woq_nf4_kernel) and woq4z_matmul (_woq4z_kernel). Same math: the codes are
// turned into bf16 (exact for int8, c - 8 and raw int4 codes; NF4 through the
// 16-entry codebook rounded to bf16, as the TPU kernel's select tree rounds to
// the activation's type), each group's product x_g @ code_g is summed in fp32
// on the tensor cores (wgmma, bf16 in), and only a finished group sum is
// scaled: y = sum_g s_g * (x_g @ code_g). The scale is never folded into a
// bf16 weight. The zero-point form subtracts rowsum(x_g) * z_g from the
// group sum first. 4-bit weights are [K/2, N] bytes in the global half-split:
// byte r holds row r (low nibble) and K/2 + r.
//
// What bounds it on an H100: at decode (M = 16) bytes, the weight read once
// (OPT-6.7B wqkv in int4: 25.2 MB, 7.5 us at 3.35 TB/s) against 16
// multiply-adds per code; at prefill (M = 4096) the bf16 tensor-core rate
// (wqkv: 0.42 ms at 989 TFLOP/s). The design is the Hopper body of
// qmatmul.cuh: TMA rings of weight, activation and scale tiles; at prefill a
// producer warpgroup, 128 activation rows a block and bf16 wgmma over the
// next tile's unpack (int4 by bit patterns: 0x4300 | n is the bf16 128 + n,
// one bf16x2 subtraction gives two codes; NF4 through a shared-memory table),
// the weight MN-major as it lies in memory, so the unpack needs no transpose;
// at decode mma.sync with the weight fragments built in registers, three
// blocks an SM, and a K split whose last block adds the partials in a fixed
// order.
#include "qmatmul.cuh"

// kind: 0 int8 [K, N], 1 int4 (c - 8), 2 NF4, 3 int4 raw codes with zero-points z
// (the 4-bit kinds [K/2, N] half-split). The plan's arguments as for
// lia_w4a8_matmul; rs is an fp32 [ng, (M + 3) / 4 * 4]
// workspace for kind 3. Returns a
// cudaError_t value: 0 on a successful launch.
extern "C" int lia_woq_matmul(const void* x, const void* q, const void* s, const void* z, void* out, void* ws,
                              void* rs, void* tickets, int M, int N, int K, int ng, int kind, int splits,
                              int split_rows, int decode, int tma, void* stream) {
  using namespace lia_qmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((kind == WOQ_INT4Z) != (z != nullptr)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.q = static_cast<const uint8_t*>(q);
  p.s = static_cast<const float*>(s);
  p.z = static_cast<const float*>(z);
  p.rs = static_cast<const float*>(rs);
  p.out = static_cast<float*>(out);
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<unsigned int*>(tickets);
  p.L = 1;
  p.M = M, p.N = N, p.K = K, p.ng = ng, p.splits = splits, p.split_rows = split_rows, p.tma_w = tma;
  switch (kind) {
    case WOQ_INT8: return run<WOQ_INT8, false, false>(p, decode, st);
    case WOQ_INT4: return run<WOQ_INT4, false, false>(p, decode, st);
    case WOQ_NF4: return run<WOQ_NF4, false, false>(p, decode, st);
    case WOQ_INT4Z: return run<WOQ_INT4Z, true, false>(p, decode, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block (for the build report).
extern "C" int lia_woq_smem_bytes(int kind, int decode, int K, int ng) {
  using namespace lia_qmm;
  switch (kind) {
    case WOQ_INT8: return smem_bytes<WOQ_INT8>(decode, K, ng, 0);
    case WOQ_INT4: return smem_bytes<WOQ_INT4>(decode, K, ng, 0);
    case WOQ_NF4: return smem_bytes<WOQ_NF4>(decode, K, ng, 0);
    case WOQ_INT4Z: return smem_bytes<WOQ_INT4Z>(decode, K, ng, 1);
  }
  return -1;
}
