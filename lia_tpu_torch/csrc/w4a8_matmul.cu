// W4A8 matmul: int8 activations (per-token scales) x int4 weights in groups,
// fp32 out, with or without per-group zero-points.
//
// Replaces lia_tpu/ops/pallas_matmul.py:w4a8_matmul (_w4a8_kernel and
// _w4a8z_kernel). Same math:
//   y[m, n] = sx[m] * sum_g s[g, n] * (xq_g @ (c - 8)_g  -  [z] rowsum(xq_g) * (z[g, n] - 8))
// Nibbles are unpacked to signed int8 (c - 8, for the biased symmetric codes
// and the raw zero-point codes alike, as the TPU kernel rebases both), each
// group's product is an exact int32 sum on the tensor cores (wgmma s8 x s8 ->
// s32), and only a finished group sum is converted to fp32 and scaled; the
// zero-point form subtracts the group's int32 row sum times (z - 8) first.
// Weights are [K/2, N] bytes in the global half-split: byte r holds row r
// (low nibble) and row K/2 + r (high nibble).
//
// What bounds it on an H100: at decode (M = 16) bytes, the packed weight read
// once (OPT-6.7B wqkv: 25.2 MB, 7.5 us at 3.35 TB/s); at prefill (M = 4096)
// the int8 tensor-core rate (wqkv: 0.2 ms at 1979 TOP/s), and before it the
// unpacking and the group scaling, which a tensor-core-bound kernel has to
// hide. The design is the Hopper body of qmatmul.cuh: TMA rings of weight,
// activation and scale tiles; at prefill a producer warpgroup, 128 activation
// rows a block (each unpacked tile feeds 128 rows) and s8 wgmma over the next
// tile's unpack, the unpack transposing 4 x 4 byte blocks in registers
// (byte_perm) since s8 wgmma reads only K-major operands; at decode mma.sync
// with the weight fragments built in registers from both nibbles of each raw
// byte, three blocks an SM, and a K split whose last block adds the partials
// in a fixed order.
//
// The stacked entry (lia_w4a8_matmul_stacked) replaces
// lia_tpu/ops/pallas_matmul.py:w4a8_matmul_stacked (_w4a8_kernel_stacked and
// _w4a8z_kernel_stacked): the same body against layer `layer` of an
// [L, K/2, N] stack with [L, ng, N] scales and zero-points. Where the TPU
// kernel takes the layer as a prefetched scalar, each block here reads it once
// from device memory, as a TMA coordinate and a scale offset, so a captured
// decode step can replay its layer loop without a host-side index. An index
// outside [0, L) reads nothing and writes NaN.
#include "qmatmul.cuh"

namespace {

using lia_qmm::Params;

Params params(const void* xq, const void* sx, const void* q, const void* s, const void* z, void* out, void* ws,
              void* rs, void* tickets, int M, int N, int K, int ng, int splits, int split_rows, int tma) {
  Params p{};
  p.x = xq;
  p.sx = static_cast<const float*>(sx);
  p.q = static_cast<const uint8_t*>(q);
  p.s = static_cast<const float*>(s);
  p.z = static_cast<const float*>(z);
  p.rs = static_cast<const float*>(rs);
  p.out = static_cast<float*>(out);
  p.ws = static_cast<float*>(ws);
  p.tickets = static_cast<unsigned int*>(tickets);
  p.L = 1;
  p.M = M, p.N = N, p.K = K, p.ng = ng, p.splits = splits, p.split_rows = split_rows, p.tma_w = tma;
  return p;
}

template <bool STACKED>
int run(const Params& p, int decode, cudaStream_t st) {
  using namespace lia_qmm;
  if (p.z) return lia_qmm::run<W4A8, true, STACKED>(p, decode, st);
  return lia_qmm::run<W4A8, false, STACKED>(p, decode, st);
}

}  // namespace

// z null: biased symmetric codes; else raw codes with per-group zero-points.
// The wrapper's plan (lia_tpu_torch/ops/cuda_matmul.py:plan) gives the
// regime (decode: M <= 16), the K split (splits x split_rows weight rows) and
// whether the weight is read by TMA (tma: its row stride a multiple of 16
// bytes). ws: a [splits, M, N] fp32 workspace and tickets a zeroed int32
// [tiles] array where splits > 1; rs: an fp32 [ng, (M + 3) / 4 * 4] workspace
// with zero-points. Returns a cudaError_t value: 0 on a successful launch.
extern "C" int lia_w4a8_matmul(const void* xq, const void* sx, const void* q, const void* s, const void* z,
                               void* out, void* ws, void* rs, void* tickets, int M, int N, int K, int ng,
                               int splits, int split_rows, int decode, int tma, void* stream) {
  const Params p = params(xq, sx, q, s, z, out, ws, rs, tickets, M, N, K, ng, splits, split_rows, tma);
  return run<false>(p, decode, static_cast<cudaStream_t>(stream));
}

// The same against layer *layer (device int32) of a stack of L weights:
// q [L, K/2, N] with layers q_stride bytes apart, s and z [L, ng, N] with
// layers s_stride floats apart.
extern "C" int lia_w4a8_matmul_stacked(const void* xq, const void* sx, const void* q, const void* s,
                                       const void* z, const void* layer, int L, long long q_stride,
                                       long long s_stride, void* out, void* ws, void* rs, void* tickets, int M,
                                       int N, int K, int ng, int splits, int split_rows, int decode, int tma,
                                       void* stream) {
  if (L < 1 || !layer) return (int)cudaErrorInvalidValue;
  Params p = params(xq, sx, q, s, z, out, ws, rs, tickets, M, N, K, ng, splits, split_rows, tma);
  p.layer = static_cast<const int*>(layer);
  p.L = L;
  p.q_stride = q_stride;
  p.s_stride = s_stride;
  return run<true>(p, decode, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of one block (for the build report).
extern "C" int lia_w4a8_smem_bytes(int decode, int K, int ng, int zp) {
  return lia_qmm::smem_bytes<lia_qmm::W4A8>(decode, K, ng, zp);
}
