// Helpers shared by the quantized-matmul kernels (w4a8_matmul.cu, woq_matmul.cu).
//
// Both kernels tile the output [M, N] into blocks of four warps, walk
// K inside the block in stages of STAGE_ROWS weight rows (packed rows for the
// 4-bit formats), and stage each weight tile in shared memory transposed to
// K-contiguous rows, the layout of an mma.sync B fragment. The activation tile
// of a stage (its rows of x over the stage's K range, both halves for packed
// weights) is copied to shared memory with cp.async, one stage ahead. For
// decode-sized M the K range is split over gridDim.z blocks writing fp32
// partials to a workspace [splits, M, N] that sum_splits adds up in a fixed
// order.
#pragma once

#include "common.cuh"

namespace lia {

constexpr int STAGE_ROWS = 64;  // weight rows per shared-memory stage

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));  // 0 source bytes: the 16 bytes are zero-filled
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Activation tile of one stage: rows [m0, m0 + BM) of x [M, K] (ES bytes an
// element), over weight rows [r0, r0 + STAGE_ROWS) of each of H halves (the
// high half starts at column K / 2), into dst [BM][pitch] bytes. Rows past M
// and columns past the block's row range (ke) are zero-filled.
template <int BM, int H, int ES, int NTH>
__device__ __forceinline__ void load_a_stage(uint8_t* dst, int pitch, const uint8_t* __restrict__ x,
                                             int m0, int M, int K, int r0, int ke, int tid) {
  constexpr int HALF_BYTES = STAGE_ROWS * ES, CH = HALF_BYTES / 16;
#pragma unroll 4
  for (int c = tid; c < BM * H * CH; c += NTH) {
    const int row = c / (H * CH), h = (c / CH) % H, kl = (c % CH) * (16 / ES);
    const int m = m0 + row;
    const bool valid = m < M && r0 + kl < ke;
    const uint8_t* src = x + ((size_t)m * K + (h ? K / 2 : 0) + r0 + kl) * ES;
    cp_async16(dst + row * pitch + h * HALF_BYTES + (c % CH) * 16, valid ? src : x, valid);
  }
}

// Weight rows each of gridDim.z blocks walks: whole `unit`s (a group, or a
// stage for per-channel weights), so no group is split between blocks.
__host__ __forceinline__ int rows_per_split(int rows, int unit, int splits) {
  const int units = (rows + unit - 1) / unit;
  return (units + splits - 1) / splits * unit;
}

// One 32-bit word of weight bytes at row r, columns [n, n + 4): a single load
// where the row is 4-byte aligned and whole, byte by byte at the ragged edge.
// Rows at or past row_end and columns at or past N read as zero bytes.
__device__ __forceinline__ uint32_t load_w32(const uint8_t* __restrict__ w, int r, int row_end,
                                             int n, int N, bool vec) {
  if (r >= row_end) return 0u;
  const uint8_t* p = w + (size_t)r * N + n;
  if (vec && n + 3 < N) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (n + c < N) v |= (uint32_t)__ldg(p + c) << (8 * c);
  return v;
}

// Output tile (or this split's partial) back to memory, masked at the edges.
// acc is a warp's [MT][NT] mma C fragments.
template <int MT, int NT>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float (&acc)[MT][NT][4],
                                           int m_base, int n_base, int M, int N, int lane,
                                           const float* __restrict__ row_scale) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + mt * 16 + gq + 8 * h;
      if (m >= M) continue;
      const float rs = row_scale ? row_scale[m] : 1.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_base + nt * 8 + tq * 2 + e;
          if (n < N) dst[(size_t)m * N + n] = acc[mt][nt][2 * h + e] * rs;
        }
    }
}

__global__ void sum_splits(const float* __restrict__ ws, float* __restrict__ out, size_t mn,
                           int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float a = 0.f;
  for (int z = 0; z < splits; ++z) a += ws[z * mn + i];
  out[i] = a;
}

__host__ inline int launch_sum_splits(const float* ws, float* out, size_t mn, int splits,
                                      cudaStream_t stream) {
  const int threads = 256;
  sum_splits<<<(unsigned)((mn + threads - 1) / threads), threads, 0, stream>>>(ws, out, mn, splits);
  return (int)cudaGetLastError();
}

}  // namespace lia
