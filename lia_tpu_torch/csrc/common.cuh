// Helpers shared by the attention kernels of lia_tpu_torch.
//
// The kernels are compiled by nvcc for sm_90a into shared libraries with a
// plain C interface and bound with ctypes (lia_tpu_torch/ops/_build.py): no
// PyTorch header is included, so each library builds in seconds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Large-negative mask value, as in the TPU kernels: a true -inf turns a fully
// masked row into inf - inf = NaN; -1e30 keeps every intermediate finite.
#define LIA_NEG_INF (-1e30f)

namespace lia {

// ALiBi: a kernel given per-query-head slopes (fp32 [N], or null) adds
// slope * log2(e) * (key_pos - query_pos) to each score after the scaled dot
// product, in fp32, its positions taken from the layout it walks. The
// softmax is invariant to a per-query constant, so this is the reference's
// key-only bias slope * key_pos; it keeps each biased score at or below its
// dot product, and the fresh token's term is 0. Returns the head's slope in
// exp2 units, 0 without slopes.
__device__ __forceinline__ float alibi_slope(const float* slopes, int head) {
  return slopes ? slopes[head] * 1.4426950408889634f : 0.f;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision (round to nearest even), returned as float.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Two adjacent elements as floats. bf16 pairs must be 4-byte aligned.
__device__ __forceinline__ float2 load_pair(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// N contiguous elements (N even) as floats.
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    float2 v = load_pair(p + e);
    out[e] = v.x;
    out[e + 1] = v.y;
  }
}

// Number of nonzero bytes in mask[0, n), returned to every thread of the block.
// Every thread must call it (it synchronises the block). Each thread counts 16
// bytes a round with one 16-byte load where the bytes are aligned, so a mask of
// up to 16 * blockDim.x bytes costs one memory round trip, and the block adds
// the counts (at most 16, five bits) bit by bit with __syncthreads_count.
__device__ __forceinline__ int block_count_true(const uint8_t* mask, int n) {
  int count = 0;
  for (int i0 = 0; i0 < n; i0 += 16 * blockDim.x) {
    const int i = i0 + 16 * threadIdx.x;
    int c = 0;
    if (i + 16 <= n && (reinterpret_cast<uintptr_t>(mask + i) & 15) == 0) {
      const uint4 w = *reinterpret_cast<const uint4*>(mask + i);
      c = (__popc(__vcmpne4(w.x, 0)) + __popc(__vcmpne4(w.y, 0)) + __popc(__vcmpne4(w.z, 0)) +
           __popc(__vcmpne4(w.w, 0))) >> 3;
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) c += i + e < n && mask[i + e] != 0;
    }
#pragma unroll
    for (int bit = 0; bit < 5; ++bit) count += __syncthreads_count((c >> bit) & 1) << bit;
  }
  return count;
}

// 16 bytes from global to shared memory, asynchronously; zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));  // 0 source bytes: the 16 bytes are zero-filled
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The width the attention bodies compute over for head dim D (64, 80, 96,
// 112, 128 or 256: 80, 96 and 112 over the 128-wide bodies, zero-padded), 0
// for any other.
inline int padded_dim(int D) {
  return D == 64 ? 64 : (D == 80 || D == 96 || D == 112 || D == 128) ? 128 : D == 256 ? 256 : 0;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace lia
