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
// Every thread must call it (it synchronises the block).
__device__ __forceinline__ int block_count_true(const uint8_t* mask, int n) {
  int count = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    count += __syncthreads_count(i < n && mask[i] != 0);
  }
  return count;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace lia
