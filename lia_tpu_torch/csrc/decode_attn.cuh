// Decode attention over one layer plane of a bf16 (or fp32) KV cache: the
// kernel body shared by decode_fresh.cu (the fresh token merged last, cache
// read-only) and decode.cu (the token already written, validity includes it).
//
// Math, all in fp32: q is scaled by scale*log2(e), keys in [start, length) of
// the plane go through an online softmax in exp2 units, and, with FRESH, the
// fresh key/value (not in the cache) is merged as the last tile;
// out = acc / max(l, 1e-30). start = length - popcount(slot_mask[b]) is
// counted on the device and length is read from device memory, so the caller
// never syncs with the host.
//
// What bounds it on an H100: bytes. Each (batch row, kv head) streams its
// [start, length) K and V rows once and does 4 FLOP per byte. Design: one
// block per (kv head, batch row); the four warps split the key range into
// contiguous chunks, each lane holds D/32 dimensions, so a warp reads whole
// rows (256 bytes at D = 128 in bf16); eight keys are loaded per step to keep
// loads in flight; the G query heads of a kv head share every K/V load (never
// replicated); partial (m, l, acc) of the warps merge in shared memory. A
// later PR splits long key ranges over more blocks (split-K) and stages K/V
// through TMA.
#pragma once

#include "common.cuh"

namespace lia_dec {

constexpr int NW = 4;  // warps per block
constexpr int KT = 8;  // keys per warp step

template <typename T, int D, int G, bool FRESH>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const T* __restrict__ q,       // [B, N, D]
              const T* __restrict__ kf,      // [B, Nkv, D] fresh key (FRESH only)
              const T* __restrict__ vf,      // [B, Nkv, D] fresh value (FRESH only)
              const T* __restrict__ kc,      // [B, Nkv, S_max, D] one layer's plane
              const T* __restrict__ vc,
              const uint8_t* __restrict__ slot_mask,  // [B, S_max]
              const int* __restrict__ lengths, int length_stride,  // [B] or scalar
              T* __restrict__ out,           // [B, N, D]
              int Nkv, int S_max, float sscale) {
  constexpr int DL = D / 32;  // dims per lane
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int N = Nkv * G;
  const int length = min(max(lengths[b * length_stride], 0), S_max);
  const int start = max(length - lia::block_count_true(slot_mask + (size_t)b * S_max, S_max), 0);

  float qr[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lia::load_vec<DL>(q + ((size_t)b * N + h * G + g) * D + lane * DL, qr[g]);
#pragma unroll
    for (int e = 0; e < DL; ++e) qr[g][e] *= sscale;
  }

  float m[G], l[G], acc[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = LIA_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;
  }

  const int chunk = (length - start + NW - 1) / NW;
  const int k0 = start + w * chunk, k1 = min(k0 + chunk, length);
  const size_t plane = ((size_t)b * Nkv + h) * S_max;
  const T* kb = kc + plane * D + lane * DL;
  const T* vb = vc + plane * D + lane * DL;

  for (int t0 = k0; t0 < k1; t0 += KT) {
    float kx[KT][DL], vx[KT][DL];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (t0 + kk < k1) {
        lia::load_vec<DL>(kb + (size_t)(t0 + kk) * D, kx[kk]);
        lia::load_vec<DL>(vb + (size_t)(t0 + kk) * D, vx[kk]);
      } else {
#pragma unroll
        for (int e = 0; e < DL; ++e) kx[kk][e] = vx[kk][e] = 0.f;
      }
    }
    float s[G][KT];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) part = fmaf(qr[g][e], kx[kk][e], part);
        s[g][kk] = lia::warp_sum(part);
      }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = LIA_NEG_INF;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        if (t0 + kk < k1) mt = fmaxf(mt, s[g][kk]);
      const float m_new = fmaxf(m[g], mt);
      const float alpha = exp2f(m[g] - m_new);
      float psum = 0.f, pv[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) pv[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (t0 + kk < k1) {
          const float p = exp2f(s[g][kk] - m_new);
          psum += p;
#pragma unroll
          for (int e = 0; e < DL; ++e) pv[e] = fmaf(p, vx[kk][e], pv[e]);
        }
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[g][e] = acc[g][e] * alpha + pv[e];
      m[g] = m_new;
    }
  }

  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float sm_acc[NW][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) sm_acc[w][g][lane * DL + e] = acc[g][e];
  }
  __syncthreads();
  if (w != 0) return;

  // merge the warps' partials, then (FRESH) the fresh token, always valid
  float kfx[DL], vfx[DL];
  if constexpr (FRESH) {
    lia::load_vec<DL>(kf + ((size_t)b * Nkv + h) * D + lane * DL, kfx);
    lia::load_vec<DL>(vf + ((size_t)b * Nkv + h) * D + lane * DL, vfx);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float M = LIA_NEG_INF, sf = 0.f;
    if constexpr (FRESH) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) part = fmaf(qr[g][e], kfx[e], part);
      sf = lia::warp_sum(part);
      M = sf;
    }
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][g]);
    float L = 0.f, o[DL];
#pragma unroll
    for (int e = 0; e < DL; ++e) o[e] = 0.f;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) {
      const float a = exp2f(sm_m[ww][g] - M);
      L += sm_l[ww][g] * a;
#pragma unroll
      for (int e = 0; e < DL; ++e) o[e] = fmaf(sm_acc[ww][g][lane * DL + e], a, o[e]);
    }
    if constexpr (FRESH) {
      const float pf = exp2f(sf - M);
      L += pf;
#pragma unroll
      for (int e = 0; e < DL; ++e) o[e] = fmaf(pf, vfx[e], o[e]);
    }
    L = fmaxf(L, 1e-30f);
    T* dst = out + ((size_t)b * N + h * G + g) * D + lane * DL;
#pragma unroll
    for (int e = 0; e < DL; ++e) dst[e] = lia::from_f32<T>(o[e] / L);
  }
}

template <typename T, int D, int G, bool FRESH>
int launch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc,
           const void* slot_mask, const void* lengths, int length_stride, void* out, int B,
           int Nkv, int S_max, float sscale, cudaStream_t stream) {
  dim3 grid(Nkv, B);
  decode_kernel<T, D, G, FRESH><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf),
      static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const uint8_t*>(slot_mask), static_cast<const int*>(lengths), length_stride,
      static_cast<T*>(out), Nkv, S_max, sscale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool FRESH>
int launch_g(int G, const void* q, const void* kf, const void* vf, const void* kc,
             const void* vc, const void* slot_mask, const void* lengths, int length_stride,
             void* out, int B, int Nkv, int S_max, float sscale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1, FRESH>(q, kf, vf, kc, vc, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    case 2: return launch<T, D, 2, FRESH>(q, kf, vf, kc, vc, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    case 4: return launch<T, D, 4, FRESH>(q, kf, vf, kc, vc, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    case 8: return launch<T, D, 8, FRESH>(q, kf, vf, kc, vc, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Type, head-dim and group dispatch. D must be 64 or 128 and G = N / Nkv one
// of 1, 2, 4, 8; returns a cudaError_t value, 0 on a successful launch.
template <bool FRESH>
int dispatch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc,
             const void* slot_mask, const void* lengths, int length_stride, void* out, int B,
             int N, int Nkv, int S_max, int D, float sscale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nkv <= 0 || N % Nkv != 0) return (int)cudaErrorInvalidValue;
  const int G = N / Nkv;
  if (is_bf16) {
    if (D == 128) return launch_g<__nv_bfloat16, 128, FRESH>(G, q, kf, vf, kc, vc, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    if (D == 64) return launch_g<__nv_bfloat16, 64, FRESH>(G, q, kf, vf, kc, vc, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
  } else {
    if (D == 128) return launch_g<float, 128, FRESH>(G, q, kf, vf, kc, vc, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    if (D == 64) return launch_g<float, 64, FRESH>(G, q, kf, vf, kc, vc, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace lia_dec
