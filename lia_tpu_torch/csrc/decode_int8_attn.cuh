// Decode attention of one layer over an INT8 KV cache with per-token f32
// scales, the fresh token merged last: the kernel body shared by
// decode_fresh_int8.cu (a contiguous cache plane) and beam_decode_int8.cu (a
// beam's group prompt plane, then its own generated tail).
//
// Math, as the TPU kernels': q stays in its own type and the dot with the
// int8 key codes accumulates in fp32 (int8 values and their products with
// bf16 are exact there); the K scale and the softmax scale multiply the score
// after the dot, s * (ks * scale*log2(e)); the V scale multiplies the
// probability, and p * vs is rounded to q's type before it meets the value
// codes, as the TPU kernel feeds bf16 probs to its P.V dot. The fresh token
// merges in fp32 last; out = acc / max(l, 1e-30).
//
// How the fresh token arrives is a template flag (RAW):
// - raw (decode_fresh_int8.cu): unquantized, in q's type. The reference
//   quantizes it and dequantizes it again before the call, in separate XLA
//   ops, so attention sees what later steps read back from the cache; here
//   warp 0 does the same in the kernel, bit for bit (fp32 amax over D, scale =
//   max(amax/127, 1e-8), codes = clip(rint(x/scale), -128, 127), value =
//   code*scale rounded to q's type), which saves the caller four
//   quantize/dequantize passes of several launches each per layer;
// - already dequantized (beam_decode_int8.cu): the caller quantizes the fresh
//   K/V anyway for the tail commit and passes their dequantized values, as the
//   reference does (lia_tpu/ops/attention.py:507-508).
//
// Where the keys live is the other template flag (BEAM):
// - a plane [B, Nkv, S_max, D] (+ scales [B, Nkv, S_max]): key t of (b, h)
//   at row (b * Nkv + h) * S_max + t, validity [start, length), start =
//   length - popcount(slot_mask[b]);
// - the grouped beam cache: keys [pstart_g, plen) of the prompt plane [B0,
//   Nkv, S_p, D] of group g = b / nb at row (g * Nkv + h) * S_p + t, then keys
//   [0, tlen) of the beam's tail [B0 * nb, Nkv, T_max, D] at row (b * Nkv + h)
//   * T_max + t - plen, as one virtual range [pstart_g, plen + tlen); plen,
//   tlen and the prompt mask are read on the device, and blocks run beams
//   innermost (blockIdx.x = b) so the L2 serves the group's repeated prompt
//   reads. A warp walks the prompt part of its chunk, then the tail part,
//   each from its own base pointers, as over a plane (choosing the plane per
//   key took 204 registers a thread against 122 in nvcc's sm_90a build).
//
// What bounds it on an H100: bytes, half of the bf16 kernel's (int8 codes
// plus one f32 scale per 128-byte row). Design as decode_attn.cuh: one block
// per (kv head, batch row), four warps splitting the key range, each lane
// holding D/32 dimensions (4 bytes of codes at D=128), eight keys per step,
// warp partials merged in shared memory, fresh token last. A later PR splits
// long ranges over more blocks and widens the per-lane loads.
#pragma once

#include "common.cuh"

namespace lia_dec8 {

constexpr int NW = 4;
constexpr int KT = 8;

// The keys of one layer: codes and scales of a plane or of the beam cache's
// group prompt plane (slot_mask: the plane's [B, S_max] or the prompt mask
// [B0, S_p], S_max = S_p); with BEAM, the tail's codes and scales [B, Nkv,
// T_max(, D)], nb beams a group and the tail length on the device.
struct Keys {
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const uint8_t* slot_mask;
  int S_max;
  const int8_t* ktq;
  const float* kts;
  const int8_t* vtq;
  const float* vts;
  int T_max, nb;
  const int* tail_len;
};

template <int N>
__device__ __forceinline__ void load_codes(const int8_t* p, float* out) {
  if constexpr (N == 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = p[e];
  }
}

// One token row of D values spread over a warp (DL per lane), replaced by its
// int8 round trip: per-token symmetric scale, as ops/quant.py:quantize_kv then
// dequantize_kv(x, T).
template <typename T, int DL>
__device__ __forceinline__ void quant_dequant(float* x) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < DL; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(amax / 127.0f, 1e-8f);
#pragma unroll
  for (int e = 0; e < DL; ++e) {
    const float code = fminf(fmaxf(rintf(x[e] / scale), -128.f), 127.f);
    x[e] = lia::round_to<T>(code * scale);
  }
}

template <typename T, int D, int G, bool RAW, bool BEAM>
__global__ void __launch_bounds__(NW * 32)
decode_int8_kernel(const T* __restrict__ q,   // [B, N, D]
                   const T* __restrict__ kf,  // [B, Nkv, D] fresh key (raw or dequantized)
                   const T* __restrict__ vf,
                   Keys keys,
                   const int* __restrict__ lengths, int length_stride,  // plane: [B] or scalar; beam: plen
                   T* __restrict__ out,       // [B, N, D]
                   int Nkv, float sscale) {
  constexpr int DL = D / 32;
  const int h = BEAM ? blockIdx.y : blockIdx.x;
  const int b = BEAM ? blockIdx.x : blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int N = Nkv * G;
  int start, length, plen = 0;
  if constexpr (BEAM) {
    plen = min(max(lengths[0], 0), keys.S_max);
    length = plen + min(max(*keys.tail_len, 0), keys.T_max);
    start = max(plen - lia::block_count_true(keys.slot_mask + (size_t)(b / keys.nb) * keys.S_max, keys.S_max), 0);
  } else {
    length = min(max(lengths[b * length_stride], 0), keys.S_max);
    start = max(length - lia::block_count_true(keys.slot_mask + (size_t)b * keys.S_max, keys.S_max), 0);
  }
  float qr[G][DL];  // q in its own type's values, unscaled
#pragma unroll
  for (int g = 0; g < G; ++g) lia::load_vec<DL>(q + ((size_t)b * N + h * G + g) * D + lane * DL, qr[g]);

  float m[G], l[G], acc[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = LIA_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;
  }

  // the online softmax over keys [lo, hi), key t's codes at kq/vq + t * D and
  // its scales at ks/vs + t
  auto walk = [&](const int8_t* __restrict__ kq, const float* __restrict__ ks, const int8_t* __restrict__ vq,
                  const float* __restrict__ vs, int lo, int hi) {
    for (int t0 = lo; t0 < hi; t0 += KT) {
      float kx[KT][DL], vx[KT][DL], kscale[KT], vscale[KT];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const int t = t0 + kk;
        if (t < hi) {
          load_codes<DL>(kq + (size_t)t * D + lane * DL, kx[kk]);
          load_codes<DL>(vq + (size_t)t * D + lane * DL, vx[kk]);
          kscale[kk] = ks[t] * sscale;
          vscale[kk] = vs[t];
        } else {
#pragma unroll
          for (int e = 0; e < DL; ++e) kx[kk][e] = vx[kk][e] = 0.f;
          kscale[kk] = vscale[kk] = 0.f;
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
          s[g][kk] = lia::warp_sum(part) * kscale[kk];
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mt = LIA_NEG_INF;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          if (t0 + kk < hi) mt = fmaxf(mt, s[g][kk]);
        const float m_new = fmaxf(m[g], mt);
        const float alpha = exp2f(m[g] - m_new);
        float psum = 0.f, pv[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e) pv[e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          if (t0 + kk < hi) {
            const float p = exp2f(s[g][kk] - m_new);
            psum += p;
            const float pw = lia::round_to<T>(p * vscale[kk]);
#pragma unroll
            for (int e = 0; e < DL; ++e) pv[e] = fmaf(pw, vx[kk][e], pv[e]);
          }
        }
        l[g] = l[g] * alpha + psum;
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[g][e] = acc[g][e] * alpha + pv[e];
        m[g] = m_new;
      }
    }
  };

  const int chunk = (length - start + NW - 1) / NW;
  const int k0 = start + w * chunk, k1 = min(k0 + chunk, length);
  if constexpr (BEAM) {
    // this warp's prompt keys [k0, plen) of the group's plane, then its tail
    // keys, tail slot t - plen of the beam's own plane
    const size_t pr = ((size_t)(b / keys.nb) * Nkv + h) * keys.S_max;
    const size_t tr = ((size_t)b * Nkv + h) * keys.T_max;
    walk(keys.kq + pr * D, keys.ks + pr, keys.vq + pr * D, keys.vs + pr, k0, min(k1, plen));
    walk(keys.ktq + tr * D, keys.kts + tr, keys.vtq + tr * D, keys.vts + tr, max(k0, plen) - plen, k1 - plen);
  } else {
    const size_t pr = ((size_t)b * Nkv + h) * keys.S_max;
    walk(keys.kq + pr * D, keys.ks + pr, keys.vq + pr * D, keys.vs + pr, k0, k1);
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

  float kfx[DL], vfx[DL];
  lia::load_vec<DL>(kf + ((size_t)b * Nkv + h) * D + lane * DL, kfx);
  lia::load_vec<DL>(vf + ((size_t)b * Nkv + h) * D + lane * DL, vfx);
  if constexpr (RAW) {
    quant_dequant<T, DL>(kfx);
    quant_dequant<T, DL>(vfx);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) part = fmaf(qr[g][e] * sscale, kfx[e], part);
    const float sf = lia::warp_sum(part);
    float M = sf;
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
    const float pf = exp2f(sf - M);
    L = fmaxf(L + pf, 1e-30f);
    T* dst = out + ((size_t)b * N + h * G + g) * D + lane * DL;
#pragma unroll
    for (int e = 0; e < DL; ++e) dst[e] = lia::from_f32<T>(fmaf(pf, vfx[e], o[e]) / L);
  }
}

template <typename T, int D, int G, bool RAW, bool BEAM>
int launch(const void* q, const void* kf, const void* vf, const Keys& keys, const void* lengths,
           int length_stride, void* out, int B, int Nkv, float sscale, cudaStream_t stream) {
  const dim3 grid = BEAM ? dim3(B, Nkv) : dim3(Nkv, B);
  decode_int8_kernel<T, D, G, RAW, BEAM><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf), keys,
      static_cast<const int*>(lengths), length_stride, static_cast<T*>(out), Nkv, sscale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool RAW, bool BEAM>
int launch_g(int G, const void* q, const void* kf, const void* vf, const Keys& keys,
             const void* lengths, int length_stride, void* out, int B, int Nkv, float sscale,
             cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1, RAW, BEAM>(q, kf, vf, keys, lengths, length_stride, out, B, Nkv, sscale, st);
    case 2: return launch<T, D, 2, RAW, BEAM>(q, kf, vf, keys, lengths, length_stride, out, B, Nkv, sscale, st);
    case 4: return launch<T, D, 4, RAW, BEAM>(q, kf, vf, keys, lengths, length_stride, out, B, Nkv, sscale, st);
    case 8: return launch<T, D, 8, RAW, BEAM>(q, kf, vf, keys, lengths, length_stride, out, B, Nkv, sscale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Type, head-dim and group dispatch. D must be 64 or 128 and G = N / Nkv one
// of 1, 2, 4, 8; returns a cudaError_t value, 0 on a successful launch.
template <bool RAW, bool BEAM>
int dispatch(const void* q, const void* kf, const void* vf, const Keys& keys, const void* lengths,
             int length_stride, void* out, int B, int N, int Nkv, int D, float sscale, int is_bf16,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nkv <= 0 || N % Nkv != 0) return (int)cudaErrorInvalidValue;
  const int G = N / Nkv;
  if (is_bf16) {
    if (D == 128) return launch_g<__nv_bfloat16, 128, RAW, BEAM>(G, q, kf, vf, keys, lengths, length_stride, out, B, Nkv, sscale, st);
    if (D == 64) return launch_g<__nv_bfloat16, 64, RAW, BEAM>(G, q, kf, vf, keys, lengths, length_stride, out, B, Nkv, sscale, st);
  } else {
    if (D == 128) return launch_g<float, 128, RAW, BEAM>(G, q, kf, vf, keys, lengths, length_stride, out, B, Nkv, sscale, st);
    if (D == 64) return launch_g<float, 64, RAW, BEAM>(G, q, kf, vf, keys, lengths, length_stride, out, B, Nkv, sscale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace lia_dec8
