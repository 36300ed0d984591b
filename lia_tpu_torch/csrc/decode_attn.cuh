// Decode attention of one layer, bf16 (or fp32): the kernel body shared by
// decode_fresh.cu (a contiguous cache plane, the fresh token merged last, the
// cache read-only), decode.cu (the plane already holds the token, validity
// includes it) and paged_decode.cu (a paged pool walked through a block table,
// a fresh chunk of C tokens merged last with the causal triangle).
//
// Math, all in fp32: q is scaled by scale*log2(e), the valid keys go through
// an online softmax in exp2 units, and, with FRESH, chunk row c merges the
// fresh keys/values 0..c (not in the cache) last; out = acc / max(l, 1e-30),
// so a row with no valid key and no fresh token comes out 0. Lengths are read
// from device memory, so the caller never syncs with the host.
//
// Where the keys live is a template parameter, and only the key address
// differs between the two:
// - a plane [B, Nkv, S_max, D]: key t of (b, h) at ((b * Nkv + h) * S_max + t),
//   validity [start, length), start = length - popcount(slot_mask[b]) counted
//   on the device;
// - a paged pool layer [nb, Nkv, bs, D]: key t of (b, h) at page
//   table[b, t / bs], slot t % bs; validity [0, length). Pages past the
//   frontier (the null page 0 in unused table entries) are never read.
//
// What bounds it on an H100: bytes. Each (batch row, kv head) streams its
// valid K and V rows once and does 4 FLOP per byte. Design: one block per
// (kv head, batch row, chunk row); the four warps split the key range into
// contiguous chunks, each lane holds D/32 dimensions, so a warp reads whole
// rows (256 bytes at D = 128 in bf16); eight keys are loaded per step to keep
// loads in flight; the G query heads of a kv head share every K/V load (never
// replicated); partial (m, l, acc) of the warps merge in shared memory. With
// C > 1 (speculative verify) each chunk row's block reads the keys again, from
// L2. A later PR splits long key ranges over more blocks (split-K) and stages
// K/V through TMA.
#pragma once

#include "common.cuh"

namespace lia_dec {

constexpr int NW = 4;  // warps per block
constexpr int KT = 8;  // keys per warp step

// The keys of one layer: a plane (slot_mask, S_max) or a paged pool layer
// (table [B, P], page size bs).
struct Keys {
  const uint8_t* slot_mask;
  int S_max;
  const int* table;
  int P, bs;
};

template <typename T, int D, int G, bool FRESH, bool PAGED>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const T* __restrict__ q,       // [B, C, N, D]
              const T* __restrict__ kf,      // [B, Nkv, C, D] fresh keys (FRESH only)
              const T* __restrict__ vf,      // [B, Nkv, C, D] fresh values (FRESH only)
              const T* __restrict__ kc,      // one layer's plane or pool layer
              const T* __restrict__ vc,
              Keys keys,
              const int* __restrict__ lengths, int length_stride,  // [B] or scalar
              T* __restrict__ out,           // [B, C, N, D]
              int Nkv, int C, float sscale) {
  constexpr int DL = D / 32;  // dims per lane
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int N = Nkv * G;
  int start, length;
  if constexpr (PAGED) {
    length = min(max(lengths[b * length_stride], 0), keys.P * keys.bs);
    start = 0;
  } else {
    length = min(max(lengths[b * length_stride], 0), keys.S_max);
    start = max(length - lia::block_count_true(keys.slot_mask + (size_t)b * keys.S_max, keys.S_max), 0);
  }
  // element offset of key t's row
  auto key_row = [&](int t) -> size_t {
    if constexpr (PAGED) {
      const int page = keys.table[(size_t)b * keys.P + t / keys.bs];
      return (((size_t)page * Nkv + h) * keys.bs + t % keys.bs) * D;
    } else {
      return (((size_t)b * Nkv + h) * keys.S_max + t) * D;
    }
  };

  float qr[G][DL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lia::load_vec<DL>(q + (((size_t)b * C + c) * N + h * G + g) * D + lane * DL, qr[g]);
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

  for (int t0 = k0; t0 < k1; t0 += KT) {
    float kx[KT][DL], vx[KT][DL];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (t0 + kk < k1) {
        const size_t row = key_row(t0 + kk) + lane * DL;
        lia::load_vec<DL>(kc + row, kx[kk]);
        lia::load_vec<DL>(vc + row, vx[kk]);
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

  // merge the warps' partials, then (FRESH) the fresh keys 0..c, always valid:
  // the first pass finds the maximum, the second sums
  const size_t fresh = ((size_t)b * Nkv + h) * C;
  auto fresh_score = [&](int g, int j) -> float {
    float kfx[DL];
    lia::load_vec<DL>(kf + (fresh + j) * D + lane * DL, kfx);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) part = fmaf(qr[g][e], kfx[e], part);
    return lia::warp_sum(part);
  };
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float M = LIA_NEG_INF;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][g]);
    if constexpr (FRESH) {
      for (int j = 0; j <= c; ++j) M = fmaxf(M, fresh_score(g, j));
    }
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
      for (int j = 0; j <= c; ++j) {
        const float pf = exp2f(fresh_score(g, j) - M);
        float vfx[DL];
        lia::load_vec<DL>(vf + (fresh + j) * D + lane * DL, vfx);
        L += pf;
#pragma unroll
        for (int e = 0; e < DL; ++e) o[e] = fmaf(pf, vfx[e], o[e]);
      }
    }
    L = fmaxf(L, 1e-30f);
    T* dst = out + (((size_t)b * C + c) * N + h * G + g) * D + lane * DL;
#pragma unroll
    for (int e = 0; e < DL; ++e) dst[e] = lia::from_f32<T>(o[e] / L);
  }
}

template <typename T, int D, int G, bool FRESH, bool PAGED>
int launch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc,
           Keys keys, const void* lengths, int length_stride, void* out, int B, int Nkv, int C,
           float sscale, cudaStream_t stream) {
  dim3 grid(Nkv, B, C);
  decode_kernel<T, D, G, FRESH, PAGED><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf),
      static_cast<const T*>(kc), static_cast<const T*>(vc), keys,
      static_cast<const int*>(lengths), length_stride, static_cast<T*>(out), Nkv, C, sscale);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool FRESH, bool PAGED>
int launch_g(int G, const void* q, const void* kf, const void* vf, const void* kc,
             const void* vc, Keys keys, const void* lengths, int length_stride, void* out, int B,
             int Nkv, int C, float sscale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1, FRESH, PAGED>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, C, sscale, st);
    case 2: return launch<T, D, 2, FRESH, PAGED>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, C, sscale, st);
    case 4: return launch<T, D, 4, FRESH, PAGED>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, C, sscale, st);
    case 8: return launch<T, D, 8, FRESH, PAGED>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, C, sscale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Type, head-dim and group dispatch. D must be 64 or 128, G = N / Nkv one of
// 1, 2, 4, 8, and C >= 1 (1 over a plane); returns a cudaError_t value, 0 on
// a successful launch.
template <bool FRESH, bool PAGED>
int dispatch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc,
             Keys keys, const void* lengths, int length_stride, void* out, int B, int C, int N,
             int Nkv, int D, float sscale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nkv <= 0 || N % Nkv != 0 || C < 1 || (!PAGED && C != 1)) return (int)cudaErrorInvalidValue;
  const int G = N / Nkv;
  if (is_bf16) {
    if (D == 128) return launch_g<__nv_bfloat16, 128, FRESH, PAGED>(G, q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, C, sscale, st);
    if (D == 64) return launch_g<__nv_bfloat16, 64, FRESH, PAGED>(G, q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, C, sscale, st);
  } else {
    if (D == 128) return launch_g<float, 128, FRESH, PAGED>(G, q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, C, sscale, st);
    if (D == 64) return launch_g<float, 64, FRESH, PAGED>(G, q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, C, sscale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace lia_dec
