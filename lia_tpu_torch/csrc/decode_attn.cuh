// Decode attention of one layer in fp32: the warp body behind the fp32 calls
// of decode_fresh.cu (B2: a contiguous cache plane, the fresh token merged
// last), decode.cu (B7/B8: the plane already holds the token, validity
// includes it) and beam_decode.cu (B9: a beam's group prompt plane, then its
// own generated tail, then the fresh token). fp32 calls come from the tests
// and the CPU-parity tools; no model path on the card runs fp32. Every bf16
// call runs a Hopper body instead: plane_attn.cuh (B2, B7/B8 at one query
// head a kv head: PLANE_MAX_GROUP) or beam_attn.cuh (B9, and B2, B7/B8 past
// it).
//
// Math, all in fp32: q is scaled by scale*log2(e), the valid keys go through
// an online softmax in exp2 units, and, with FRESH, the fresh key/value (not
// in the cache) merges last; out = acc / max(l, 1e-30),
// so a row with no valid key and no fresh token comes out 0. Lengths are read
// from device memory, so the caller never syncs with the host. With ALiBi
// slopes (common.cuh: alibi_slope) virtual key t scores slope * log2(e) * (t -
// length) more; the fresh token, at the length, 0.
//
// Where the keys live is a template parameter (SRC), and only the key address
// differs between the two:
// - kPlane, a plane [B, Nkv, S_max, D]: key t of (b, h) at ((b * Nkv + h) *
//   S_max + t), validity [start, length), start = length - popcount(slot_mask[b])
//   counted on the device;
// - kBeam, the grouped beam cache: one virtual key range [pstart_g, plen +
//   tlen) over two planes. Key t < plen sits in the prompt plane [B0, Nkv, S_p,
//   D] of the beam's group g = b / nb at ((g * Nkv + h) * S_p + t); key t >=
//   plen in the beam's own tail [B0 * nb, Nkv, T_max, D] at ((b * Nkv + h) *
//   T_max + t - plen). plen (the length pointer), tlen and the prompt mask are
//   read on the device, pstart_g = plen - popcount(prompt_mask[g]). A warp
//   walks the prompt part of its chunk of the virtual range, then the tail
//   part, each as a plane walk from its own base pointer.
//
// The design (the port's first decode body, kept for its exactness in fp32,
// not for speed): one block per (kv head, batch row, chunk of query heads);
// the four warps split the key range into contiguous chunks, each lane holds
// DP / 32 dims, eight keys (four at DP = 256) are loaded into registers per
// step, the block's query heads share every K/V load, and the warps' partial
// (m, l, acc) merge in shared memory.
//
// Query-head groups: a block holds GC = 1, 2, 4 or 8 of the G query heads of
// its kv head in registers (GC = G for G of 1, 2, 4 and 8, the next of those
// above a smaller G, 8 above 8; at most 4 at DP = 256), and G > 8 heads go to
// ceil(G / 8) blocks, a grid dimension of query chunks. The last chunk may be
// ragged (Falcon-7B's G = 71 is 8 x 8 + 7): its missing heads take q = 0, so
// their scores stay finite, and are never stored.
//
// Head dims: a lane holds DP / 32 dims of a width DP of 64, 128 or 256, and
// rows lie D apart (both template parameters): at D = 80, 96 and 112 (DP = 128)
// the lanes past D / 4 hold zeros, read nothing and store nothing.
#pragma once

#include "common.cuh"

namespace lia_dec {

constexpr int NW = 4;  // warps per block

// Keys per warp step, and query heads a block holds at most, at width DP.
__host__ __device__ constexpr int keys_a_step(int DP) { return DP > 128 ? 4 : 8; }
__host__ __device__ constexpr int max_cols(int DP) { return DP > 128 ? 4 : 8; }

enum : int { kPlane = 0, kBeam = 1 };  // where the keys live (SRC)

// The keys of one layer: a plane (slot_mask [B, S_max]) or the grouped beam cache (slot_mask: the
// prompt mask [B0, S_p] with S_max = S_p; the tail planes kt/vt [B, Nkv,
// T_max, D], nb beams a group, the tail length on the device).
struct Keys {
  const uint8_t* slot_mask;
  int S_max;
  const void* kt;
  const void* vt;
  int T_max, nb;
  const int* tail_len;
};

template <typename T, int DP, int D, int GC, bool FRESH, int SRC, bool CHUNKED>
__global__ void __launch_bounds__(NW * 32)
decode_kernel(const T* __restrict__ q,       // [B, N, D]
              const T* __restrict__ kf,      // [B, Nkv, D] fresh keys (FRESH only)
              const T* __restrict__ vf,      // [B, Nkv, D] fresh values (FRESH only)
              const T* __restrict__ kc,      // one layer's plane or group prompt plane
              const T* __restrict__ vc,
              Keys keys,
              const int* __restrict__ lengths, int length_stride,  // [B] or scalar
              T* __restrict__ out,           // [B, N, D]
              int Nkv, int G, int chunks, float sscale,
              const float* __restrict__ slopes) {  // ALiBi [N], or null
  constexpr int DL = DP / 32;  // dims per lane
  constexpr int KT = keys_a_step(DP);
  // CHUNKED: kv head * chunks + query chunk, heads g0 .. g0 + GC - 1 of the
  // group; else G == GC, one block a kv head (compile-time group)
  const int hc = SRC == kBeam ? blockIdx.y : blockIdx.x;
  const int h = CHUNKED ? hc / chunks : hc, g0 = CHUNKED ? (hc % chunks) * GC : 0;
  if (!CHUNKED) G = GC;
  const int b = SRC == kBeam ? blockIdx.x : blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool on = D == DP || lane * DL < D;  // the lane's dims lie inside the row
  const int N = Nkv * G;
  int start, length, plen = 0;
  if constexpr (SRC == kBeam) {
    const int g = b / keys.nb;
    plen = min(max(lengths[0], 0), keys.S_max);
    length = plen + min(max(*keys.tail_len, 0), keys.T_max);
    start = max(plen - lia::block_count_true(keys.slot_mask + (size_t)g * keys.S_max, keys.S_max), 0);
  } else {
    length = min(max(lengths[b * length_stride], 0), keys.S_max);
    start = max(length - lia::block_count_true(keys.slot_mask + (size_t)b * keys.S_max, keys.S_max), 0);
  }
  float qr[GC][DL], sl[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    sl[g] = !CHUNKED || g0 + g < G ? lia::alibi_slope(slopes, h * G + g0 + g) : 0.f;
    if ((!CHUNKED || g0 + g < G) && on) {
      lia::load_vec<DL>(q + ((size_t)b * N + h * G + g0 + g) * D + lane * DL, qr[g]);
    } else {  // a ragged last chunk's missing head, or dims past D
#pragma unroll
      for (int e = 0; e < DL; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) qr[g][e] *= sscale;
  }

  float m[GC], l[GC], acc[GC][DL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = LIA_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[g][e] = 0.f;
  }

  // the online softmax over keys [lo, hi), key t's K and V rows at kb/vb +
  // row(t) (an element offset), its ALiBi position against the query t + kpos
  auto walk = [&](const T* __restrict__ kb, const T* __restrict__ vb, int lo, int hi, int kpos, auto row) {
    for (int t0 = lo; t0 < hi; t0 += KT) {
      float kx[KT][DL], vx[KT][DL];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (t0 + kk < hi && on) {
          const size_t r = row(t0 + kk) + lane * DL;
          lia::load_vec<DL>(kb + r, kx[kk]);
          lia::load_vec<DL>(vb + r, vx[kk]);
        } else {
#pragma unroll
          for (int e = 0; e < DL; ++e) kx[kk][e] = vx[kk][e] = 0.f;
        }
      }
      float s[GC][KT];
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < DL; ++e) part = fmaf(qr[g][e], kx[kk][e], part);
          s[g][kk] = fmaf(sl[g], (float)(t0 + kk + kpos), lia::warp_sum(part));
        }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
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
  };

  const int chunk = (length - start + NW - 1) / NW;
  const int k0 = start + w * chunk, k1 = min(k0 + chunk, length);
  const auto plane_row = [](int t) -> size_t { return (size_t)t * D; };
  if constexpr (SRC == kBeam) {
    // this warp's prompt keys [k0, plen) of the group's plane, then its tail
    // keys, tail slot t - plen of the beam's own plane
    const size_t pb = ((size_t)(b / keys.nb) * Nkv + h) * keys.S_max * D;
    const size_t tb = ((size_t)b * Nkv + h) * keys.T_max * D;
    walk(kc + pb, vc + pb, k0, min(k1, plen), -length, plane_row);
    walk(static_cast<const T*>(keys.kt) + tb, static_cast<const T*>(keys.vt) + tb, max(k0, plen) - plen,
         k1 - plen, plen - length, plane_row);
  } else {
    const size_t pb = ((size_t)b * Nkv + h) * keys.S_max * D;
    walk(kc + pb, vc + pb, k0, k1, -length, plane_row);
  }

  __shared__ float sm_m[NW][GC], sm_l[NW][GC];
  __shared__ float sm_acc[NW][GC][DP];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) sm_acc[w][g][lane * DL + e] = acc[g][e];
  }
  __syncthreads();
  if (w != 0) return;

  // merge the warps' partials, then (FRESH) the fresh key, always valid: the
  // first pass finds the maximum, the second sums
  const size_t fresh = ((size_t)b * Nkv + h) * D + lane * DL;
  auto fresh_score = [&](int g) -> float {
    float kfx[DL] = {};
    if (on) lia::load_vec<DL>(kf + fresh, kfx);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) part = fmaf(qr[g][e], kfx[e], part);
    return lia::warp_sum(part);
  };
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float M = LIA_NEG_INF;
#pragma unroll
    for (int ww = 0; ww < NW; ++ww) M = fmaxf(M, sm_m[ww][g]);
    if constexpr (FRESH) {
      M = fmaxf(M, fresh_score(g));
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
      const float pf = exp2f(fresh_score(g) - M);
      float vfx[DL] = {};
      if (on) lia::load_vec<DL>(vf + fresh, vfx);
      L += pf;
#pragma unroll
      for (int e = 0; e < DL; ++e) o[e] = fmaf(pf, vfx[e], o[e]);
    }
    if ((CHUNKED && g0 + g >= G) || !on) continue;  // never stored
    L = fmaxf(L, 1e-30f);
    T* dst = out + ((size_t)b * N + h * G + g0 + g) * D + lane * DL;
#pragma unroll
    for (int e = 0; e < DL; ++e) dst[e] = lia::from_f32<T>(o[e] / L);
  }
}

template <typename T, int DP, int D, int GC, bool FRESH, int SRC, bool CHUNKED>
int launch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc,
           Keys keys, const void* lengths, int length_stride, void* out, int B, int Nkv, int G,
           float sscale, const float* slopes, cudaStream_t stream) {
  const int chunks = (G + GC - 1) / GC;
  const dim3 grid = SRC == kBeam ? dim3(B, Nkv * chunks) : dim3(Nkv * chunks, B);
  decode_kernel<T, DP, D, GC, FRESH, SRC, CHUNKED><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf),
      static_cast<const T*>(kc), static_cast<const T*>(vc), keys,
      static_cast<const int*>(lengths), length_stride, static_cast<T*>(out), Nkv, G, chunks, sscale, slopes);
  return (int)cudaGetLastError();
}

// Query heads a block holds for a group of G at width DP (the GC of the
// header): the group itself up to max_cols(DP) where it is 1, 2, 4 or 8,
// else runs of max_cols(DP) (4 for G = 3 at D = 64 and 128).
template <typename T, int DP, int D, bool FRESH, int SRC>
int launch_g(int G, const void* q, const void* kf, const void* vf, const void* kc,
             const void* vc, Keys keys, const void* lengths, int length_stride, void* out, int B,
             int Nkv, float sscale, const float* slopes, cudaStream_t st) {
  constexpr int GMAX = max_cols(DP);
  if (G < 1) return (int)cudaErrorInvalidValue;
  switch (G) {  // a whole group a block, the group compile-time
    case 1: return launch<T, DP, D, 1, FRESH, SRC, false>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, G, sscale, slopes, st);
    case 2: return launch<T, DP, D, 2, FRESH, SRC, false>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, G, sscale, slopes, st);
    case 4: return launch<T, DP, D, 4, FRESH, SRC, false>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, G, sscale, slopes, st);
    case 8:
      if constexpr (GMAX == 8)
        return launch<T, DP, D, 8, FRESH, SRC, false>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, G, sscale, slopes, st);
      break;
  }
  if constexpr (GMAX == 8 && D == DP) {  // at D = 80, 96 and 112 G = 3 takes a run of 8 (a run of 4 spilled there)
    if (G == 3)
      return launch<T, DP, D, 4, FRESH, SRC, true>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, G, sscale, slopes, st);
  }
  return launch<T, DP, D, GMAX, FRESH, SRC, true>(q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, G, sscale, slopes, st);
}

// Head-dim dispatch of one type: D 64 (DP 64), 80, 96, 112 or 128 (DP 128) or
// 256; slopes ALiBi's (fp32 [N]) or null.
template <typename T, bool FRESH, int SRC>
int launch_d(int G, const void* q, const void* kf, const void* vf, const void* kc, const void* vc, Keys keys,
             const void* lengths, int length_stride, void* out, int B, int Nkv, int D, float sscale,
             const void* slopes, cudaStream_t st) {
  auto run = [&](auto kern) {
    return kern(G, q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, sscale,
                static_cast<const float*>(slopes), st);
  };
  switch (D) {
    case 64: return run(&launch_g<T, 64, 64, FRESH, SRC>);
    case 80: return run(&launch_g<T, 128, 80, FRESH, SRC>);
    case 96: return run(&launch_g<T, 128, 96, FRESH, SRC>);
    case 112: return run(&launch_g<T, 128, 112, FRESH, SRC>);
    case 128: return run(&launch_g<T, 128, 128, FRESH, SRC>);
    case 256: return run(&launch_g<T, 256, 256, FRESH, SRC>);
  }
  return (int)cudaErrorInvalidValue;
}

// Head-dim and group dispatch of an fp32 call. D must be 64, 80, 96, 112, 128
// or 256, G = N / Nkv any group (the wrapper admits 1 .. 128); returns a
// cudaError_t value, 0 on a successful launch.
template <bool FRESH, int SRC>
int dispatch_f32(const void* q, const void* kf, const void* vf, const void* kc, const void* vc, Keys keys,
                 const void* lengths, int length_stride, void* out, int B, int N, int Nkv, int D, float sscale,
                 const void* slopes, void* stream) {
  if (Nkv <= 0 || N % Nkv != 0) return (int)cudaErrorInvalidValue;
  return launch_d<float, FRESH, SRC>(N / Nkv, q, kf, vf, kc, vc, keys, lengths, length_stride, out, B, Nkv, D,
                                     sscale, slopes, static_cast<cudaStream_t>(stream));
}

}  // namespace lia_dec
