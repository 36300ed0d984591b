// Decode attention over one layer of the stacked INT8 KV cache (per-token f32
// scales), with this step's fresh token merged last.
//
// Replaces lia_tpu/ops/pallas_attention.py:decode_attention_fresh_int8
// (_decode_fresh_int8_kernel). Same math: q stays in its own type and the
// dot with the int8 key codes accumulates in fp32 (int8 values and their
// products with bf16 are exact there); the K scale and the softmax scale
// multiply the score after the dot, s * (ks * scale*log2(e)); the V scale
// multiplies the probability, and p * vs is rounded to q's type before it
// meets the value codes, as the TPU kernel feeds bf16 probs to its P.V dot.
//
// The fresh token arrives raw (in q's type). The reference quantizes it and
// dequantizes it again before the call, in separate XLA ops, so attention
// sees what later steps read back from the cache; here warp 0 does the same
// in the kernel, bit for bit (fp32 amax over D, scale = max(amax/127, 1e-8),
// codes = clip(rint(x/scale), -128, 127), value = code*scale rounded to q's
// type), which saves the caller four quantize/dequantize passes of several
// launches each per layer. The fresh token then merges in fp32.
//
// What bounds it on an H100: bytes, half of the bf16 kernel's (int8 codes
// plus one f32 scale per 128-byte row). Design as decode_fresh.cu: one block
// per (kv head, batch row), four warps splitting [start, length), each lane
// holding D/32 dimensions (4 bytes of codes at D=128), eight keys per step,
// warp partials merged in shared memory, fresh token last. A later PR splits
// long ranges over more blocks and widens the per-lane loads.
#include "common.cuh"

namespace {

constexpr int NW = 4;
constexpr int KT = 8;

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

template <typename T, int D, int G>
__global__ void __launch_bounds__(NW * 32)
decode_fresh_int8_kernel(const T* __restrict__ q,        // [B, N, D]
                         const T* __restrict__ kf,       // [B, Nkv, D] fresh key, not quantized
                         const T* __restrict__ vf,
                         const int8_t* __restrict__ kq,  // [B, Nkv, S_max, D] this layer
                         const float* __restrict__ ks,   // [B, Nkv, S_max]
                         const int8_t* __restrict__ vq,
                         const float* __restrict__ vs,
                         const uint8_t* __restrict__ slot_mask,  // [B, S_max]
                         const int* __restrict__ lengths, int length_stride,
                         T* __restrict__ out,            // [B, N, D]
                         int Nkv, int S_max, float sscale) {
  constexpr int DL = D / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int N = Nkv * G;
  const int length = min(max(lengths[b * length_stride], 0), S_max);
  const int start = max(length - lia::block_count_true(slot_mask + (size_t)b * S_max, S_max), 0);

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

  const int chunk = (length - start + NW - 1) / NW;
  const int k0 = start + w * chunk, k1 = min(k0 + chunk, length);
  const size_t plane = ((size_t)b * Nkv + h) * S_max;
  const int8_t* kb = kq + plane * D + lane * DL;
  const int8_t* vb = vq + plane * D + lane * DL;
  const float* ksb = ks + plane;
  const float* vsb = vs + plane;

  for (int t0 = k0; t0 < k1; t0 += KT) {
    float kx[KT][DL], vx[KT][DL], kscale[KT], vscale[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      if (t0 + kk < k1) {
        load_codes<DL>(kb + (size_t)(t0 + kk) * D, kx[kk]);
        load_codes<DL>(vb + (size_t)(t0 + kk) * D, vx[kk]);
        kscale[kk] = ksb[t0 + kk] * sscale;
        vscale[kk] = vsb[t0 + kk];
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
  quant_dequant<T, DL>(kfx);
  quant_dequant<T, DL>(vfx);
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

template <typename T, int D, int G>
int launch(const void* q, const void* kf, const void* vf, const void* kq, const void* ks,
           const void* vq, const void* vs, const void* slot_mask, const void* lengths,
           int length_stride, void* out, int B, int Nkv, int S_max, float sscale,
           cudaStream_t stream) {
  dim3 grid(Nkv, B);
  decode_fresh_int8_kernel<T, D, G><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf),
      static_cast<const int8_t*>(kq), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vq), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(slot_mask), static_cast<const int*>(lengths), length_stride,
      static_cast<T*>(out), Nkv, S_max, sscale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(int G, const void* q, const void* kf, const void* vf, const void* kq,
             const void* ks, const void* vq, const void* vs, const void* slot_mask,
             const void* lengths, int length_stride, void* out, int B, int Nkv, int S_max,
             float sscale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, kf, vf, kq, ks, vq, vs, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    case 2: return launch<T, D, 2>(q, kf, vf, kq, ks, vq, vs, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    case 4: return launch<T, D, 4>(q, kf, vf, kq, ks, vq, vs, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    case 8: return launch<T, D, 8>(q, kf, vf, kq, ks, vq, vs, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kq/ks/vq/vs point at layer layer_idx of the stacked cache (the wrapper
// offsets them). Returns a cudaError_t value: 0 on a successful launch. D must
// be 64 or 128 and G = N / Nkv one of 1, 2, 4, 8.
extern "C" int lia_decode_fresh_int8(const void* q, const void* kf, const void* vf,
                                     const void* kq, const void* ks, const void* vq,
                                     const void* vs, const void* slot_mask,
                                     const void* lengths, int length_stride, void* out, int B,
                                     int N, int Nkv, int S_max, int D, float sscale,
                                     int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % Nkv != 0) return (int)cudaErrorInvalidValue;
  const int G = N / Nkv;
  if (is_bf16) {
    if (D == 128) return launch_g<__nv_bfloat16, 128>(G, q, kf, vf, kq, ks, vq, vs, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    if (D == 64) return launch_g<__nv_bfloat16, 64>(G, q, kf, vf, kq, ks, vq, vs, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
  } else {
    if (D == 128) return launch_g<float, 128>(G, q, kf, vf, kq, ks, vq, vs, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
    if (D == 64) return launch_g<float, 64>(G, q, kf, vf, kq, ks, vq, vs, slot_mask, lengths, length_stride, out, B, Nkv, S_max, sscale, st);
  }
  return (int)cudaErrorInvalidValue;
}
