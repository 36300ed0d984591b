// Decode attention of one layer over a bf16 cache plane, written for Hopper:
// the body behind decode_fresh.cu (B2: the fresh token merged, not in the
// plane) and decode.cu (B7/B8: the plane already holds it) for bf16 calls
// with one query head a kv head (PLANE_MAX_GROUP in ops/cuda_attention.py;
// from two heads up beam_attn.cuh's mma body measured faster on an H100 and
// takes those calls; fp32 calls run decode_attn.cuh's warp body).
//
// Math, all in fp32, as the Pallas kernels' (_decode_fresh_kernel,
// _decode_kernel, _decode_stacked_kernel): q is scaled by scale*log2(e), the
// keys [start, length) of the plane go through an online softmax in exp2
// units, start = length - popcount(slot_mask[b]) counted on the device; with
// the fresh token (B2) its key and value join the same softmax (length
// excludes it); out = acc / max(l, 1e-30), so a row with no key and no fresh
// token comes out 0. Lengths stay in device memory: a call never syncs and
// replays in a CUDA graph. The sums run in another order than the plain
// version's, so the outputs differ by their bf16 rounding and that order.
// With ALiBi slopes, key slot s scores slope * log2(e) * (s - length) more
// (common.cuh: alibi_slope), the fresh token 0: the query sits at the length.
// The term is a template flag (ALIBI); the instances without it are those
// before the port of ALiBi (a runtime branch cost them ~1% on an H100).
//
// What bounds it on an H100: bytes, each (row, kv head)'s valid K and V rows
// read once (~70 MB a launch at OPT-6.7B b16 with ~265 valid keys a row, ~21
// us at 3.35 TB/s), 4 FLOP a byte at G = 1. The warp body before it loaded
// each step's keys straight into registers and computed on them, so a warp's
// walk was a chain of dependent loads (9 steps at D <= 128, 17 at 256), each
// lane read DP / 32 dims (8 bytes a row at 128), a score cost five shuffles,
// and lanes past D / 4 idled over a 128-wide row at D = 80 and 96. Here:
// - A (row, kv head)'s valid keys are one contiguous run of K and one of V in
//   the plane, so a producer warp copies each ring stage of UNIT keys as one
//   1-D cp.async.bulk for K and one for V into an mbarrier ring in dynamic
//   shared memory, up to `stages` ahead of the consumers. Copies move D * 2
//   bytes a row, so D = 80, 96 and 112 read no padding. The host sizes the ring
//   from the blocks an SM (plane_plan), so that tens of KB an SM stay in
//   flight while the consumers compute.
// - Four consumer warps read the stage with 16-byte shared loads: a key row
//   takes DP / 8 lanes (8 at D = 64, 16 at 80, 96 and 128 with the lanes past
//   D / 8 idle, 32 at 256), so a warp holds 32 * 8 / DP keys at once and a
//   score costs log2(DP / 8) shuffles. Each lane group (the lanes of one key
//   row) takes KT_STAGE keys of a stage, with its own running (m, l, acc);
//   the groups merge through shuffles, the warps through shared memory (the
//   idle ring) at the end. The query sits in registers.
// - Every warp reads the length and counts the mask itself (no block barrier
//   but the one after the ring's barriers are initialised), so the count's
//   loads, the consumers' q loads and the fresh token's are in flight
//   together before the first copy.
// - Where the (kv head, row) blocks fill the card poorly, the wrapper splits
//   each row's keys into `parts` ranges, cut on the device from the row's own
//   [start, length); a part past the length writes an empty partial. The parts
//   write fp32 (o, m, l) partials to a workspace that decode_int8_attn.cuh's
//   merge_kernel, a second launch, combines (with the fresh token for B2).
//   Every partial is written, so the workspace needs no memset and the pair
//   of launches replays in a CUDA graph.
#pragma once

#include "decode_int8_attn.cuh"  // hopper.cuh's PTX wrappers, warp_count_true, merge_kernel

namespace lia_plane {
// Internal linkage: decode.cu and decode_fresh.cu each build their own copy
// into their own library (see beam_attn.cuh: a function-local static of a
// template with external linkage would be one object across the libraries).
namespace {

using namespace lia;  // the PTX wrappers of hopper.cuh
using bf16 = __nv_bfloat16;

constexpr int NWC = 4;                   // consumer warps a block
constexpr int THREADS = 32 * (NWC + 1);  // and one producer warp
constexpr int KT_STAGE = 4;              // keys a lane group takes from each stage
constexpr int MAX_STAGES = 16;
constexpr int BLOCK_SMEM = 227 * 1024;   // most a block takes

// Lanes of a key row at width DP (16 bytes, 8 dims, a lane), and the keys a
// ring stage holds: KT_STAGE for each lane group of the block (64 at DP = 64,
// 32 at 128, 16 at 256: 8 KB of K at the full width).
__host__ __device__ constexpr int row_lanes(int DP) { return DP / 8; }
__host__ __device__ constexpr int unit_keys(int DP) { return KT_STAGE * NWC * (32 / row_lanes(DP)); }
// Blocks an SM the kernel is built for (__launch_bounds__).
constexpr int BLOCKS_AN_SM = 4;

// Bytes of the ring's barriers (full and empty a stage), rounded so the ring
// that follows starts 128-byte aligned; of one stage (K and V of unit_keys
// rows, D * 2 bytes each); and of a block, whose partials (m, l and o of NWC
// warps) reuse the ring once the walk is over.
__host__ __device__ constexpr int bar_bytes(int stages) { return (16 * stages + 127) / 128 * 128; }
__host__ __device__ constexpr int stage_bytes(int D, int DP) { return 2 * unit_keys(DP) * D * 2; }
__host__ __device__ constexpr int smem_bytes(int D, int DP, int stages) {
  return bar_bytes(stages) + (stages * stage_bytes(D, DP) > NWC * (D + 2) * 4 ? stages * stage_bytes(D, DP)
                                                                              : NWC * (D + 2) * 4);
}

// One contiguous chunk of global memory into shared memory, completing on
// `bar` (bytes a multiple of 16, both addresses 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Returns, on every lane of the warp at once, when the barrier's phase of
// parity `parity` has completed. The loop's exit is a vote over the warp, so
// ptxas sees the warp leave it converged: with a per-lane exit (lia::mbar_wait)
// it wrapped most later shuffles in a collective (WARPSYNC / ENDCOLLECTIVE)
// sequence.
__device__ __forceinline__ void warp_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!__all_sync(0xffffffffu, done));
}

// 16 bytes of shared memory (8 bf16) as one word.
__device__ __forceinline__ uint4 lds16(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }

// The 8 bf16 of a word as floats (exact: a bf16 is the top half of a float).
__device__ __forceinline__ void unpack8(const uint4& w, float (&x)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// A lane's part of a dot over 8 dims, summed over the LPR lanes of its row.
template <int LPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One block: kv head blockIdx.x of row blockIdx.y, whose one query head is
// row b * N + h of q and out (N = Nkv), part blockIdx.z of the row's keys.
template <int DP, int D, bool FRESH, bool ALIBI>
__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM)
plane_kernel(const bf16* __restrict__ q,       // [B, N, D]
             const bf16* __restrict__ kf,      // [B, N, D] fresh keys (FRESH only)
             const bf16* __restrict__ vf,      // [B, N, D] fresh values (FRESH only)
             const bf16* __restrict__ kc,      // one layer's plane [B, N, S, D]
             const bf16* __restrict__ vc,
             const uint8_t* __restrict__ mask, int S,                // slot mask [B, S]
             const int* __restrict__ lengths, int length_stride,     // [B] or a scalar
             bf16* __restrict__ out,           // [B, N, D] (parts == 1)
             float* __restrict__ ws,           // partials (parts > 1): o [parts, B*N, D], m, l [parts, B*N]
             int parts, int N, float sscale, int stages,
             const float* __restrict__ slopes) {  // ALiBi [N] (ALIBI only)
  constexpr int LPR = row_lanes(DP), KPW = 32 / LPR, GROUPS = NWC * KPW, U = unit_keys(DP);
  const int h = blockIdx.x, b = blockIdx.y, part = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * N + h;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_addr(smem), empty0 = full0 + 8 * stages;
  bf16* ks = reinterpret_cast<bf16*>(smem + bar_bytes(stages));  // [stages][U][D]
  bf16* vs = ks + (size_t)stages * U * D;                          // [stages][U][D]
  float* pm = reinterpret_cast<float*>(ks);  // after the walk: m [NWC], l [NWC], o [NWC][D]
  float* pl = pm + NWC;
  float* po = pl + NWC;

  // consumer lanes: key slot `sub` of the warp, 16-byte chunk c of the row
  const int sub = lane / LPR, c = lane % LPR;
  const bool on = D == DP || c * 8 < D;  // the lane's dims lie inside the row
  const int grp = warp * KPW + sub;      // the lane group of the block
  float qr[8];
  uint4 kfw = {}, vfw = {};
  if (warp < NWC) {  // q and the fresh token, in flight under the mask's count
    uint4 w = {};
    if (on) w = lia_dec8::ldg16(q + row * D + c * 8);
    unpack8(w, qr);
    if (FRESH && parts == 1 && warp == 0 && on) {
      kfw = lia_dec8::ldg16(kf + row * D + c * 8);
      vfw = lia_dec8::ldg16(vf + row * D + c * 8);
    }
  }
  // this part's keys [lo, hi) of the row's [start, length), on every warp
  const int length = min(max(lengths[b * length_stride], 0), S);
  const int start = max(length - lia_dec8::warp_count_true(mask + (size_t)b * S, S, lane), 0);
  const int n = length - start;
  const int lo = start + (int)((long long)n * part / parts), hi = start + (int)((long long)n * (part + 1) / parts);
  const int nst = (hi - lo + U - 1) / U;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWC);  // every consumer warp releases every stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWC) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      const size_t row0 = row * S;
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < nst; ++i) {
        const int t0 = lo + i * U;
        const uint32_t bytes = min(U, hi - t0) * D * 2, full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, phase ^ 1);
        mbar_expect_tx(full, 2 * bytes);
        bulk_load(smem_addr(ks + (size_t)s * U * D), kc + (row0 + t0) * D, bytes, full);
        bulk_load(smem_addr(vs + (size_t)s * U * D), vc + (row0 + t0) * D, bytes, full);
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumer warps ----
#pragma unroll
  for (int e = 0; e < 8; ++e) qr[e] *= sscale;
  const float sl = ALIBI ? alibi_slope(slopes, h) : 0.f;
  float m = LIA_NEG_INF, l = 0.f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  if (FRESH && parts == 1 && warp == 0) {  // the fresh token opens lane group 0's softmax
    float kx[8], vx[8];
    unpack8(kfw, kx);
    unpack8(vfw, vx);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) dot = fmaf(qr[e], kx[e], dot);
    dot = row_sum<LPR>(dot);
    if (sub == 0) {
      m = dot;
      l = 1.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = vx[e];
    }
  }

  int s = 0;
  uint32_t phase = 0;
  for (int i = 0; i < nst; ++i) {
    const int rows = min(U, hi - lo - i * U);
    warp_wait(full0 + 8 * s, phase);
    const bf16* K = ks + (size_t)s * U * D + c * 8;
    const bf16* V = vs + (size_t)s * U * D + c * 8;
    uint4 kw[KT_STAGE], vw[KT_STAGE];
    bool valid[KT_STAGE];
#pragma unroll
    for (int kk = 0; kk < KT_STAGE; ++kk) {
      const int r = kk * GROUPS + grp;  // row r of the stage: lane group r % GROUPS
      valid[kk] = r < rows;
      const int rr = min(r, rows - 1);  // past the stage's rows: a valid row, masked below
      kw[kk] = on ? lds16(K + rr * D) : uint4{};
      vw[kk] = on ? lds16(V + rr * D) : uint4{};
    }
    float sc[KT_STAGE];
#pragma unroll
    for (int kk = 0; kk < KT_STAGE; ++kk) {
      float kx[8];
      unpack8(kw[kk], kx);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qr[e], kx[e], dot);
      sc[kk] = dot;
    }
#pragma unroll
    for (int kk = 0; kk < KT_STAGE; ++kk) sc[kk] = row_sum<LPR>(sc[kk]);
    if (ALIBI) {  // key slot lo + i U + r against the query at the length
      const int k0 = lo + i * U + grp - length;
#pragma unroll
      for (int kk = 0; kk < KT_STAGE; ++kk) sc[kk] = fmaf(sl, (float)(k0 + kk * GROUPS), sc[kk]);
    }
    float mt = LIA_NEG_INF;
#pragma unroll
    for (int kk = 0; kk < KT_STAGE; ++kk)
      if (valid[kk]) mt = fmaxf(mt, sc[kk]);
    const float m_new = fmaxf(m, mt);
    const float alpha = exp2f(m - m_new);
    float p[KT_STAGE], psum = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT_STAGE; ++kk) {
      p[kk] = valid[kk] ? exp2f(sc[kk] - m_new) : 0.f;
      psum += p[kk];
    }
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= alpha;
#pragma unroll
    for (int kk = 0; kk < KT_STAGE; ++kk) {
      float vx[8];
      unpack8(vw[kk], vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(p[kk], vx[e], acc[e]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }

  // the warp's lane groups merged through shuffles (every lane ends with the
  // warp's partial), then the warps' through the idle ring
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off), lo_ = __shfl_xor_sync(0xffffffffu, l, off);
    const float M = fmaxf(m, mo), a = exp2f(m - M), bo = exp2f(mo - M);
    l = l * a + lo_ * bo;
    m = M;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], off) * bo;
  }
  named_sync(1, NWC * 32);  // every warp is past its last stage: the ring is idle
  if (sub == 0) {
    if (lane == 0) {
      pm[warp] = m;
      pl[warp] = l;
    }
    if (on) {
      float4* dst = reinterpret_cast<float4*>(po + warp * D + c * 8);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  named_sync(1, NWC * 32);
  const size_t rows_all = (size_t)gridDim.y * N;
  for (int idx = tid; idx < D / 2; idx += NWC * 32) {
    const int d = 2 * idx;
    float M = LIA_NEG_INF;
#pragma unroll
    for (int w = 0; w < NWC; ++w) M = fmaxf(M, pm[w]);
    float L = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < NWC; ++w) {
      const float a = exp2f(pm[w] - M);
      L += pl[w] * a;
      const float2 x = *reinterpret_cast<const float2*>(po + w * D + d);
      o0 = fmaf(x.x, a, o0);
      o1 = fmaf(x.y, a, o1);
    }
    if (parts == 1) {
      L = fmaxf(L, 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(out + row * D + d) = __floats2bfloat162_rn(o0 / L, o1 / L);
    } else {
      *reinterpret_cast<float2*>(ws + ((size_t)part * rows_all + row) * D + d) = make_float2(o0, o1);
      if (d == 0) {
        ws[(size_t)parts * rows_all * D + part * rows_all + row] = M;
        ws[(size_t)parts * rows_all * (D + 1) + part * rows_all + row] = L;
      }
    }
  }
}

template <int DP, int D, bool FRESH, bool ALIBI>
int launch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc, const void* mask, int S,
           const void* lengths, int length_stride, void* out, void* ws, int parts, int stages, int B, int N,
           float sscale, const float* slopes, cudaStream_t stream) {
  auto kern = plane_kernel<DP, D, FRESH, ALIBI>;
  static const cudaError_t attr = [&] {  // once an instantiation: the launch sits on the decode path
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int bytes = smem_bytes(D, DP, stages);
  if (bytes > BLOCK_SMEM) return (int)cudaErrorInvalidValue;
  kern<<<dim3(N, B, parts), THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kf), static_cast<const bf16*>(vf),
      static_cast<const bf16*>(kc), static_cast<const bf16*>(vc), static_cast<const uint8_t*>(mask), S,
      static_cast<const int*>(lengths), length_stride, static_cast<bf16*>(out), static_cast<float*>(ws), parts, N,
      sscale, stages, slopes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const int rows = B * N;
  lia_dec8::merge_kernel<bf16, DP, false>
      <<<(rows + lia_dec8::MERGE_WARPS - 1) / lia_dec8::MERGE_WARPS, 32 * lia_dec8::MERGE_WARPS, 0, stream>>>(
          static_cast<const float*>(ws), static_cast<const bf16*>(q), static_cast<const bf16*>(kf),
          static_cast<const bf16*>(vf), static_cast<bf16*>(out), parts, rows, N, 1, D, sscale);
  return (int)cudaGetLastError();
}

// Head-dim dispatch, after the checks: D 64, 80, 96, 112, 128 or 256, one
// query head a kv head (N == Nkv), parts >= 1 (a workspace of parts * B * N *
// (D + 2) floats when parts > 1), stages >= 1 with the block's shared memory
// within BLOCK_SMEM, q, the fresh k/v and the plane 16-byte aligned, slopes
// ALiBi's (fp32 [N]) or null. Returns a cudaError_t value, 0 on a successful
// launch.
template <bool FRESH>
int dispatch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc, const void* mask,
             int S, const void* lengths, int length_stride, void* out, void* ws, int parts, int stages, int B,
             int N, int Nkv, int D, float sscale, const void* slopes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kf) |
                         reinterpret_cast<uintptr_t>(vf) | reinterpret_cast<uintptr_t>(kc) |
                         reinterpret_cast<uintptr_t>(vc);
  if (Nkv <= 0 || N != Nkv || B < 1 || S < 1 || parts < 1 || (parts > 1 && !ws) || stages < 1 ||
      stages > MAX_STAGES || padded_dim(D) == 0 || (addr & 15) != 0 || (FRESH && (!kf || !vf)))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kern) {
    return kern(q, kf, vf, kc, vc, mask, S, lengths, length_stride, out, ws, parts, stages, B, N, sscale,
                static_cast<const float*>(slopes), st);
  };
  auto by_dim = [&](auto alibi) {
    constexpr bool A = decltype(alibi)::value;
    switch (D) {
      case 64: return run(&launch<64, 64, FRESH, A>);
      case 80: return run(&launch<128, 80, FRESH, A>);
      case 96: return run(&launch<128, 96, FRESH, A>);
      case 112: return run(&launch<128, 112, FRESH, A>);
      case 128: return run(&launch<128, 128, FRESH, A>);
    }
    return run(&launch<256, 256, FRESH, A>);
  };
  return slopes ? by_dim(std::true_type{}) : by_dim(std::false_type{});
}

}  // namespace
}  // namespace lia_plane

