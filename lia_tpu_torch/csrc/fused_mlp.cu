// Fused decoder MLP in one launch: out = x + (down(act(up(norm(x)))) + b2).
//
// Replaces lia_tpu/ops/pallas_mlp.py:fused_mlp (_mlp_kernel). Same math and
// the same roundings:
//   1. the norm in fp32 (LayerNorm, or RMSNorm), scaled by ln_scale (+ ln_bias),
//      rounded to bf16 (the TPU kernel's h_s);
//   2. up = xn @ w1 with fp32 sums, + b1;
//   3. relu, erf-gelu, tanh-gelu (gelu_new), or SwiGLU silu(xn @ wg) * up;
//   4. the activation rounded to bf16;
//   5. act @ w2 summed in fp32 over all of F;
//   6. x + (sum + b2) in fp32, rounded once.
// bf16 in and out; the wrapper (lia_tpu_torch/ops/cuda_mlp.py) checks types,
// shapes and alignment.
//
// What bounds it on an H100: at decode rows (16) bytes, the weights read once
// (Llama-3-8B: w1 + wg + w2 = 352 MB a layer, 0.105 ms at 3.35 TB/s); at 256
// rows still bytes (0.6 GFLOP a weight MB is under the 295 FLOP a byte where
// the tensor cores take over).
//
// Design. Where the TPU kernel walks F tiles in order on one core and keeps
// the fp32 sum in VMEM, the blocks here run in parallel over a grid of
// (row tile of 16, F tile of 64): each block owns 64 columns of w1 (and wg)
// and the same 64 rows of w2, so every weight byte is read by one block per
// row tile; the row tiles of an F tile are neighbours in the launch order,
// and the L2 serves their repeated weight reads.
//   - The block computes its rows' mean and rstd in fp32 from x (two floats a
//     row are kept: a [256, 8192] row set does not fit shared memory), then
//     walks H in chunks of 64: it normalizes the chunk of x on the fly into a
//     bf16 A tile, while cp.async brings the next chunk of w1 (and wg) into
//     the other half of a double buffer; mma.sync m16n8k16 (bf16 in, fp32
//     sums) gives the [16, 64] up (and gate) tile.
//   - The activation is rounded to bf16 in shared memory, and the down
//     product walks H in chunks of 128 columns of w2 (double-buffered the
//     same way). Each warp adds its [16, 32] fp32 partial into an fp32
//     workspace [rows, H] with vector atomics (red.global.add.v2.f32).
//   - After a __threadfence(), each block takes a ticket for its row tile;
//     the LAST block of the tile adds b2 and the residual in fp32, rounds,
//     writes out, and zeroes the workspace rows and the ticket, so the next
//     launch finds them zero: one launch, no memset, capturable in a graph.
// The atomics add the F tiles' partials in an order that changes from run to
// run, so the fp32 sum before the single rounding varies in its last bits.
// Later work: wgmma and TMA, and a split of H among more blocks at decode.
#include "common.cuh"

namespace {

constexpr int BM = 16;           // rows per block (one mma row tile)
constexpr int BF = 64;           // F columns per block
constexpr int KC = 64;           // H columns per step of the up product
constexpr int NC = 128;          // H columns per step of the down product
constexpr int WARPS = 4;
constexpr int NTH = 32 * WARPS;
constexpr int A_PITCH = KC + 8;  // bf16 elements a row in shared memory (16 bytes of padding)
constexpr int W_PITCH = BF + 8;
constexpr int W2_PITCH = NC + 8;
constexpr int ACT_PITCH = BF + 8;

enum Act { RELU = 0, GELU = 1, GELU_TANH = 2, SWIGLU = 3 };

// shared memory, in bf16 elements: the up phase's x tile and two stages of
// w1 (and wg) chunks, reused by the down phase's two stages of w2 chunks
constexpr int UP_ELEMS = BM * A_PITCH + 2 * 2 * KC * W_PITCH;
constexpr int DOWN_ELEMS = 2 * BF * W2_PITCH;
constexpr int STAGE_ELEMS = UP_ELEMS > DOWN_ELEMS ? UP_ELEMS : DOWN_ELEMS;
constexpr size_t SMEM = sizeof(__nv_bfloat16) * (STAGE_ELEMS + BM * ACT_PITCH) + 2 * BM * sizeof(float);

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices, transposed on the way: lanes 0-7 give the rows of the
// first, lanes 8-15 those of the second (a B fragment from a row-major [k][n] tile).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of the 16 x 16 slice at column k0 of a [16][pitch] bf16 tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* t, int pitch, int k0, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* p = t + gq * pitch + k0 + 2 * tq;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

// rows [r0, r0 + 64) x columns [c0, c0 + CW) of a row-major bf16 matrix with
// `ld` columns into dst [64][pitch], 16 bytes per cp.async
template <int CW>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int pitch, const __nv_bfloat16* __restrict__ src,
                                          size_t ld, int r0, int c0, int tid) {
  constexpr int CH = CW / 8;  // 16-byte chunks a row
#pragma unroll
  for (int c = tid; c < 64 * CH; c += NTH) {
    const int r = c / CH, k = (c % CH) * 8;
    lia::cp_async16(dst + r * pitch + k, src + (size_t)(r0 + r) * ld + c0 + k, true);
  }
}

__device__ __forceinline__ float activate(int act, float up, float gate) {
  switch (act) {
    case RELU: return fmaxf(up, 0.f);
    case GELU: return 0.5f * up * (1.f + erff(up * 0.70710678118654752f));
    case GELU_TANH: {
      const float u = 0.7978845608028654f * (up + 0.044715f * up * up * up);
      return 0.5f * up * (1.f + tanhf(u));
    }
    default: return gate / (1.f + expf(-gate)) * up;  // SwiGLU: silu(gate) * up
  }
}

template <bool RMS, bool GATED>
__global__ void __launch_bounds__(NTH)
fused_mlp_kernel(const __nv_bfloat16* __restrict__ x,      // [R, H]
                 const __nv_bfloat16* __restrict__ lnw,    // [H]
                 const __nv_bfloat16* __restrict__ lnb,    // [H] or null
                 const __nv_bfloat16* __restrict__ w1,     // [H, F]
                 const __nv_bfloat16* __restrict__ b1,     // [F] or null
                 const __nv_bfloat16* __restrict__ wg,     // [H, F] (GATED) or null
                 const __nv_bfloat16* __restrict__ w2,     // [F, H]
                 const __nv_bfloat16* __restrict__ b2,     // [H] or null
                 __nv_bfloat16* __restrict__ out,          // [R, H]
                 float* __restrict__ ws,                   // [>= R, H] fp32, zero between launches
                 unsigned int* __restrict__ tickets,       // [row tiles], zero between launches
                 int R, int H, int F, int act, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* As = smem;                           // [BM][A_PITCH] normalized x chunk
  __nv_bfloat16* Ws = smem + BM * A_PITCH;            // [2 stages][w1, wg][KC][W_PITCH]
  __nv_bfloat16* W2s = smem;                          // [2 stages][BF][W2_PITCH] (down phase)
  __nv_bfloat16* Acts = smem + STAGE_ELEMS;           // [BM][ACT_PITCH] activation
  float* mean = reinterpret_cast<float*>(Acts + BM * ACT_PITCH);
  float* rstd = mean + BM;
  __shared__ bool last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, f0 = blockIdx.y * BF;

  // w1 (and wg) chunk 0 in flight while the row statistics are computed
  auto load_up = [&](int k0, int buf) {
    __nv_bfloat16* w = Ws + buf * 2 * KC * W_PITCH;
    load_tile<BF>(w, W_PITCH, w1, F, k0, f0, tid);
    if (GATED) load_tile<BF>(w + KC * W_PITCH, W_PITCH, wg, F, k0, f0, tid);
    lia::cp_async_commit();
  };
  load_up(0, 0);

  // 1. per-row mean and rstd in fp32: warp w takes rows w, w + 4, ...
  for (int r = warp; r < BM; r += WARPS) {
    const int m = m0 + r;
    float mu = 0.f, rs = 1.f;
    if (m < R) {
      const __nv_bfloat16* xr = x + (size_t)m * H;
      float s = 0.f;
      for (int k = lane * 8; k < H; k += 256) {
        float v[8];
        lia::load_vec<8>(xr + k, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += RMS ? v[e] * v[e] : v[e];
      }
      s = lia::warp_sum(s) / H;
      if (RMS) {
        rs = rsqrtf(s + eps);
      } else {
        mu = s;
        float ss = 0.f;
        for (int k = lane * 8; k < H; k += 256) {
          float v[8];
          lia::load_vec<8>(xr + k, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) ss += (v[e] - mu) * (v[e] - mu);
        }
        rs = rsqrtf(lia::warp_sum(ss) / H + eps);
      }
    }
    if (lane == 0) mean[r] = mu, rstd[r] = rs;
  }
  __syncthreads();

  // 2. up (and gate) tile [16, 64]: warp w owns columns [16 w, 16 w + 16)
  float up[2][4] = {}, gate[2][4] = {};
  const int nchunks = H / KC;
  for (int c = 0; c < nchunks; ++c) {
    const int k0 = c * KC, buf = c & 1;
    if (c + 1 < nchunks) load_up(k0 + KC, buf ^ 1);
    {  // the chunk of x, normalized and rounded to bf16 (8 elements a thread)
      const int r = tid / (KC / 8), k = (tid % (KC / 8)) * 8, m = m0 + r;
      float v[8], sc[8], bi[8] = {};
      if (m < R) {
        lia::load_vec<8>(x + (size_t)m * H + k0 + k, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      lia::load_vec<8>(lnw + k0 + k, sc);
      if (lnb) lia::load_vec<8>(lnb + k0 + k, bi);
      __nv_bfloat16* dst = As + r * A_PITCH + k;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xn = (RMS ? v[e] : v[e] - mean[r]) * rstd[r];
        dst[e] = __float2bfloat16_rn(xn * sc[e] + bi[e]);
      }
    }
    if (c + 1 < nchunks) lia::cp_async_wait<1>(); else lia::cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16* w = Ws + buf * 2 * KC * W_PITCH;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      uint32_t a[4];
      load_a(a, As, A_PITCH, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = warp * 16 + nt * 8;
        uint32_t b0, b1v;
        ldmatrix_x2_trans(b0, b1v, w + (kk * 16 + (lane & 15)) * W_PITCH + col);
        mma_bf16(up[nt], a, b0, b1v);
        if (GATED) {
          ldmatrix_x2_trans(b0, b1v, w + KC * W_PITCH + (kk * 16 + (lane & 15)) * W_PITCH + col);
          mma_bf16(gate[nt], a, b0, b1v);
        }
      }
    }
    __syncthreads();  // the x tile and this stage are read before they are refilled
  }

  // 3-4. activation, rounded to bf16, into shared memory; w2 chunk 0 in flight
  auto load_down = [&](int h0, int buf) {
    load_tile<NC>(W2s + buf * BF * W2_PITCH, W2_PITCH, w2, H, f0, h0, tid);
    lia::cp_async_commit();
  };
  load_down(0, 0);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = warp * 16 + nt * 8 + 2 * tq + (e & 1), row = gq + 8 * (e >> 1);
      const float u = up[nt][e] + (b1 ? __bfloat162float(b1[f0 + col]) : 0.f);
      Acts[row * ACT_PITCH + col] = __float2bfloat16_rn(activate(act, u, gate[nt][e]));
    }
  __syncthreads();
  uint32_t a[BF / 16][4];  // every warp multiplies all 16 rows by its own w2 columns
#pragma unroll
  for (int kk = 0; kk < BF / 16; ++kk) load_a(a[kk], Acts, ACT_PITCH, kk * 16, lane);

  // 5. down product [16, 64] x [64, H] in chunks of 128 columns; warp w owns
  // columns [32 w, 32 w + 32) of each, added into the fp32 workspace
  const int dchunks = H / NC;
  for (int c = 0; c < dchunks; ++c) {
    const int h0 = c * NC, buf = c & 1;
    if (c + 1 < dchunks) {
      load_down(h0 + NC, buf ^ 1);
      lia::cp_async_wait<1>();
    } else {
      lia::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* w = W2s + buf * BF * W2_PITCH;
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < BF / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t b0, b1v;
        ldmatrix_x2_trans(b0, b1v, w + (kk * 16 + (lane & 15)) * W2_PITCH + warp * 32 + nt * 8);
        mma_bf16(acc[nt], a[kk], b0, b1v);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + gq + 8 * h;
        if (m >= R) continue;
        const int col = h0 + warp * 32 + nt * 8 + 2 * tq;
        atomicAdd(reinterpret_cast<float2*>(ws + (size_t)m * H + col),
                  make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]));
      }
    __syncthreads();  // this stage is read before it is refilled
  }

  // 6. the last block of the row tile adds b2 and the residual, rounds once,
  // and leaves the workspace rows and the ticket zero
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(BM, R - m0);
  for (int i = tid * 2; i < rows * H; i += NTH * 2) {
    const int r = i / H, col = i % H;
    const size_t off = (size_t)(m0 + r) * H + col;
    const float2 sum = __ldcg(reinterpret_cast<const float2*>(ws + off));
    const float2 xv = lia::load_pair(x + off);
    const float2 bv = b2 ? lia::load_pair(b2 + col) : make_float2(0.f, 0.f);
    *reinterpret_cast<__nv_bfloat162*>(out + off) =
        __floats2bfloat162_rn(xv.x + (sum.x + bv.x), xv.y + (sum.y + bv.y));
    __stcg(reinterpret_cast<float2*>(ws + off), make_float2(0.f, 0.f));
  }
  if (tid == 0) tickets[blockIdx.x] = 0u;
}

template <bool RMS, bool GATED>
int launch(const void* x, const void* lnw, const void* lnb, const void* w1, const void* b1, const void* wg,
           const void* w2, const void* b2, void* out, void* ws, void* tickets, int R, int H, int F, int act,
           float eps, cudaStream_t stream) {
  auto kern = fused_mlp_kernel<RMS, GATED>;
  static const cudaError_t attr =  // once per instantiation: the launch sits on the decode path
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((R + BM - 1) / BM, F / BF);
  using B = const __nv_bfloat16*;
  kern<<<grid, NTH, SMEM, stream>>>(
      static_cast<B>(x), static_cast<B>(lnw), static_cast<B>(lnb), static_cast<B>(w1), static_cast<B>(b1),
      static_cast<B>(wg), static_cast<B>(w2), static_cast<B>(b2), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(ws), static_cast<unsigned int*>(tickets), R, H, F, act, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// act: 0 relu, 1 gelu (erf), 2 gelu_new (tanh), 3 SwiGLU (wg required);
// rms: RMSNorm, else LayerNorm; ln_bias, b1 and b2 may be null (ln_bias is
// added after the scale under either norm, as in the TPU kernel). ws is an fp32 [>= R, H] workspace and tickets an int32 [ceil(R/16)]
// array, both zero before the launch and left zero after it. Returns a
// cudaError_t value: 0 on a successful launch. The wrapper checks types,
// shapes and alignment: H % 128 == 0, F % 64 == 0, 16-byte aligned rows.
extern "C" int lia_fused_mlp(const void* x, const void* lnw, const void* lnb, const void* w1, const void* b1,
                             const void* wg, const void* w2, const void* b2, void* out, void* ws,
                             void* tickets, int R, int H, int F, int act, int rms, float eps,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || H % NC != 0 || F % BF != 0 || act < RELU || act > SWIGLU || (act == SWIGLU) != (wg != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool gated = act == SWIGLU;
  if (rms && gated) return launch<true, true>(x, lnw, lnb, w1, b1, wg, w2, b2, out, ws, tickets, R, H, F, act, eps, st);
  if (rms) return launch<true, false>(x, lnw, lnb, w1, b1, wg, w2, b2, out, ws, tickets, R, H, F, act, eps, st);
  if (gated) return launch<false, true>(x, lnw, lnb, w1, b1, wg, w2, b2, out, ws, tickets, R, H, F, act, eps, st);
  return launch<false, false>(x, lnw, lnb, w1, b1, wg, w2, b2, out, ws, tickets, R, H, F, act, eps, st);
}
