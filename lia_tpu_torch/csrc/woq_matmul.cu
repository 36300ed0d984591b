// Weight-only quantized matmul: bf16 activations x int8, int4, NF4 or
// zero-point int4 weight codes, fp32 out.
//
// Replaces lia_tpu/ops/pallas_matmul.py:woq_matmul (_woq_kernel, _woq4_kernel,
// _woq_nf4_kernel) and woq4z_matmul (_woq4z_kernel). Same math: the codes are
// turned into bf16 (exact for int8, c - 8 and raw int4 codes; NF4 through the
// 16-entry codebook rounded to bf16, as the TPU kernel's select tree rounds to
// the activation's type), each group's product x_g @ code_g is summed in fp32
// on the tensor cores (mma.sync m16n8k16, bf16 in), and only a finished group
// sum is scaled: y = sum_g s_g * (x_g @ code_g). The zero-point form subtracts
// rowsum(x_g) * z_g from the group sum first. 4-bit weights are [K/2, N] bytes
// in the global half-split: byte r holds row r (low nibble) and K/2 + r.
//
// What bounds it on an H100: at decode (M = 16) bytes, the weight read once
// (OPT-6.7B fc1 in int4: 33.5 MB, 10 us at 3.35 TB/s) against 16 multiply-adds
// per weight; at prefill (M = 4096) the bf16 tensor-core rate, and before it
// the unpacking of each weight tile, which every block of rows repeats.
// Design: blocks of four warps own an output tile (16 x 32 at decode, 64 x 64
// above) and walk K inside the block, STAGE_ROWS weight rows per stage. Each
// stage's weight bytes are read once, coalesced along N (2 rows x 4 columns a thread),
// decoded in registers (int4 by bit patterns: 0x4300 | n is the bf16 128 + n,
// one bf16x2 subtraction gives two codes) and stored to shared memory
// transposed to K-contiguous rows (the B-fragment layout); the stage's x tile
// is copied to shared memory with cp.async. The next stage's x tile and weight
// bytes are in flight while the tensor cores work on this one. At decode, K is
// split over gridDim.z so that every SM has blocks in flight; the fp32
// partials (each a whole number of groups) are summed by a second launch.
// TMA, deeper pipelines and wgmma are later work.
#include "qmatmul.cuh"

namespace {

using lia::STAGE_ROWS;

enum Kind { KIND_INT8 = 0, KIND_INT4 = 1, KIND_NF4 = 2, KIND_INT4Z = 3 };

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f,
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Two codes (byte c of the words of rows k and k + 1) as a bf16 pair, low
// nibbles (h = 0) or high nibbles (h = 1) for the packed kinds. A nibble n
// becomes the bf16 bit pattern 0x4300 | n = 128 + n, and one bf16 subtraction
// of 136 (c - 8) or 128 (raw c) gives the exact code.
template <int KIND>
__device__ __forceinline__ uint32_t decode_pair(uint32_t w0, uint32_t w1, int c, int h,
                                                const __nv_bfloat16* lut) {
  const uint32_t pair = __byte_perm(w0, w1, c | ((4 + c) << 8));  // byte c of w0 | byte c of w1 << 16
  if (KIND == KIND_INT8)
    return pack2(__float2bfloat16_rn((float)(int8_t)(pair & 0xffu)),
                 __float2bfloat16_rn((float)(int8_t)((pair >> 16) & 0xffu)));
  const uint32_t nib = (h ? pair >> 4 : pair) & 0x000f000fu;
  if (KIND == KIND_NF4) return pack2(lut[nib & 0xfu], lut[nib >> 16]);
  return bf16x2_sub(nib | 0x43004300u, KIND == KIND_INT4 ? 0x43084308u : 0x43004300u);
}

__device__ __forceinline__ float bf16_pair_sum(uint32_t v) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(v & 0xffffu))) +
         __bfloat162float(__ushort_as_bfloat16((unsigned short)(v >> 16)));
}

// Block tile (16 MT WM) x (8 NT WN) of WM x WN warps, each MT x NT mma tiles.
template <int KIND, int MT, int NT, int WM, int WN>
struct WoqTile {
  static constexpr bool PACKED = KIND != KIND_INT8;
  static constexpr int H = PACKED ? 2 : 1;  // halves: low / high nibble rows
  static constexpr int NTH = WM * WN * 32;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  static constexpr int A_PITCH = H * STAGE_ROWS * 2 + 16;  // bytes per x row in smem
  static constexpr int B_PITCH = H * STAGE_ROWS + 8;       // bf16 per weight column in smem
  static constexpr int A_BYTES = BM * A_PITCH;
  static constexpr size_t SMEM = 2 * A_BYTES + sizeof(__nv_bfloat16) * BN * B_PITCH;
  static constexpr int UNITS = (STAGE_ROWS / 2) * (BN / 4);  // 2-row x 4-column weight loads
  static constexpr int UPT = UNITS / NTH;
  static_assert(UNITS % NTH == 0, "stage must split evenly over the threads");
};

template <int KIND, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(WoqTile<KIND, MT, NT, WM, WN>::NTH)
woq_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
           const uint8_t* __restrict__ q,        // [K, N] int8 or [K/2, N] packed
           const float* __restrict__ s,          // [ng, N]
           const float* __restrict__ z,          // [ng, N] (KIND_INT4Z) or null
           float* __restrict__ dst,              // [M, N], or [splits, M, N] partials
           int M, int N, int K, int ng, int split_rows, int vec) {
  using T = WoqTile<KIND, MT, NT, WM, WN>;
  constexpr int H = T::H, BN = T::BN, UPT = T::UPT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;  // two stages of the x tile
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + 2 * T::A_BYTES);
  __shared__ __nv_bfloat16 lut[16];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM;
  const int wrow = wm * 16 * MT;  // this warp's first row in the tile
  const int nw = wn * 8 * NT;     // this warp's first column in the tile
  const int rows = T::PACKED ? K / 2 : K;
  const int g = K / ng;
  const int kb = blockIdx.z * split_rows;
  const int ke = min(kb + split_rows, rows);
  if (KIND == KIND_NF4 && tid < 16) lut[tid] = __float2bfloat16_rn(kNF4[tid]);

  float acc[MT][NT][4], part[H][MT][NT][4], rsum[H][MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0.f;
#pragma unroll
        for (int h = 0; h < H; ++h) part[h][mt][nt][e] = 0.f;
      }
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) rsum[h][mt][0] = rsum[h][mt][1] = 0.f;

  uint32_t w[UPT][2];
  auto load_w = [&](int r0) {
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int unit = tid + u * T::NTH;
      const int r = r0 + 2 * (unit / (BN / 4)), n = n0 + 4 * (unit % (BN / 4));
      w[u][0] = lia::load_w32(q, r, ke, n, N, vec);
      w[u][1] = lia::load_w32(q, r + 1, ke, n, N, vec);
    }
  };
  auto load_x = [&](int r0, int buf) {
    lia::load_a_stage<T::BM, H, 2, T::NTH>(As + buf * T::A_BYTES, T::A_PITCH,
                                           reinterpret_cast<const uint8_t*>(x), m0, M, K, r0, ke, tid);
    lia::cp_async_commit();
  };

  if (kb < ke) load_x(kb, 0);
  load_w(kb);
  int buf = 0;
  for (int r0 = kb; r0 < ke; r0 += STAGE_ROWS, buf ^= 1) {
    __syncthreads();  // the previous stage's fragments are read (and the LUT is written)
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int unit = tid + u * T::NTH;
      const int kl = 2 * (unit / (BN / 4)), nl = 4 * (unit % (BN / 4));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t* row = reinterpret_cast<uint32_t*>(Bs + (nl + c) * T::B_PITCH + kl);
#pragma unroll
        for (int h = 0; h < H; ++h) row[h * STAGE_ROWS / 2] = decode_pair<KIND>(w[u][0], w[u][1], c, h, lut);
      }
    }
    const bool more = r0 + STAGE_ROWS < ke;
    if (more) {  // the next stage's x tile and weight bytes are in flight during the mma below
      load_x(r0 + STAGE_ROWS, buf ^ 1);
      load_w(r0 + STAGE_ROWS);
      lia::cp_async_wait<1>();
    } else {
      lia::cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* Ab = As + buf * T::A_BYTES;

    for (int j = 0; j < STAGE_ROWS / 16 && r0 + 16 * j < ke; ++j) {
      const int r = r0 + 16 * j;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int kbyte = (h * STAGE_ROWS + 16 * j + 2 * tq) * 2;
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* p = Ab + (wrow + mt * 16 + gq) * T::A_PITCH + kbyte;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * T::A_PITCH);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * T::A_PITCH + 16);
          if (KIND == KIND_INT4Z) {
            rsum[h][mt][0] += bf16_pair_sum(a[mt][0]) + bf16_pair_sum(a[mt][2]);
            rsum[h][mt][1] += bf16_pair_sum(a[mt][1]) + bf16_pair_sum(a[mt][3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* brow = Bs + (nw + nt * 8 + gq) * T::B_PITCH + h * STAGE_ROWS + 16 * j + 2 * tq;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(part[h][mt][nt], a[mt], b0, b1);
        }
      }
      // a group ends after these 16 rows (or the block's range does): scale it
      if ((r + 16) % g != 0 && r + 16 != ke) continue;
      if (T::PACKED && ng == 1) {  // both halves are the one group: one sum, one scale
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          rsum[0][mt][0] += rsum[H - 1][mt][0];
          rsum[0][mt][1] += rsum[H - 1][mt][1];
          rsum[H - 1][mt][0] = rsum[H - 1][mt][1] = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              part[0][mt][nt][e] += part[H - 1][mt][nt][e];
              part[H - 1][mt][nt][e] = 0.f;
            }
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (h && ng == 1) continue;
        const int grp = ((h ? K / 2 : 0) + r) / g;
        float rs[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = rsum[h][mt][i];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            rs[mt][i] = v;
            rsum[h][mt][i] = 0.f;
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + nw + nt * 8 + tq * 2 + e;
            const float sc = n < N ? __ldg(s + (size_t)grp * N + n) : 0.f;
            const float zp = (KIND == KIND_INT4Z && n < N) ? __ldg(z + (size_t)grp * N + n) : 0.f;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                float p = part[h][mt][nt][2 * i + e];
                if (KIND == KIND_INT4Z) p -= rs[mt][i] * zp;
                acc[mt][nt][2 * i + e] += p * sc;
                part[h][mt][nt][2 * i + e] = 0.f;
              }
          }
      }
    }
  }
  lia::store_tile<MT, NT>(dst + (size_t)blockIdx.z * M * N, acc, m0 + wrow, n0 + nw, M, N, lane,
                          nullptr);
}

template <int KIND, int MT, int NT, int WM, int WN>
int launch(const void* x, const void* q, const void* s, const void* z, void* out, void* ws,
           int M, int N, int K, int ng, int splits, cudaStream_t stream) {
  using T = WoqTile<KIND, MT, NT, WM, WN>;
  auto kern = woq_kernel<KIND, MT, NT, WM, WN>;
  static const cudaError_t attr =  // once per instantiation: the launch sits on the decode path
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int rows = KIND == KIND_INT8 ? K : K / 2;
  const int unit = ng == 1 ? STAGE_ROWS : K / ng;
  const int split_rows = lia::rows_per_split(rows, unit, splits);
  const int vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  kern<<<grid, T::NTH, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s), static_cast<const float*>(z),
      static_cast<float*>(splits > 1 ? ws : out), M, N, K, ng, split_rows, vec);
  int rc = (int)cudaGetLastError();
  if (rc == 0 && splits > 1)
    rc = lia::launch_sum_splits(static_cast<const float*>(ws), static_cast<float*>(out),
                                (size_t)M * N, splits, stream);
  return rc;
}

// Decode-sized M: one 16-row tile, 32 columns a block (K split over blocks);
// larger M: 64 x 64 tiles (four warps of 32 x 32). 128 x 64 tiles of eight
// warps unpack each weight tile half as often but ran slower on the H100 at
// OPT-6.7B's prefill shapes: one such block fits an SM where three of these do.
template <int KIND>
int launch_m(const void* x, const void* q, const void* s, const void* z, void* out, void* ws,
             int M, int N, int K, int ng, int splits, cudaStream_t st) {
  if (M <= 16) return launch<KIND, 1, 1, 1, 4>(x, q, s, z, out, ws, M, N, K, ng, splits, st);
  return launch<KIND, 2, 4, 2, 2>(x, q, s, z, out, ws, M, N, K, ng, splits, st);
}

}  // namespace

// kind: 0 int8 [K, N], 1 int4 (c - 8), 2 NF4, 3 int4 raw codes with zero-points z
// (the 4-bit kinds [K/2, N] half-split). ws is a [splits, M, N] fp32 workspace
// when splits > 1. Returns a cudaError_t value: 0 on a successful launch. The
// wrapper checks types, shapes and the kernel's rules: the rows walked (K, or
// K/2 packed) and the group size are multiples of 16, and a packed half holds
// whole groups.
extern "C" int lia_woq_matmul(const void* x, const void* q, const void* s, const void* z,
                              void* out, void* ws, int M, int N, int K, int ng, int kind,
                              int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ng < 1 || K % ng != 0 || splits < 1 || (kind == KIND_INT4Z && z == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case KIND_INT8: return launch_m<KIND_INT8>(x, q, s, z, out, ws, M, N, K, ng, splits, st);
    case KIND_INT4: return launch_m<KIND_INT4>(x, q, s, z, out, ws, M, N, K, ng, splits, st);
    case KIND_NF4: return launch_m<KIND_NF4>(x, q, s, z, out, ws, M, N, K, ng, splits, st);
    case KIND_INT4Z: return launch_m<KIND_INT4Z>(x, q, s, z, out, ws, M, N, K, ng, splits, st);
  }
  return (int)cudaErrorInvalidValue;
}
