// W4A8 matmul: int8 activations (per-token scales) x int4 weights in groups,
// fp32 out, with or without per-group zero-points.
//
// Replaces lia_tpu/ops/pallas_matmul.py:w4a8_matmul (_w4a8_kernel and
// _w4a8z_kernel). Same math:
//   y[m, n] = sx[m] * sum_g s[g, n] * (xq_g @ (c - 8)_g  -  [z] rowsum(xq_g) * (z[g, n] - 8))
// Nibbles are unpacked to signed int8 (c - 8, for the biased symmetric codes
// and the raw zero-point codes alike, as the TPU kernel rebases both), each
// group's product is an exact int32 sum on the tensor cores (mma.sync
// m16n8k16 s8 x s8 -> s32), and only a finished group sum is converted to fp32
// and scaled; the zero-point form subtracts the group's int32 row sum times
// (z - 8) first. Weights are [K/2, N] bytes in the global half-split: byte r
// holds row r (low nibble) and row K/2 + r (high nibble).
//
// What bounds it on an H100: at decode (M = 16) bytes, the packed weight read
// once (OPT-6.7B fc1: 33.5 MB, 10 us at 3.35 TB/s); at prefill (M = 4096) the
// int8 tensor-core rate. Design: the TPU kernel's sequential K grid axis and
// its VMEM accumulator become a K loop inside each block. Blocks own an output
// tile (16 x 32 at decode, 64 x 64 above, four warps either way);
// each stage of STAGE_ROWS packed rows is read once, coalesced along N (a
// thread takes 4 rows x 4 columns), unpacked with byte-wise SIMD ops,
// transposed in registers (byte_perm) and stored to shared memory
// K-contiguous, the B-fragment layout; the stage's xq tile is copied to shared
// memory with cp.async. The next stage's xq tile and weight bytes are in
// flight while the tensor cores work. At decode K is split over gridDim.z so
// every SM has blocks in flight; fp32 partials (whole groups each) are summed
// by a second launch. TMA, deeper pipelines and wgmma are later work.
#include "qmatmul.cuh"

namespace {

using lia::STAGE_ROWS;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// 4 rows x 4 columns of bytes (one word per row) → one word per column.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&col)[4]) {
  const uint32_t t01l = __byte_perm(r[0], r[1], 0x5140), t23l = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t01h = __byte_perm(r[0], r[1], 0x7362), t23h = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t01l, t23l, 0x5410);
  col[1] = __byte_perm(t01l, t23l, 0x7632);
  col[2] = __byte_perm(t01h, t23h, 0x5410);
  col[3] = __byte_perm(t01h, t23h, 0x7632);
}

// Block tile (16 MT WM) x (8 NT WN) of WM x WN warps, each MT x NT mma tiles.
template <int MT, int NT, int WM, int WN>
struct W4a8Tile {
  static constexpr int NTH = WM * WN * 32;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  static constexpr int A_PITCH = 2 * STAGE_ROWS + 16;  // bytes per xq row in smem, both halves
  static constexpr int B_PITCH = 2 * STAGE_ROWS + 16;  // bytes per weight column in smem
  static constexpr int A_BYTES = BM * A_PITCH;
  static constexpr size_t SMEM = 2 * A_BYTES + BN * B_PITCH;
  static constexpr int UNITS = (STAGE_ROWS / 4) * (BN / 4);  // 4-row x 4-column weight loads
  static constexpr int UPT = UNITS / NTH;
  static_assert(UNITS % NTH == 0, "stage must split evenly over the threads");
};

template <bool ZP, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(W4a8Tile<MT, NT, WM, WN>::NTH)
w4a8_kernel(const int8_t* __restrict__ xq,   // [M, K]
            const float* __restrict__ sx,    // [M] per-token scales
            const uint8_t* __restrict__ q,   // [K/2, N] half-split nibbles
            const float* __restrict__ s,     // [ng, N]
            const float* __restrict__ z,     // [ng, N] raw-code zero-points (ZP) or null
            float* __restrict__ dst,         // [M, N], or [splits, M, N] partials
            int M, int N, int K, int ng, int split_rows, int vec) {
  using T = W4a8Tile<MT, NT, WM, WN>;
  constexpr int BN = T::BN, UPT = T::UPT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* As = smem;  // two stages of the xq tile
  uint8_t* Bs = smem + 2 * T::A_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * T::BM;
  const int wrow = wm * 16 * MT;
  const int nw = wn * 8 * NT;
  const int Kh = K / 2, g = K / ng;
  const int kb = blockIdx.z * split_rows;
  const int ke = min(kb + split_rows, Kh);

  float acc[MT][NT][4];
  int part[2][MT][NT][4], rsum[2][MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f, part[0][mt][nt][e] = part[1][mt][nt][e] = 0;
    rsum[0][mt][0] = rsum[0][mt][1] = rsum[1][mt][0] = rsum[1][mt][1] = 0;
  }

  uint32_t w[UPT][4];
  auto load_w = [&](int r0) {
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int unit = tid + u * T::NTH;
      const int r = r0 + 4 * (unit / (BN / 4)), n = n0 + 4 * (unit % (BN / 4));
#pragma unroll
      for (int i = 0; i < 4; ++i) w[u][i] = lia::load_w32(q, r + i, ke, n, N, vec);
    }
  };
  auto load_x = [&](int r0, int buf) {
    lia::load_a_stage<T::BM, 2, 1, T::NTH>(As + buf * T::A_BYTES, T::A_PITCH,
                                          reinterpret_cast<const uint8_t*>(xq), m0, M, K, r0, ke, tid);
    lia::cp_async_commit();
  };

  if (kb < ke) load_x(kb, 0);
  load_w(kb);
  int buf = 0;
  for (int r0 = kb; r0 < ke; r0 += STAGE_ROWS, buf ^= 1) {
    __syncthreads();  // the previous stage's fragments are read
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int unit = tid + u * T::NTH;
      const int kl = 4 * (unit / (BN / 4)), nl = 4 * (unit % (BN / 4));
      uint32_t lo[4], hi[4], lo_t[4], hi_t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // nibble -> signed byte (c - 8), four at a time
        lo[i] = __vsub4(w[u][i] & 0x0f0f0f0fu, 0x08080808u);
        hi[i] = __vsub4((w[u][i] >> 4) & 0x0f0f0f0fu, 0x08080808u);
      }
      transpose4x4(lo, lo_t);
      transpose4x4(hi, hi_t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t* row = reinterpret_cast<uint32_t*>(Bs + (nl + c) * T::B_PITCH + kl);
        row[0] = lo_t[c];
        row[STAGE_ROWS / 4] = hi_t[c];
      }
    }
    const bool more = r0 + STAGE_ROWS < ke;
    if (more) {  // the next stage's xq tile and weight bytes are in flight during the mma below
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
      for (int h = 0; h < 2; ++h) {
        const int kbyte = h * STAGE_ROWS + 16 * j + 4 * tq;
        uint32_t a[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* p = Ab + (wrow + mt * 16 + gq) * T::A_PITCH + kbyte;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * T::A_PITCH);
          if (ZP) {
            rsum[h][mt][0] = __dp4a((int)a[mt][0], 0x01010101, rsum[h][mt][0]);
            rsum[h][mt][1] = __dp4a((int)a[mt][1], 0x01010101, rsum[h][mt][1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t b = *reinterpret_cast<const uint32_t*>(
              Bs + (nw + nt * 8 + gq) * T::B_PITCH + h * STAGE_ROWS + 16 * j + 4 * tq);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_s8(part[h][mt][nt], a[mt], b);
        }
      }
      // a group ends after these 16 rows (or the block's range does): scale it
      if ((r + 16) % g != 0 && r + 16 != ke) continue;
      if (ng == 1) {  // both halves are the one group: one exact int32 sum
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          rsum[0][mt][0] += rsum[1][mt][0];
          rsum[0][mt][1] += rsum[1][mt][1];
          rsum[1][mt][0] = rsum[1][mt][1] = 0;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[0][mt][nt][e] += part[1][mt][nt][e], part[1][mt][nt][e] = 0;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h && ng == 1) continue;
        const int grp = ((h ? Kh : 0) + r) / g;
        float rs[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            int v = rsum[h][mt][i];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            rs[mt][i] = (float)v;
            rsum[h][mt][i] = 0;
          }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + nw + nt * 8 + tq * 2 + e;
            const float sc = n < N ? __ldg(s + (size_t)grp * N + n) : 0.f;
            const float z8 = (ZP && n < N) ? __ldg(z + (size_t)grp * N + n) - 8.f : 0.f;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                float p = (float)part[h][mt][nt][2 * i + e];
                if (ZP) p -= rs[mt][i] * z8;
                acc[mt][nt][2 * i + e] += p * sc;
                part[h][mt][nt][2 * i + e] = 0;
              }
          }
      }
    }
  }
  lia::store_tile<MT, NT>(dst + (size_t)blockIdx.z * M * N, acc, m0 + wrow, n0 + nw, M, N, lane, sx);
}

template <bool ZP, int MT, int NT, int WM, int WN>
int launch(const void* xq, const void* sx, const void* q, const void* s, const void* z, void* out,
           void* ws, int M, int N, int K, int ng, int splits, cudaStream_t stream) {
  using T = W4a8Tile<MT, NT, WM, WN>;
  auto kern = w4a8_kernel<ZP, MT, NT, WM, WN>;
  static const cudaError_t attr =  // once per instantiation: the launch sits on the decode path
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int unit = ng == 1 ? STAGE_ROWS : K / ng;
  const int split_rows = lia::rows_per_split(K / 2, unit, splits);
  const int vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, splits);
  kern<<<grid, T::NTH, T::SMEM, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(q), static_cast<const float*>(s), static_cast<const float*>(z),
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
template <bool ZP>
int launch_m(const void* xq, const void* sx, const void* q, const void* s, const void* z,
             void* out, void* ws, int M, int N, int K, int ng, int splits, cudaStream_t st) {
  if (M <= 16) return launch<ZP, 1, 1, 1, 4>(xq, sx, q, s, z, out, ws, M, N, K, ng, splits, st);
  return launch<ZP, 2, 4, 2, 2>(xq, sx, q, s, z, out, ws, M, N, K, ng, splits, st);
}

}  // namespace

// z null: biased symmetric codes; else raw codes with per-group zero-points.
// ws is a [splits, M, N] fp32 workspace when splits > 1. Returns a
// cudaError_t value: 0 on a successful launch. The wrapper checks types,
// shapes and the kernel's rules: K/2 and the group size are multiples of 16,
// and ng is 1 or even with whole groups in each packed half.
extern "C" int lia_w4a8_matmul(const void* xq, const void* sx, const void* q, const void* s,
                               const void* z, void* out, void* ws, int M, int N, int K, int ng,
                               int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ng < 1 || K % ng != 0 || splits < 1 || (ng > 1 && ng % 2 != 0))
    return (int)cudaErrorInvalidValue;
  if (z) return launch_m<true>(xq, sx, q, s, z, out, ws, M, N, K, ng, splits, st);
  return launch_m<false>(xq, sx, q, s, z, out, ws, M, N, K, ng, splits, st);
}
