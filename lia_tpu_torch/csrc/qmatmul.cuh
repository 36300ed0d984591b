// The quantized-matmul body for Hopper (sm_90a), shared by w4a8_matmul.cu
// (int8 activations x int4 weights, exact s32 sums) and woq_matmul.cu (bf16
// activations x int8 / int4 / NF4 / zero-point int4 weights, fp32 sums). The
// math is the TPU kernels': every group's product is summed on the tensor
// cores and only a finished group sum is scaled, after the zero-point
// correction rowsum(x_g) * z_g where there is one (row sums from a first
// launch, rowsum_kernel, once per row and group). The weight stays in the
// reference's layout: [rows, N] bytes, for the 4-bit kinds the global
// half-split (byte r holds row r in its low nibble and row K/2 + r in its
// high one); scales and zero-points [ng, N] f32; out [M, N] f32.
//
// A block owns 128 weight columns and walks the weight rows through a ring of
// mbarrier stages: per stage a TMA box of the raw weight tile [UK rows x 128
// columns] (128-byte swizzled; rows past the weight and columns past N read
// as zeros), the activation boxes and the rows of scales (zero-points, row
// sums) the stage's groups need. Where the weight's row stride is not a
// multiple of 16 bytes, TMA cannot describe it, and a warp copies the raw tile
// and the scales by hand in the same layouts. UK is one 128-byte row of
// activations: 128 rows for int8, 64 for bf16. Two regimes, chosen by the
// wrapper from M:
//  - M > 16 (prefill), bound by the tensor cores: two consumer warpgroups own
//    128 rows of M (64 each, so each unpacked weight tile feeds 128 rows) and a
//    producer warpgroup keeps the ring full (setmaxnreg moves its registers to
//    the consumers). A stage carries both halves' activation boxes and one raw
//    tile (each raw byte crosses L2 once); the consumers unpack the next stage
//    into shared memory in the wgmma operand layout, a tile a half, while this
//    stage's wgmmas run, each half into its own partial: s8 wgmma takes only
//    K-major operands, so the W4A8 unpack transposes 4 x 4 byte blocks in
//    registers; bf16 takes the weight MN-major, as it lies. A finished group
//    is scaled after the wait and before the next stage's wgmmas go out:
//    ptxas serializes every wgmma of a kernel in which an instruction reads
//    an accumulator while a wgmma is in flight, or waits in a divergent
//    path. Groups that end inside a stage (and W4A8 groups of 16, 48, ...
//    rows, whose 16-row steps keep each chunk of codes beside a chunk of
//    zeros) take a second instantiation, a half a stage, that waits for each
//    wgmma.
//  - M <= 16 (decode), bound by the weight bytes: no producer, three blocks an
//    SM. Each warp takes 16 columns as two mma.sync n8 tiles and 16 (W4A8: 32)
//    rows a step: the raw bytes of its column pairs become both halves' B
//    fragments in registers (both nibbles of every byte from one read), the
//    tokens' A fragments come from the activation boxes, and a group is scaled
//    where it ends. The warps meet once a stage, after which warps 0-3 refill
//    its slot.
// Where the tiles do not fill the card the wrapper splits the walk over
// gridDim.z in whole groups; every block writes its fp32 partial, and the
// last block of a tile (a ticket counter that it leaves at zero) adds them in
// split order.
#pragma once

#include <string.h>

#include <type_traits>

#include "hopper.cuh"

namespace lia_qmm {

using namespace lia;

enum Kind { WOQ_INT8 = 0, WOQ_INT4 = 1, WOQ_NF4 = 2, WOQ_INT4Z = 3, W4A8 = 4 };

constexpr int BN = 128;         // weight columns a block
constexpr int CONSUMERS = 256;  // two consumer warpgroups
// At decode the consumers issue the copies themselves (three blocks an SM,
// at most 80 registers a thread); at prefill a producer warpgroup does, and
// setmaxnreg hands most of its registers to the consumers: 40 / 232 for
// W4A8, whose consumers need more, 56 / 224 for the weight-only kinds, whose
// producer does (each a split of 384 x 168; ptxas spills with less).
template <bool DECODE>
constexpr int threads() { return DECODE ? CONSUMERS : CONSUMERS + 128; }

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f, -0.39491748809814453f,
    -0.28444138169288635f, -0.18477343022823334f, -0.09105003625154495f, 0.0f,
    0.07958029955625534f, 0.16093020141124725f, 0.24611230194568634f,
    0.33791524171829224f, 0.44070982933044434f, 0.5626170039176941f,
    0.7229568362236023f, 1.0f,
};

template <int KIND, bool DECODE, bool WHOLE = true>
struct Geo {
  static constexpr bool S8 = KIND == W4A8;
  static constexpr bool PACKED = KIND != WOQ_INT8;
  static constexpr int H = PACKED ? 2 : 1;         // weight halves (nibbles)
  static constexpr int ES = S8 ? 1 : 2;            // bytes an activation element
  static constexpr int UK = 128 / ES;              // walk rows a unit
  static constexpr int BM = DECODE ? 16 : 128;     // activation rows a block
  // halves a stage: both (one raw tile, both nibbles) at decode and in the
  // pipelined prefill body; one in the stepwise one
  static constexpr int UPS = DECODE || WHOLE ? H : 1;
  static constexpr int X_BOX = BM * 128;           // one activation box, bytes
  static constexpr int X_BYTES = UPS * X_BOX;
  static constexpr int RAW_BYTES = UK * BN;        // the raw weight tile, bytes
  static constexpr int STAGES = DECODE ? (S8 ? 3 : 4) : 6;  // at most; fewer where shared memory ends
  // (decode: three blocks an SM)
  static constexpr int U_BYTES = UK * BN * (S8 ? 1 : 2);  // an unpacked unit
  static constexpr int NACC = DECODE ? 8 : 64;     // accumulator registers a thread
  static constexpr int NP = H;                     // group partials in flight: a half's each
  static constexpr int PRODUCER_REGS = S8 ? 40 : 56, CONSUMER_REGS = S8 ? 232 : 224;  // prefill's setmaxnreg
  static_assert(X_BOX % 1024 == 0 && RAW_BYTES % 1024 == 0 && U_BYTES % 1024 == 0,
                "swizzled tiles sit on 1024-byte atoms");
};

constexpr int SMEM_MAX = 232448;  // a block's shared memory on an H100

// Shared-memory layout of one block (offsets from a 1024-aligned base): a
// ring of `stages` stages, each the activation boxes, the raw weight tile
// and, for each unit, the scales (and zero-points and row sums) of the
// `maxg` groups it can overlap; then the two unpacked buffers (doubled for
// 16-row steps), the NF4 table, the barriers and the split's flag.
struct Lay {
  uint32_t stages, stage, sc, zc, rs, rs_unit, tx, u, u_bytes, lut, bar, flag, bytes;
};

template <int KIND, bool DECODE, bool WHOLE = true>
__host__ __device__ inline Lay layout(int maxg, int step16, bool zp) {
  using G = Geo<KIND, DECODE, WHOLE>;
  Lay l;
  uint32_t o = G::X_BYTES + G::RAW_BYTES;
  l.sc = o;
  o += G::UPS * maxg * BN * 4;
  l.zc = o;
  if (zp) o += G::UPS * maxg * BN * 4;
  l.rs = o;
  l.rs_unit = (maxg * G::BM * 4 + 127) & ~127u;  // TMA writes shared memory on 128 bytes
  if (zp) o += G::UPS * l.rs_unit;
  l.tx = o;  // bytes a stage's copies land
  l.stage = (o + 1023) & ~1023u;
  // an unpacked buffer, its halves U_BYTES apart (decode builds its fragments in registers)
  l.u_bytes = DECODE ? 0 : G::UPS * G::U_BYTES * (step16 ? 2 : 1);
  const uint32_t tail = 2 * l.u_bytes + 64 + 16 * G::STAGES + 16 + 1024;  // + slack for the alignment
  l.stages = G::STAGES;
  while (l.stages > 2 && l.stages * l.stage + tail > SMEM_MAX) --l.stages;
  o = l.stages * l.stage;
  l.u = o;
  o += 2 * l.u_bytes;
  l.lut = o;
  o += 64;
  l.bar = o;
  o += 16 * G::STAGES;
  l.flag = o;
  o += 16;
  l.bytes = o + 1024;
  return l;
}

struct Params {
  const void* x;          // [M, K] int8 (W4A8) or bf16
  const float* sx;        // [M] per-token scales (W4A8)
  const uint8_t* q;       // [rows, N] weight bytes (layer 0 of a stack)
  const float* s;         // [ng, N]
  const float* z;         // [ng, N] zero-points, or null
  const float* rs;        // [ng, Mp] row sums of x per group, zero-point kinds
  float* out;             // [M, N]
  float* ws;              // [splits, M, N] partials where splits > 1
  unsigned int* tickets;  // [tiles], zero between launches, where splits > 1
  const int* layer;       // STACKED: the layer, device int32
  int L;
  long long q_stride, s_stride;  // STACKED: bytes and floats between layers
  int M, Mp, N, K, ng, g, rows, split_rows, splits, tma_w, step16, maxg;
};

// ---------------------------------------------------------------------------
// shared-memory access by address
// ---------------------------------------------------------------------------


__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts128(uint32_t a, uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(x), "r"(y), "r"(z), "r"(w) : "memory");
}
// v as a float: exactly, by the bit pattern of 1.5 * 2^23 + v where |v| < 2^22
// (two full-rate operations), else by the quarter-rate conversion.
__device__ __forceinline__ float exact_float(int v, bool small) {
  return small ? __int_as_float(v + 0x4B400000) - 12582912.f : __int2float_rn(v);
}

// ---------------------------------------------------------------------------
// unpacking one unit: UK raw rows (one nibble) -> the wgmma operand
// ---------------------------------------------------------------------------

// 4 rows x 4 columns of bytes (one word per row) -> one word per column.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3, uint32_t (&col)[4]) {
  const uint32_t t01l = __byte_perm(r0, r1, 0x5140), t23l = __byte_perm(r2, r3, 0x5140);
  const uint32_t t01h = __byte_perm(r0, r1, 0x7362), t23h = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(t01l, t23l, 0x5410);
  col[1] = __byte_perm(t01l, t23l, 0x7632);
  col[2] = __byte_perm(t01h, t23h, 0x5410);
  col[3] = __byte_perm(t01h, t23h, 0x7632);
}

// D (16 x 8, s32) += A (16 x 32, s8, row) * B (32 x 8, s8, col): decode's tensor-core step.
__device__ __forceinline__ void mma_s8_k32(int& c0, int& c1, int& c2, int& c3, uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// The same over 16 rows (W4A8 groups that are not a multiple of 32 rows).
__device__ __forceinline__ void mma_s8(int& c0, int& c1, int& c2, int& c3, uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
               : "+r"(c0), "+r"(c1), "+r"(c2), "+r"(c3)
               : "r"(a0), "r"(a1), "r"(b));
}
// D (16 x 8, fp32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2, float& c3, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return v;
}

// Prefill, W4A8: nibble h of raw rows [0, 128) (rows >= nv read as code 8,
// i.e. 0) as signed c - 8, written K-major [128 columns][128 rows] in
// 128-byte swizzled rows. With 16-row steps chunk c (16 rows) goes to
// position 2c + (c & 1) of a 256-byte row (two atoms of 128 rows), a zero
// chunk beside it. Thread: rows 16c..16c+15 of columns 4 lane..4 lane + 3,
// with c = (warp + lane / 2) % 8, so that a quarter warp's stores and a
// warp's loads hit distinct banks.
__device__ __forceinline__ void unpack_s8(uint32_t raw, uint32_t u, int h, int nv, int step16, int ct) {
  constexpr int UK = 128;
  const int warp = ct >> 5, lane = ct & 31;
  const int c = (warp + (lane >> 1)) & 7, l4 = lane >> 2;
  const uint32_t base = raw + c * 16 * 128 + ((lane & 3) << 2);
  uint32_t col[4][4];  // [4-row block][column]: four rows' codes of one column
#pragma unroll
  for (int b = 0; b < 4; ++b) {  // a block at a time: 4 rows live beside the columns
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = lds32(base + (4 * b + i) * 128 + ((l4 ^ ((4 * b + i) & 7)) << 4));
    if (nv < UK) {  // the walk's last rows: code 8 (0 after the bias) past them
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (16 * c + 4 * b + i >= nv) w[i] = 0x88888888u;
    }
    uint32_t t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)  // c - 8 in each byte: c + 0x78 stays below 0x100, and bit 7 flips
      t[i] = (((w[i] >> (4 * h)) & 0x0f0f0f0fu) + 0x78787878u) ^ 0x80808080u;
    transpose4x4(t[0], t[1], t[2], t[3], col[b]);
  }
  const int d = step16 ? 2 * c + (c & 1) : c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = 4 * lane + j;
    sts128(u + (d >> 3) * (BN * 128) + n * 128 + (((d & 7) ^ (n & 7)) << 4), col[0][j], col[1][j], col[2][j],
           col[3][j]);
  }
}

// The zero chunks beside the 16-row steps' code chunks (written once).
__device__ __forceinline__ void zero_step16_chunks(uint32_t u, int ct) {
  for (int i = ct; i < 8 * BN; i += CONSUMERS) {
    const int c = i / BN, n = i % BN;
    const int d = 2 * c + 1 - (c & 1);
    sts128(u + (d >> 3) * (BN * 128) + n * 128 + (((d & 7) ^ (n & 7)) << 4), 0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// Four codes (the bytes of word v: columns 4i..4i+3) as two bf16 pairs.
template <int KIND>
__device__ __forceinline__ void decode4(uint32_t v, int h, uint32_t lut, uint32_t& lo, uint32_t& hi) {
  if (KIND == WOQ_INT8) {
    const __nv_bfloat162 a = __floats2bfloat162_rn((float)(int8_t)(v & 0xff), (float)(int8_t)((v >> 8) & 0xff));
    const __nv_bfloat162 b = __floats2bfloat162_rn((float)(int8_t)((v >> 16) & 0xff), (float)(int8_t)(v >> 24));
    lo = *reinterpret_cast<const uint32_t*>(&a);
    hi = *reinterpret_cast<const uint32_t*>(&b);
    return;
  }
  const uint32_t nib = (v >> (4 * h)) & 0x0f0f0f0fu;
  if (KIND == WOQ_NF4) {
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint16_t t;
      asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(t) : "r"(lut + 2 * ((nib >> (8 * i)) & 0xf)));
      e[i] = t;
    }
    lo = e[0] | (e[1] << 16);
    hi = e[2] | (e[3] << 16);
    return;
  }
  // a nibble n as the bf16 bit pattern 0x4300 | n = 128 + n; one bf16x2
  // subtraction of 136 (c - 8) or 128 (raw c) gives the exact code
  const uint32_t bias = KIND == WOQ_INT4 ? 0x43084308u : 0x43004300u;
  lo = bf16x2_sub(__byte_perm(nib, 0x43u, 0x4140), bias);
  hi = bf16x2_sub(__byte_perm(nib, 0x43u, 0x4342), bias);
}

// Decode's B fragments of one k pair (rows r, r + 1) for two columns: w holds
// [col a row r, col b row r, col a row r + 1, col b row r + 1]; t0 gets
// column a's two codes as a bf16 pair (row r low), t1 column b's.
template <int KIND>
__device__ __forceinline__ void decode_pairs(uint32_t w, int h, uint32_t lut, uint32_t& t0, uint32_t& t1) {
  if (KIND == WOQ_INT8) {
    const __nv_bfloat162 a = __floats2bfloat162_rn((float)(int8_t)(w & 0xff), (float)(int8_t)((w >> 16) & 0xff));
    const __nv_bfloat162 b = __floats2bfloat162_rn((float)(int8_t)((w >> 8) & 0xff), (float)(int8_t)(w >> 24));
    t0 = *reinterpret_cast<const uint32_t*>(&a);
    t1 = *reinterpret_cast<const uint32_t*>(&b);
    return;
  }
  const uint32_t nib = (w >> (4 * h)) & 0x0f0f0f0fu;
  if (KIND == WOQ_NF4) {
    uint32_t e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint16_t v;
      asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(lut + 2 * ((nib >> (8 * i)) & 0xf)));
      e[i] = v;
    }
    t0 = e[0] | (e[2] << 16);
    t1 = e[1] | (e[3] << 16);
    return;
  }
  const uint32_t bias = KIND == WOQ_INT4 ? 0x43084308u : 0x43004300u;  // 128 + 8 (c - 8) or 128 (raw c)
  t0 = bf16x2_sub(__byte_perm(nib, 0x43u, 0x4240), bias);
  t1 = bf16x2_sub(__byte_perm(nib, 0x43u, 0x4341), bias);
}

// Prefill, weight-only: nibble h (or the int8 byte) of raw rows [0, 64)
// (rows >= nv as 0) as bf16 codes, written MN-major [64 rows][128 columns]
// as two 128-byte-swizzled boxes of 64 columns. Thread: row k, columns
// 16 n16..+15, twice; a quarter warp takes 8 rows of one column chunk
// (distinct banks).
template <int KIND>
__device__ __forceinline__ void unpack_bf16(uint32_t raw, uint32_t u, int h, int nv, uint32_t lut, int ct) {
  constexpr int UK = 64;
  const int warp = ct >> 5, lane = ct & 31;
  const int n16 = 4 * (warp & 1) + (lane >> 3), ch = 2 * (n16 & 3);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int k = (lane & 7) + 8 * ((warp >> 1) + 4 * it);
    const uint4 v = lds128(raw + k * 128 + ((n16 ^ (k & 7)) << 4));
    const uint32_t row = u + (n16 >> 2) * 8192 + k * 128;
    uint32_t o[8];
    decode4<KIND>(v.x, h, lut, o[0], o[1]);
    decode4<KIND>(v.y, h, lut, o[2], o[3]);
    decode4<KIND>(v.z, h, lut, o[4], o[5]);
    decode4<KIND>(v.w, h, lut, o[6], o[7]);
    if (nv < UK && k >= nv) {  // the walk's last rows: code 0 past them
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = 0u;
    }
    sts128(row + ((ch ^ (k & 7)) << 4), o[0], o[1], o[2], o[3]);
    sts128(row + (((ch + 1) ^ (k & 7)) << 4), o[4], o[5], o[6], o[7]);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int KIND, bool ZP, bool DECODE, bool STACKED, bool WHOLE>
__global__ void __launch_bounds__(threads<DECODE>(), DECODE ? 3 : 1)
qmm_kernel(const __grid_constant__ CUtensorMap tmx,  // activations [M, K], boxes of UK x BM
           const __grid_constant__ CUtensorMap tmw,  // weight [(L,) rows, N] bytes, boxes of 128 x UK (tma_w)
           const __grid_constant__ CUtensorMap tms,  // scales [(L,) ng, N], boxes of 128 x maxg (tma_w)
           const __grid_constant__ CUtensorMap tmz,  // zero-points, as the scales (ZP, tma_w)
           const __grid_constant__ CUtensorMap tmr,  // row sums [ng, Mp], boxes of BM x maxg (ZP)
           const Params p) {
  using G = Geo<KIND, DECODE, WHOLE>;
  using PT = typename std::conditional<G::S8, int, float>::type;
  constexpr int UK = G::UK, H = G::H, BM = G::BM, NACC = G::NACC, UPS = G::UPS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_addr(smem_raw);
  const uint32_t sb = (raw_base + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (sb - raw_base);
  const Lay lay = layout<KIND, DECODE, WHOLE>(p.maxg, p.step16, ZP);
  const int stages = lay.stages;
  const uint32_t full0 = sb + lay.bar, empty0 = full0 + 8 * G::STAGES;
  const int maxg = p.maxg;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.split_rows;
  int ke = min(kb + p.split_rows, p.rows);
  const int Kh = p.K / 2;

  const uint8_t* q = p.q;
  const float* s = p.s;
  const float* z = p.z;
  int layer = 0;
  bool bad = false;
  if (STACKED) {  // one read of the layer index a block, then plain offsets
    layer = __ldg(p.layer);
    bad = layer < 0 || layer >= p.L;
    if (bad) {
      ke = kb;  // nothing is read
    } else {
      q += (size_t)layer * p.q_stride;
      s += (size_t)layer * p.s_stride;
      if (ZP) z += (size_t)layer * p.s_stride;
    }
  }
  const int span = max(ke - kb, 0);
  constexpr bool BOTH = UPS == H;               // a stage carries both halves
  const int nsh = (span + UK - 1) / UK;          // stages of one half
  const int nst = BOTH ? nsh : nsh * H;          // stages
  const int units = nst * UPS;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      // the expect-tx arrival, and at prefill without TMA for the weight the
      // 64 producer lanes that copy it
      mbar_init(full0 + 8 * i, !DECODE && !p.tma_w ? 65 : 1);
      mbar_init(empty0 + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_tensormap(&tmx);
    if (p.tma_w) {
      prefetch_tensormap(&tmw);
      prefetch_tensormap(&tms);
      if (ZP) prefetch_tensormap(&tmz);
    }
    if (ZP) prefetch_tensormap(&tmr);
  }
  __syncthreads();

  // Stage st's copies into ring slot `slot`, one kind a warp so that no
  // thread issues them all: 0 the expected bytes and the activation boxes,
  // 1 the raw weight tile, 2 each unit's scales (and zero-points), 3 each
  // unit's row sums; TMA boxes from lane 0, completing on the slot's full
  // barrier. Where TMA cannot read the weight, kinds 1 and 2 are copied by
  // the warp's 32 lanes in TMA's layouts. At decode the consumers' warps 0-3
  // refill a slot once the end-of-stage barrier says it is read; at prefill
  // the producer warpgroup's warps do, once the empty barrier says so.
  const bool vec4 = (p.N % 4 == 0) && (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  auto load_kind = [&](int kind, int st, int slot, int lane) {
    const int h = BOTH ? 0 : st / nsh, r0 = kb + (BOTH ? st : st - h * nsh) * UK;
    const uint32_t full = full0 + 8 * slot, xs = sb + slot * lay.stage, wsm = xs + G::X_BYTES;
    auto group0 = [&](int hh) { return p.ng == 1 ? 0 : ((G::PACKED ? (BOTH ? hh : h) * Kh : 0) + r0) / p.g; };
    if (kind == 0) {
      if (lane == 0) {
        // bytes landing: every box in full, rows and columns past the tensor as zeros
        const uint32_t rs_tx = ZP ? UPS * maxg * BM * 4 : 0;
        mbar_expect_tx(full, (p.tma_w ? G::RAW_BYTES + UPS * maxg * BN * 4 * (ZP ? 2 : 1) : 0) + G::X_BYTES + rs_tx);
        if (BOTH) {
#pragma unroll
          for (int hh = 0; hh < H; ++hh) tma_load(xs + hh * G::X_BOX, &tmx, full, hh * Kh + r0, m0);
        } else {
          tma_load(xs, &tmx, full, (G::PACKED ? h * Kh : 0) + r0, m0);
        }
      }
    } else if (kind == 1) {
      if (p.tma_w) {
        if (lane == 0) {
          if (STACKED) tma_load(wsm, &tmw, full, n0, r0, layer);
          else tma_load(wsm, &tmw, full, n0, r0);
        }
      } else {  // the raw tile by hand
        for (int idx = lane; idx < UK * 32; idx += 32) {
          const int r = idx >> 5, wd = idx & 31;
          const int gr = r0 + r, n = n0 + 4 * wd;
          uint32_t v = 0u;
          if (gr < p.rows) {
            const uint8_t* src = q + (size_t)gr * p.N + n;
            if (vec4 && n + 3 < p.N) {
              v = __ldg(reinterpret_cast<const unsigned int*>(src));
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (n + c < p.N) v |= (uint32_t)__ldg(src + c) << (8 * c);
            }
          }
          sts32(wsm + r * 128 + (((wd >> 2) ^ (r & 7)) << 4) + ((wd & 3) << 2), v);
        }
      }
    } else if (kind == 2) {
      for (int hh = 0; hh < UPS; ++hh) {
        const int g0 = group0(hh);
        const uint32_t so = hh * maxg * BN * 4;
        if (p.tma_w) {
          if (lane == 0) {
            if (STACKED) {
              tma_load(xs + lay.sc + so, &tms, full, n0, g0, layer);
              if (ZP) tma_load(xs + lay.zc + so, &tmz, full, n0, g0, layer);
            } else {
              tma_load(xs + lay.sc + so, &tms, full, n0, g0);
              if (ZP) tma_load(xs + lay.zc + so, &tmz, full, n0, g0);
            }
          }
        } else {  // scales and zero-points by hand
          for (int i = lane; i < maxg * BN; i += 32) {
            const int gi = g0 + i / BN, n = n0 + i % BN;
            const bool ok = gi < p.ng && n < p.N;
            const uint32_t o = so + 4 * i;
            sts32(xs + lay.sc + o, ok ? __float_as_uint(__ldg(s + (size_t)gi * p.N + n)) : 0u);
            if (ZP) sts32(xs + lay.zc + o, ok ? __float_as_uint(__ldg(z + (size_t)gi * p.N + n)) : 0u);
          }
        }
      }
    } else if (ZP && lane == 0) {
#pragma unroll
      for (int hh = 0; hh < UPS; ++hh) tma_load(xs + lay.rs + hh * lay.rs_unit, &tmr, full, m0, group0(hh));
    }
  };
  // a consumer-side refill (decode): warps 0-3, each its kind
  auto load_stage = [&](int st, int slot) {
    if (tid < 128) load_kind(tid >> 5, st, slot, tid & 31);
  };

  if constexpr (!DECODE) {
    if (tid >= CONSUMERS) {  // ---- the producer warpgroup: warp w - 8 issues kind w - 8 ----
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(G::PRODUCER_REGS) : "memory");
      const int kind = (tid - CONSUMERS) >> 5, lane = tid & 31;
      if (kind == 3 && !ZP) return;
      int slot = 0, phase = 0;
      for (int st = 0; st < nst; ++st) {
        mbar_wait(empty0 + 8 * slot, phase ^ 1);
        load_kind(kind, st, slot, lane);
        if (!p.tma_w && (kind == 1 || kind == 2)) mbar_arrive(full0 + 8 * slot);  // the copies are in place
        if (++slot == stages) slot = 0, phase ^= 1;
      }
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(G::CONSUMER_REGS) : "memory");
  } else {
    for (int st = 0; st < min(stages, nst); ++st) load_stage(st, st);
    if (!p.tma_w) named_sync(1, CONSUMERS);  // the hand copies are in place
  }

  // ---- the consumers: both warpgroups ----
  const int ct = tid, wg = ct >> 7, wl = (ct >> 5) & 3, lane = ct & 31;
  // this thread's accumulator element e: activation row ml(e), weight column nl(e)
  // (decode: warp w's two n8 tiles, tile j's column c the block's column
  // 16 w + 2 c + j, rows the tokens; prefill: the wgmma fragment of 64 rows)
  auto ml = [&](int e) {
    return DECODE ? (lane >> 2) + 8 * ((e >> 1) & 1) : 64 * wg + 16 * wl + (lane >> 2) + 8 * ((e >> 1) & 1);
  };
  auto nl = [&](int e) {
    return DECODE ? 16 * (ct >> 5) + 2 * (2 * (lane & 3) + (e & 1)) + (e >> 2) : 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
  };
  const uint32_t lut = sb + lay.lut;
  if (KIND == WOQ_NF4 && ct < 16) {
    const __nv_bfloat16 v = __float2bfloat16_rn(kNF4[ct]);
    *reinterpret_cast<__nv_bfloat16*>(smem + lay.lut + 2 * ct) = v;
  }
  if (G::S8 && p.step16) {
    zero_step16_chunks(sb + lay.u, ct);
    zero_step16_chunks(sb + lay.u + lay.u_bytes, ct);
  }
  named_sync(1, CONSUMERS);

  float acc[NACC];
  PT P[G::NP][NACC];
  bool fresh[G::NP];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < G::NP; ++i) {
    fresh[i] = true;
#pragma unroll
    for (int e = 0; e < NACC; ++e) P[i][e] = 0;
  }
  // int32 group sums below 2^22 convert by their bit pattern
  const bool small = p.ng > 1 && p.g * 1016 < (1 << 22);

  // acc += s * (sum - rowsum * z), group row j of a unit's scales at offset so
  auto scale = [&](const PT(&sum)[NACC], uint32_t xs, int hh, int j) {
    const float* S = reinterpret_cast<const float*>(smem + (xs - sb) + lay.sc + ((hh * maxg + j) * BN) * 4);
    const float* Z = reinterpret_cast<const float*>(smem + (xs - sb) + lay.zc + ((hh * maxg + j) * BN) * 4);
    const float* R = reinterpret_cast<const float*>(smem + (xs - sb) + lay.rs + hh * lay.rs_unit + j * BM * 4);
    auto body = [&](bool sm) {
#pragma unroll
      for (int e = 0; e < NACC; ++e) {
        const int n = nl(e);
        float v = G::S8 ? exact_float((int)sum[e], sm) : (float)sum[e];
        if (ZP) v -= R[ml(e)] * (G::S8 ? Z[n] - 8.f : Z[n]);
        acc[e] = fmaf(v, S[n], acc[e]);
      }
    };
    if (!G::S8 || small) body(true);
    else body(false);
  };

  // one wgmma of walk rows [ss k, ss (k + 1)) of a unit: activations at xu,
  // unpacked weights at ub (with 16-row steps the activations' 32-byte step
  // is k / 2 and the weights' rows sit doubled)
  auto mma = [&](auto& Pr, uint32_t xu, uint32_t ub, int k, int acc_in, bool s16) {
    if constexpr (G::S8) {
      const int kw = s16 ? k >> 1 : k;
      const uint32_t wofs = s16 ? (k >> 2) * (BN * 128) + ((32 * k) & 127) : 32 * k;
      wgmma_s8_n128(Pr, desc_sw128(xu + wg * 8192 + 32 * kw, 16, 1024), desc_sw128(ub + wofs, 16, 1024), acc_in);
    } else {
      wgmma_bf16_n128_tb(Pr, desc_sw128(xu + wg * 8192 + 32 * k, 16, 1024), desc_sw128(ub + 2048 * k, 8192, 1024),
                         acc_in);
    }
  };

  // (prefill) Groups that end only at stage ends (a multiple of UK rows, or
  // one group) take the WHOLE body; other groups (and W4A8's 16-row steps)
  // a body that waits for each wgmma and finishes a group where it ends.
  const int upg = p.ng == 1 ? 0 : p.g / UK;  // stages a group (a walk starts on a group)
  int ug = 0;                                // stages of the current group so far
  const int ss = G::S8 && !p.step16 ? 32 : 16;  // walk rows a wgmma
  constexpr int KSTEPS = UK / (G::S8 ? 32 : 16);
  // the group partial of half h ends after walk row e
  auto ends = [&](int h, int e) { return p.ng > 1 ? (e % p.g == 0 || e == ke) : (e == ke && h == H - 1); };
  // (prefill) scale a finished group: its row j among the unit's scales
  auto finish = [&](auto& Pr, bool& fr, uint32_t xs, int hh, int j) {
    scale(Pr, xs, hh, j);
    fr = true;
  };
  // (prefill) a unit one wgmma at a time (groups that end inside units)
  auto stepwise = [&](auto& Pr, bool& fr, uint32_t xs, uint32_t xu, uint32_t ub, int hh, int h, int r0) {
    const int hb = G::PACKED ? h * Kh : 0, nv = min(UK, ke - r0);
    const int g0 = p.ng == 1 ? 0 : (hb + r0) / p.g;
    for (int k = 0; k < (nv + ss - 1) / ss; ++k) {
      wgmma_fence();
      mma(Pr, xu, ub, k, fr ? 0 : 1, p.step16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(Pr);
      fr = false;
      const int e = r0 + min((k + 1) * ss, nv);
      if (ends(h, e)) finish(Pr, fr, xs, hh, p.ng == 1 ? 0 : (hb + e - 1) / p.g - g0);
    }
  };

  int slot = 0, phase = 0;  // the current stage's ring slot and fill parity
  if constexpr (DECODE) {
    // A stage at a time, each warp its 16 columns as two mma.sync n8 tiles,
    // 16 rows a step: the step's raw bytes of the warp's column pairs (2
    // bytes a row, both tiles) become both halves' B fragments in registers,
    // the tokens' A fragments come from the activation boxes, and a group
    // is scaled where it ends. No unpacked tile, no proxy fence: the warps
    // meet once a stage, when its slot is read.
    const int w = ct >> 5, g8 = lane >> 2, t4 = lane & 3;
    int gr = 0;  // rows of the current group so far
    for (int st = 0; st < nst; ++st) {
      const uint32_t xs = sb + slot * lay.stage, raw = xs + G::X_BYTES;
      const int r0 = kb + st * UK, nv = min(UK, ke - r0);
      mbar_wait(full0 + 8 * slot, phase);
      int j = 0;  // the group's row among the stage's scales
      // W4A8 groups of a multiple of 32 rows take 32-row mma steps: half the
      // tokens' fragments and mma instructions a row
      const bool k32 = G::S8 && !p.step16 && (nv & 31) == 0;
#pragma unroll
      for (int k = 0; k < UK / 16; ++k) {
        if (16 * k >= nv) break;
        auto rawrow = [&](int r) { return lds16(raw + r * 128 + ((w ^ (r & 7)) << 4) + 2 * g8); };
        if constexpr (G::S8) {
          // rows 16k + 4t4 + i: column 16w + 2g8 in the low byte, + 1 in the high one
          auto quad = [&](int r, uint32_t& wa, uint32_t& wb) {
            const uint32_t x01 = __byte_perm(rawrow(r), rawrow(r + 1), 0x5410);
            const uint32_t x23 = __byte_perm(rawrow(r + 2), rawrow(r + 3), 0x5410);
            wa = __byte_perm(x01, x23, 0x6420), wb = __byte_perm(x01, x23, 0x7531);
          };
          auto code = [](uint32_t v, int hh) { return (((v >> (4 * hh)) & 0x0f0f0f0fu) + 0x78787878u) ^ 0x80808080u; };
          if (k32) {
            if (k & 1) continue;  // the odd 16 rows go with the even step
            uint32_t wa0, wb0, wa1, wb1;
            quad(16 * k + 4 * t4, wa0, wb0);
            quad(16 * k + 16 + 4 * t4, wa1, wb1);
#pragma unroll
            for (int hh = 0; hh < H; ++hh) {
              const uint32_t xh = xs + hh * G::X_BOX + 4 * t4;
              const uint32_t c0 = (k ^ g8) << 4, c1 = ((k + 1) ^ g8) << 4;
              const uint32_t a0 = lds32(xh + g8 * 128 + c0), a1 = lds32(xh + (g8 + 8) * 128 + c0);
              const uint32_t a2 = lds32(xh + g8 * 128 + c1), a3 = lds32(xh + (g8 + 8) * 128 + c1);
              mma_s8_k32(P[hh][0], P[hh][1], P[hh][2], P[hh][3], a0, a1, a2, a3, code(wa0, hh), code(wa1, hh));
              mma_s8_k32(P[hh][4], P[hh][5], P[hh][6], P[hh][7], a0, a1, a2, a3, code(wb0, hh), code(wb1, hh));
            }
          } else {
            uint32_t wa, wb;
            quad(16 * k + 4 * t4, wa, wb);
#pragma unroll
            for (int hh = 0; hh < H; ++hh) {
              const uint32_t xh = xs + hh * G::X_BOX + ((k ^ g8) << 4) + 4 * t4;
              const uint32_t a0 = lds32(xh + g8 * 128), a1 = lds32(xh + (g8 + 8) * 128);
              mma_s8(P[hh][0], P[hh][1], P[hh][2], P[hh][3], a0, a1, code(wa, hh));
              mma_s8(P[hh][4], P[hh][5], P[hh][6], P[hh][7], a0, a1, code(wb, hh));
            }
          }
        } else {
          // rows 16k + 2t4 (+1, +8, +9): k pairs of the B fragments
          const uint32_t w01 = __byte_perm(rawrow(16 * k + 2 * t4), rawrow(16 * k + 2 * t4 + 1), 0x5410);
          const uint32_t w89 = __byte_perm(rawrow(16 * k + 2 * t4 + 8), rawrow(16 * k + 2 * t4 + 9), 0x5410);
#pragma unroll
          for (int hh = 0; hh < H; ++hh) {
            const uint32_t xh = xs + hh * G::X_BOX + 4 * t4;
            const uint32_t c0 = ((2 * k) ^ g8) << 4, c1 = ((2 * k + 1) ^ g8) << 4;
            const uint32_t a0 = lds32(xh + g8 * 128 + c0), a1 = lds32(xh + (g8 + 8) * 128 + c0);
            const uint32_t a2 = lds32(xh + g8 * 128 + c1), a3 = lds32(xh + (g8 + 8) * 128 + c1);
            uint32_t b[2][2];  // [tile][k pair]
            decode_pairs<KIND>(w01, hh, lut, b[0][0], b[1][0]);
            decode_pairs<KIND>(w89, hh, lut, b[0][1], b[1][1]);
            mma_bf16(P[hh][0], P[hh][1], P[hh][2], P[hh][3], a0, a1, a2, a3, b[0][0], b[0][1]);
            mma_bf16(P[hh][4], P[hh][5], P[hh][6], P[hh][7], a0, a1, a2, a3, b[1][0], b[1][1]);
          }
        }
        const int stepk = G::S8 && k32 ? 2 : 1;  // 16-row steps this one took
        gr += 16 * stepk;
        const int e = r0 + 16 * (k + stepk);
        if (p.ng > 1 ? (gr == p.g || e == ke) : e == ke) {  // the group ends with this step
          gr = 0;
#pragma unroll
          for (int hh = 0; hh < H; ++hh) {
            if (p.ng == 1 && H == 2 && hh == 0) continue;  // one group over both halves: one sum, below
            if (p.ng == 1 && H == 2) {
#pragma unroll
              for (int i = 0; i < NACC; ++i) P[0][i] += P[1][i];
              scale(P[0], xs, hh, j);
            } else {
              scale(P[hh], xs, hh, j);
            }
          }
#pragma unroll
          for (int hh = 0; hh < H; ++hh)
#pragma unroll
            for (int i = 0; i < NACC; ++i) P[hh][i] = 0;
          ++j;
        }
      }
      named_sync(1, CONSUMERS);  // the stage is read
      if (st + stages < nst) load_stage(st + stages, slot);  // refill it
      if (++slot == stages) slot = 0, phase ^= 1;
    }
  } else {
    // a unit at a time (one half's rows). With whole units the partials
    // ping-pong by group: while a unit's wgmmas run, the previous group is
    // scaled out of the other partial and the next unit is unpacked.
    auto unpack1 = [&](int slot_, uint32_t ub_, int h_, int r_) {
      const uint32_t raw = sb + slot_ * lay.stage + G::X_BYTES;
      if constexpr (G::S8) unpack_s8(raw, ub_, h_, min(UK, ke - r_), p.step16, ct);
      else unpack_bf16<KIND>(raw, ub_, h_, min(UK, ke - r_), lut, ct);
    };
    if constexpr (WHOLE) {
      // Groups end only at stage ends. A stage carries both halves: its raw
      // tile is read once, each half unpacked into its tile, each half's
      // wgmmas accumulate into its partial. The next stage is unpacked while
      // this one's wgmmas run; a group that ends is scaled after the wait and
      // before the next stage's wgmmas go out, so that no instruction reads
      // an accumulator while a wgmma is in flight (ptxas serializes every
      // wgmma of a kernel that does).
      auto unpack_stage = [&](int slot_, uint32_t ub_, int r_) {
#pragma unroll
        for (int hh = 0; hh < H; ++hh) unpack1(slot_, ub_ + hh * G::U_BYTES, hh, r_);
      };
      auto issue_stage = [&](uint32_t xs_, uint32_t ub_, int acc_in) {
        wgmma_fence();
#pragma unroll
        for (int hh = 0; hh < H; ++hh)
#pragma unroll
          for (int k = 0; k < KSTEPS; ++k) mma(P[hh], xs_ + hh * G::X_BOX, ub_ + hh * G::U_BYTES, k, k == 0 ? acc_in : 1, false);
        wgmma_commit();
      };
      if (nst > 0) {
        mbar_wait(full0, 0);
        unpack_stage(0, sb + lay.u, kb);
      }
      fence_proxy_async();
      named_sync(1, CONSUMERS);
      if (nst > 0) issue_stage(sb, sb + lay.u, 0);
      for (int st = 0; st < nst; ++st) {
        const int r0 = kb + st * UK, nv = min(UK, ke - r0);
        const int slot1 = slot + 1 == stages ? 0 : slot + 1, phase1 = slot1 == 0 ? phase ^ 1 : phase;
        const uint32_t ub1 = sb + lay.u + ((st + 1) & 1) * lay.u_bytes;
        const bool more = st + 1 < nst;
        if (more) {
          mbar_wait(full0 + 8 * slot1, phase1);
          unpack_stage(slot1, ub1, r0 + UK);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int hh = 0; hh < H; ++hh) fence_regs(P[hh]);
        const bool last = r0 + nv == ke;
        const bool end = p.ng > 1 ? (++ug == upg || last) : last;  // both halves' groups end together
        if (end) {
          ug = 0;
          const uint32_t xs = sb + slot * lay.stage;
          if (p.ng == 1 && H == 2) {  // one group over both halves: one sum
#pragma unroll
            for (int i = 0; i < NACC; ++i) P[0][i] += P[H - 1][i];
            scale(P[0], xs, 0, 0);
          } else {
#pragma unroll
            for (int hh = 0; hh < H; ++hh) scale(P[hh], xs, hh, 0);
          }
        }
        fence_proxy_async();
        named_sync(1, CONSUMERS);
        if (more) issue_stage(sb + slot1 * lay.stage, ub1, end ? 0 : 1);
        if (ct == 0) mbar_arrive(empty0 + 8 * slot);  // the slot is read
        slot = slot1, phase = phase1;
      }
    } else {
      // a unit (one half's UK rows) a stage, one wgmma at a time
      auto& Pr = P[0];
      bool& fr = fresh[0];
      if (units > 0) {
        mbar_wait(full0, 0);
        unpack1(0, sb + lay.u, 0, kb);
      }
      fence_proxy_async();
      named_sync(1, CONSUMERS);
      int h = 0, r0 = kb;
      for (int u = 0; u < units; ++u) {
        const uint32_t xs = sb + slot * lay.stage;
        const uint32_t ub = sb + lay.u + (u & 1) * lay.u_bytes;
        const int h1 = r0 + UK < ke ? h : h + 1, r1 = r0 + UK < ke ? r0 + UK : kb;
        const int slot1 = slot + 1 == stages ? 0 : slot + 1, phase1 = slot1 == 0 ? phase ^ 1 : phase;
        stepwise(Pr, fr, xs, xs, ub, 0, h, r0);
        if (u + 1 < units) {
          mbar_wait(full0 + 8 * slot1, phase1);
          unpack1(slot1, sb + lay.u + ((u + 1) & 1) * lay.u_bytes, h1, r1);
        }
        fence_proxy_async();
        named_sync(1, CONSUMERS);
        if (ct == 0) mbar_arrive(empty0 + 8 * slot);  // the slot is read
        h = h1, r0 = r1, slot = slot1, phase = phase1;
      }
    }
  }

  // ---- epilogue: out (or this split's partial), then the tile's last split adds them ----
  if (STACKED && bad) {
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = __int_as_float(0x7fc00000);  // NaN
  }
  const int M = p.M, N = p.N;
  float* dst = p.splits > 1 ? p.ws + (size_t)blockIdx.z * M * N : p.out;
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    const int m = m0 + ml(e), n = n0 + nl(e);
    if (m < M && n < N) dst[(size_t)m * N + n] = G::S8 ? acc[e] * __ldg(p.sx + m) : acc[e];
  }
  if (p.splits == 1) return;
  __threadfence();
  named_sync(1, CONSUMERS);
  volatile int* flag = reinterpret_cast<volatile int*>(smem + lay.flag);
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (ct == 0) *flag = atomicAdd(p.tickets + tile, 1u) == (unsigned)(p.splits - 1);
  named_sync(1, CONSUMERS);
  if (!*flag) return;
  __threadfence();
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    const int m = m0 + ml(e), n = n0 + nl(e);
    if (m < M && n < N) {
      float a = 0.f;
      for (int zz = 0; zz < p.splits; ++zz) a += __ldcg(p.ws + ((size_t)zz * M + m) * N + n);
      p.out[(size_t)m * N + n] = a;
    }
  }
  if (ct == 0) p.tickets[tile] = 0u;
}

// rs[gi, m] = sum of x[m, k] over group gi's columns, as fp32 (exact for
// int8 activations: the int32 sum is below 2^24), rows Mp apart. One thread
// a (row, group).
template <bool S8>
__global__ void rowsum_kernel(const void* __restrict__ x, float* __restrict__ rs, int M, int Mp, int K, int ng) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * ng) return;
  const int m = i / ng, gi = i % ng, g = K / ng;
  float out;
  if (S8) {
    const uint4* src = reinterpret_cast<const uint4*>(static_cast<const int8_t*>(x) + (size_t)m * K + (size_t)gi * g);
    int sum = 0;
    for (int k = 0; k < g / 16; ++k) {
      const uint4 v = __ldg(src + k);
      sum = __dp4a((int)v.x, 0x01010101, sum);
      sum = __dp4a((int)v.y, 0x01010101, sum);
      sum = __dp4a((int)v.z, 0x01010101, sum);
      sum = __dp4a((int)v.w, 0x01010101, sum);
    }
    out = (float)sum;
  } else {
    const uint4* src =
        reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(x) + (size_t)m * K + (size_t)gi * g);
    float sum = 0.f;
    for (int k = 0; k < g / 8; ++k) {
      const uint4 v = __ldg(src + k);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        sum += f.x;
        sum += f.y;
      }
    }
    out = sum;
  }
  rs[(size_t)gi * Mp + m] = out;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A row-major [rows, cols] (or [L, rows, cols]) tensor of `dtype` as boxes
// of box_cols x box_rows, 128-byte swizzled or not; out-of-range elements
// read as zeros.
inline bool tile_map(CUtensorMap* map, CUtensorMapDataType dtype, int es, const void* ptr, int rows, int cols,
                     int box_cols, int box_rows, bool swizzle, bool stacked = false, int L = 1,
                     long long layer_bytes = 0) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * es, (cuuint64_t)layer_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, dtype, stacked ? 3 : 2, const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Groups a unit of UK walk rows can overlap: its first row sits a multiple
// of UK past a group boundary; and whether W4A8 takes 16-row steps.
inline int max_groups(int uk, int ng, int g) {
  if (ng == 1) return 1;
  return uk % g == 0 ? uk / g : (uk + g - 1) / g + 1;
}
inline int takes_step16(bool s8, int ng, int g) { return s8 && ng > 1 && g % 32 != 0; }

template <int KIND, bool ZP, bool DECODE, bool STACKED, bool WHOLE>
int launch(Params p, cudaStream_t stream) {
  using G = Geo<KIND, DECODE, WHOLE>;
  auto kern = qmm_kernel<KIND, ZP, DECODE, STACKED, WHOLE>;
  static const cudaError_t attr = [&] {  // once an instantiation: a block may take all the SM's shared
    // memory, and the SM keeps its largest carveout so that decode's blocks fit three an SM
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tmx, tmw, tms, tmz, tmr;
  memset(&tmw, 0, sizeof(tmw));
  memset(&tms, 0, sizeof(tms));
  memset(&tmz, 0, sizeof(tmz));
  memset(&tmr, 0, sizeof(tmr));
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!tile_map(&tmx, G::S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, G::ES, p.x, p.M,
                p.K, G::UK, G::BM, true))
    return (int)cudaErrorInvalidValue;
  if (p.tma_w) {
    const long long sl = p.s_stride * 4;
    if (!tile_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.q, p.rows, p.N, BN, G::UK, true, STACKED, p.L,
                  p.q_stride) ||
        !tile_map(&tms, f32, 4, p.s, p.ng, p.N, BN, p.maxg, false, STACKED, p.L, sl) ||
        (ZP && !tile_map(&tmz, f32, 4, p.z, p.ng, p.N, BN, p.maxg, false, STACKED, p.L, sl)))
      return (int)cudaErrorInvalidValue;
  }
  if (ZP) {
    if (!tile_map(&tmr, f32, 4, p.rs, p.ng, p.Mp, G::BM, p.maxg, false)) return (int)cudaErrorInvalidValue;
    const int n = p.M * p.ng, threads = 128;
    rowsum_kernel<G::S8><<<(n + threads - 1) / threads, threads, 0, stream>>>(p.x, const_cast<float*>(p.rs), p.M,
                                                                             p.Mp, p.K, p.ng);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const Lay lay = layout<KIND, DECODE, WHOLE>(p.maxg, p.step16, ZP);
  if (lay.bytes > (uint32_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  dim3 grid((p.N + BN - 1) / BN, DECODE ? 1 : (p.M + G::BM - 1) / G::BM, p.splits);
  kern<<<grid, threads<DECODE>(), lay.bytes, stream>>>(tmx, tmw, tms, tmz, tmr, p);
  return (int)cudaGetLastError();
}

// Checks the plan's arguments against the kernel's rules and launches the
// regime's instantiation. Returns a cudaError_t value, 0 on success.
template <int KIND, bool ZP, bool STACKED>
int run(Params p, int decode, cudaStream_t stream) {
  constexpr bool S8 = KIND == W4A8, PACKED = KIND != WOQ_INT8;
  const int K = p.K, ng = p.ng;
  if (p.M < 1 || p.N < 1 || ng < 1 || K % ng != 0 || p.splits < 1) return (int)cudaErrorInvalidValue;
  p.g = K / ng;
  p.rows = PACKED ? K / 2 : K;
  p.Mp = (p.M + 3) & ~3;  // the row sums' row stride: 16-byte rows for TMA
  const bool whole = !PACKED || ng == 1 || (ng % 2 == 0 && (K / 2) % p.g == 0);
  if (!whole || p.rows % 16 != 0 || (ng > 1 && p.g % 16 != 0) || (ZP && (!p.z || !p.rs)) || (decode && p.M > 16))
    return (int)cudaErrorInvalidValue;
  const int unit = ng == 1 ? 16 : p.g;
  if (p.split_rows < 1 || p.split_rows % unit != 0 || (long long)p.split_rows * p.splits < p.rows ||
      (long long)p.split_rows * (p.splits - 1) >= p.rows || (p.splits > 1 && (!p.ws || !p.tickets)) ||
      (ZP && ng == 1 && p.splits > 1))
    return (int)cudaErrorInvalidValue;
  const auto a16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (p.tma_w && (p.N % 16 != 0 || !a16(p.q) || !a16(p.s) || (ZP && !a16(p.z)) ||
                  (STACKED && (p.q_stride % 16 != 0 || p.s_stride % 4 != 0))))
    return (int)cudaErrorInvalidValue;
  const int uk = Geo<KIND, false>::UK;
  p.step16 = takes_step16(S8, ng, p.g);
  p.maxg = max_groups(uk, ng, p.g);
  // Prefill: groups that end only at unit ends take the pipelined body,
  // others (and W4A8's 16-row steps) a body that waits for each wgmma; at
  // decode one body takes both.
  if (decode) return launch<KIND, ZP, true, STACKED, true>(p, stream);
  if (!p.step16 && (ng == 1 || p.g % uk == 0)) return launch<KIND, ZP, false, STACKED, true>(p, stream);
  return launch<KIND, ZP, false, STACKED, false>(p, stream);
}

// Dynamic shared memory of one block, in bytes (for the build report).
template <int KIND>
int smem_bytes(int decode, int K, int ng, int zp) {
  const int g = K / ng;
  const int uk = Geo<KIND, false>::UK;
  const int maxg = max_groups(uk, ng, g), step16 = takes_step16(KIND == W4A8, ng, g);
  if (decode) return (int)layout<KIND, true>(maxg, step16, zp).bytes;
  const bool whole = !step16 && (ng == 1 || g % uk == 0);
  return (int)(whole ? layout<KIND, false, true>(maxg, step16, zp) : layout<KIND, false, false>(maxg, step16, zp)).bytes;
}

}  // namespace lia_qmm

