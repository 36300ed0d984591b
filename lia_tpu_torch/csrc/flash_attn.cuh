// Causal GQA flash attention of C query rows over a key/value plane, bf16 in
// and out, written for Hopper (sm_90a): the kernel body of flash_prefill.cu (a
// left-padded prompt attending to itself) and flash_cached.cu (a prompt chunk
// attending to the cache plane that already holds it).
//
// Query row t of sequence b sits at key slot base_b + t (base_b = 0 for a
// prompt) and attends keys [start_b, base_b + t], with a sliding window only
// keys > base_b + t - window; start_b = base_b + C - popcount(kv_mask[b]) is
// counted on the device and base_b is read from device memory, so the caller
// never syncs with the host. Math as the TPU kernels: scores are bf16 dots with
// fp32 accumulation, scaled after the dot by scale*log2(e) so the online
// softmax runs in exp2 units; the probabilities are rounded to bf16 before
// P.V, as the TPU kernels cast them to V's dtype; out = acc / max(l, 1e-30).
// Fully masked rows (a left-padded chunk's pad rows) come out finite and
// meaningless. With ALiBi slopes (common.cuh: alibi_slope), row t's score of
// key kp takes slope * log2(e) * (kp - (base_b + t)) in fp32 after the scale;
// the reference's bias is slope * (kp - start_b), which differs by a constant
// a row. The term is a template flag (ALIBI): its instances send every tile
// down the masked path (the interior shortcut skips the per-key positions),
// and the instances without it are those before the port of ALiBi (a
// runtime branch cost them 1-2% on an H100, chip_ab.py).
//
// What bounds it on an H100: bytes, at both entry points' timed shapes (the
// notes in flash_prefill.cu and flash_cached.cu give the figures). The design
// keeps the tensor cores and the copy engine busy at once and the card full:
//  - A block owns a tile of 64 query rows of one kv head, so K/V are never
//    replicated across heads. Up to G = 64 a tile holds 64 / G whole
//    positions of the G query heads (row r: position pos0 + r / G, head r %
//    G). A larger group (Falcon-7B's G = 71) takes the FLAT instantiation:
//    tile rows are the flat (position, head) index f = t * G + g, rows f0 ..
//    f0 + 63 of tile f0 / 64, so a position's heads straddle two tiles and
//    each row keeps its own causal and window limit. (The flat mapping gives
//    the same tiles where G divides 64; it is kept apart because its
//    prologue measured 3-7% slower at OPT-6.7B's b16 s256 on an H100.) It is one
//    producer warp and one consumer warpgroup, or, where the grid is at most
//    one block an SM, two consumer warpgroups that take alternate K/V tiles
//    of the walk and merge their (o, m, l) through shared memory at the end.
//  - The producer warp streams the tile's 64-key K/V tiles by TMA into a ring
//    of shared-memory stages (full/empty mbarriers), from a 3-D tensor map over
//    [B * N_kv, S_kv, D] that fills rows past S_kv, and columns past D, with
//    zeros. Tiles land 128-byte swizzled, one 64-column box per 64 head dims.
//  - Head dims: the body computes over a width DP of 64, 128 or 256 (the
//    template parameter) and reads and writes rows D apart (a runtime
//    argument): D = 80, 96 and 112 run at DP = 128, their Q columns past D loaded
//    as zeros and their K/V columns past D filled with zeros by the tensor
//    map, so the padded products add nothing; only D columns are stored. (An
//    exact D = 80 or 96 instance would skip 3/8 or 1/4 of the QK^T steps and
//    P.V columns.) At DP = 256 the O accumulator is 128 fp32 registers a
//    thread: one consumer warpgroup, one block an SM (255 registers), three
//    stages of 64 KB.
//  - Both products are wgmma: S = Q.K^T with Q (loaded once, written in the
//    same swizzle) and K from shared memory; O += P.V with P from registers
//    (the fp32 S accumulator rounded to bf16 becomes the next A fragment) and
//    V from shared memory as the MN-major B operand.
//  - Two one-warpgroup blocks fit an SM (~80 KB of shared memory and <= 168
//    registers a thread each), so one block's softmax runs under the other's
//    products; two warpgroups do the same inside one block.
//  - The prologue costs one memory round trip: Q's loads are in flight while
//    the block counts the mask 16 bytes a thread, and the producer prefetches
//    its tensor maps.
//  - The per-element mask runs only on the tiles that straddle start_b, the
//    row tile's causal frontier, the window edge or S_kv; interior tiles skip it.
//  - When the (row tile, kv head, batch row) tiles fill at most half the SMs,
//    the host splits each tile's walk [j_lo, j_hi) into `parts` (up to one
//    block an SM). The wrapper makes both grid choices, `parts` and the
//    warpgroups a block (flash_split_parts and flash_warpgroups in
//    lia_tpu_torch/ops/cuda_attention.py), and the tile sizes come from there
//    too, as -D flags of the build. Each part writes fp32 partials (unnormalised o, m, l) to a
//    workspace and merge_kernel combines them: out = sum 2^(m_i - m) o_i /
//    max(sum 2^(m_i - m) l_i, 1e-30). A part with no tiles leaves m = -inf,
//    l = 0. The split is deterministic and needs no memset.
#pragma once

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace lia_flash {

using namespace lia;  // the PTX wrappers of hopper.cuh

#if !defined(LIA_FLASH_ROWS) || !defined(LIA_FLASH_BK)
#error "the build passes the tile sizes: FLASH_ROWS and FLASH_BK of lia_tpu_torch/ops/cuda_attention.py"
#endif
constexpr int ROWS = LIA_FLASH_ROWS;  // query rows per block
constexpr int BK = LIA_FLASH_BK;      // keys per tile
static_assert(ROWS == 64 && BK == 64, "the body is written for one wgmma m64 row tile and 64-key boxes");
constexpr int WG = 128;              // threads of a consumer warpgroup
constexpr int BOX_COLS = 64;         // bf16 columns of one 128-byte swizzled box
constexpr int BOX_BYTES = 64 * 128;  // a box of 64 rows
constexpr int MERGE_WARPS = 4;

// A block of NW consumer warpgroups, which split the tile's key walk (tile i
// to warpgroup i % NW), and one producer warp. Its shared memory: the Q tile,
// the K and V tiles of each stage, the full and empty barriers, and with two
// warpgroups the second's (o, m, l) for the merge.
template <int DP, int NW>
struct Layout {
  static constexpr int THREADS = NW * WG + 32;
  static constexpr int BOXES = DP / BOX_COLS;
  static constexpr int TILE = BOXES * BOX_BYTES;  // 64 rows of Q, K or V
  // one warpgroup: ~80 / ~72 KB, two blocks an SM (DP = 256: ~225 KB, one);
  // two: one block an SM
  static constexpr int STAGES = NW == 2 ? 4 : DP == 256 ? 3 : DP == 128 ? 2 : 4;
  static constexpr int K_OFF = TILE;
  static constexpr int V_OFF = K_OFF + STAGES * TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
  static constexpr int MERGE_OFF = BAR_OFF + 2 * STAGES * 8;
  static constexpr int MERGE_FLOATS = NW == 2 ? (DP / 2 + 4) * WG : 0;
  static constexpr int BYTES = MERGE_OFF + 4 * MERGE_FLOATS + 1024;  // + slack for 1024-byte alignment
};

// ---------------------------------------------------------------------------
// Flash-specific helpers (the PTX wrappers are in hopper.cuh)
// ---------------------------------------------------------------------------

// Named barriers of the consumer warpgroups (id 1), and of the first alone
// (id 2); 0 is __syncthreads.
template <int NW>
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NW * WG) : "memory"); }
__device__ __forceinline__ void wg0_sync() { asm volatile("bar.sync 2, %0;\n" ::"n"(WG) : "memory"); }

// Byte offset of element (row, col) of a 64-row tile stored as 128-byte-swizzled
// boxes of 64 columns (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (col / BOX_COLS) * BOX_BYTES + row * 128 + ((((col % BOX_COLS) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// O (64 x DP) += P (registers) * V (shared, MN-major, at `v`), one 16-key
// step; DP = 256 as two n128 products over its column halves (boxes 0-1 and
// 2-3), accumulators o[0, 64) and o[64, 128).
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint32_t v);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint32_t v) {
  wgmma_rs_n64(o, a, desc_sw128(v, BOX_BYTES, 1024));
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint32_t v) {
  wgmma_rs_n128(o, a, desc_sw128(v, BOX_BYTES, 1024));
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128], const uint32_t (&a)[4], uint32_t v) {
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, desc_sw128(v, BOX_BYTES, 1024));
  wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), a, desc_sw128(v + 2 * BOX_BYTES, BOX_BYTES, 1024));
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// S = Q K^T over one K tile, issued and committed (not waited): sc[4n + e]
// holds row r0 (e < 2) or r0 + 8 of the warp, key 8n + 2t + (e & 1).
template <int DP>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_base, uint32_t k_base) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off = (ks / 4) * BOX_BYTES + (ks % 4) * 32;
    wgmma_ss_n64(sc, desc_sw128(q_base + off, 16, 1024), desc_sw128(k_base + off, 16, 1024), ks);
  }
  wgmma_commit();
}

// O += P V over one V tile, issued and committed: the probabilities of keys
// 16kk.. rounded to bf16 are the A fragment of the kk-th step; V's 16 key rows
// sit 2048 bytes apart.
template <int DP>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const float (&p)[32], uint32_t v_base) {
  uint32_t pa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(p[8 * kk + 2 * x], p[8 * kk + 2 * x + 1]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv<DP>(o, pa[kk], v_base + kk * 2048);
  wgmma_commit();
}

// Masks (off the interior), scales, adds the ALiBi term (off the interior:
// sl, each row's slope in exp2 units, 0 without ALiBi) and exponentiates one
// tile's scores in place, folding them into the running max m and sum l (a
// row's 64 keys are spread over the 4 lanes of a quad) and rescaling o.
template <int DP, bool ALIBI>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2], float (&o)[DP / 2],
                                             bool interior, int k0, int t, const int (&qpos)[2],
                                             const bool (&rvalid)[2], int start, int S_kv, int window,
                                             float sscale, const float (&sl)[2]) {
  float mt[2] = {LIA_NEG_INF, LIA_NEG_INF};
  if (!ALIBI && interior) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] *= sscale;
      mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], sc[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      const int kp = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
      const bool masked = !rvalid[i] || kp > qpos[i] || kp < start || kp >= S_kv ||
                          (window > 0 && kp <= qpos[i] - window);
      sc[e] = masked ? LIA_NEG_INF : ALIBI ? fmaf(sl[i], (float)(kp - qpos[i]), sc[e] * sscale) : sc[e] * sscale;
      mt[i] = fmaxf(mt[i], sc[e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    const float m_new = fmaxf(m[i], mt[i]);
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = (e >> 1) & 1;
    sc[e] = exp2f(sc[e] - m[i]);
    l[i] += sc[e];
  }
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
}

// Grid: (row tiles * parts, N_kv, B), row tiles ceil(C / (64 / G)), or with
// FLAT ceil(C * G / 64), the longest walks (the last row tiles) first. With
// parts == 1 the block writes `out`; otherwise its partials. NW: consumer
// warpgroups splitting the walk (2 where the grid is one block an SM). DP: the
// width computed over; rows of q, out and the partials are D apart.
template <int DP, int NW, bool FLAT, bool ALIBI>
__global__ void __launch_bounds__(Layout<DP, NW>::THREADS, NW == 1 && DP <= 128 ? 2 : 1)
flash_kernel(const __grid_constant__ CUtensorMap tmk,  // k [B * Nkv, S_kv, D]
             const __grid_constant__ CUtensorMap tmv,  // v [B * Nkv, S_kv, D]
             const __nv_bfloat16* __restrict__ q,      // [B, C, N, D]
             const uint8_t* __restrict__ kv_mask,      // [B, S_kv]
             const int* __restrict__ bases, int base_stride,  // [B] or scalar; null: 0
             __nv_bfloat16* __restrict__ out,          // [B, C, N, D]
             float* __restrict__ ws,                   // parts > 1: o [parts, R, D], m, l [parts, R]
             int parts, int C, int S_kv, int N, int Nkv, int G, int D, float sscale, int window,
             const float* __restrict__ slopes) {      // ALiBi [N] (ALIBI only)
  using L = Layout<DP, NW>;
  constexpr int CONSUMERS = NW * WG;
  constexpr int CHP = DP / 8;                   // 16-byte chunks of a row of the tile
  constexpr int QV = ROWS * CHP / CONSUMERS;    // of Q per consumer thread
  if (DP != 128) D = DP;                        // only width 128 takes several D
  const int CH = D / 8;                         // of a row in memory
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sb = (raw + 1023) & ~1023u;  // swizzled boxes want 1024-byte alignment
  unsigned char* smem = smem_raw + (sb - raw);
  const uint32_t full0 = sb + L::BAR_OFF, empty0 = full0 + 8 * L::STAGES;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_rt = gridDim.x / parts;
  const int rt = n_rt - 1 - (int)blockIdx.x / parts, part = blockIdx.x % parts;
  // this tile's rows: positions pos0 .. of 64 / G a tile, or (FLAT) the flat
  // (position, head) indices f0 .. f0 + nrows - 1
  const int bqp = FLAT ? 0 : ROWS / G;  // query positions per tile
  const int f0 = FLAT ? rt * ROWS : 0;
  const int nrows = FLAT ? min(ROWS, C * G - f0) : bqp * G;
  const int pos0 = FLAT ? f0 / G : rt * bqp;
  auto row_pos = [&](int r) { return FLAT ? (f0 + r) / G : pos0 + r / G; };
  auto row_head = [&](int r) { return FLAT ? (f0 + r) % G : r % G; };

  if (tid == CONSUMERS) {  // the producer's tensor maps, fetched under the count
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmv)) : "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WG);  // one warpgroup consumes a tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the Q tile's loads go out before the count: row r is chunk row
  // row_pos(r), head h * G + row_head(r)
  uint4 qv[QV];
#pragma unroll
  for (int x = 0; x < QV; ++x) {
    const int idx = tid + x * CONSUMERS, r = idx / CHP, c = idx % CHP;
    const int pos = row_pos(r);
    qv[x] = make_uint4(0, 0, 0, 0);  // columns past D stay zero
    if (tid < CONSUMERS && r < nrows && pos < C && c < CH)
      qv[x] = *reinterpret_cast<const uint4*>(q + (((size_t)b * C + pos) * N + h * G + row_head(r)) * D + c * 8);
  }
  const int base = bases ? bases[b * base_stride] : 0;
  __syncthreads();  // the barriers are initialised
  const int start = base + C - lia::block_count_true(kv_mask + (size_t)b * S_kv, S_kv);
  const int last_row = FLAT ? (f0 + nrows - 1) / G : min(pos0 + bqp, C) - 1;

  // kv tiles before start (or the window) or past this row tile's last row are
  // fully masked; this part walks its share [lo, hi) of the rest
  int j_lo = max(start, 0) / BK;
  if (window > 0) j_lo = max(j_lo, max(0, base + pos0 - window + 1) / BK);
  const int j_hi = min((base + last_row) / BK + 1, (S_kv + BK - 1) / BK);
  const int n_tiles = max(j_hi - j_lo, 0);
  const int lo = j_lo + n_tiles * part / parts, hi = j_lo + n_tiles * (part + 1) / parts;

  if (tid >= CONSUMERS) {  // the producer warp: one lane issues every copy
    if (tid == CONSUMERS) {
      const int plane = b * Nkv + h;
      for (int j = lo, i = 0; j < hi; ++j, ++i) {
        const int s = i % L::STAGES;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((i / L::STAGES) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::TILE);
#pragma unroll
        for (int x = 0; x < L::BOXES; ++x) {
          tma_load(sb + L::K_OFF + s * L::TILE + x * BOX_BYTES, &tmk, full, x * BOX_COLS, j * BK, plane);
          tma_load(sb + L::V_OFF + s * L::TILE + x * BOX_BYTES, &tmv, full, x * BOX_COLS, j * BK, plane);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  const int wg = tid / WG, wtid = tid % WG;
  const int warp = wtid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row group / column pair
  if (hi > lo) {
#pragma unroll
    for (int x = 0; x < QV; ++x) {
      const int idx = tid + x * CONSUMERS;
      *reinterpret_cast<uint4*>(smem + swz(idx / CHP, (idx % CHP) * 8)) = qv[x];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    consumers_sync<NW>();
  }

  // this thread's rows: r0 = 16 * warp + g and r0 + 8
  const int r0 = 16 * warp + g;
  int qrow[2], qpos[2];  // chunk row, and the key slot it sits at
  bool rvalid[2];
  float sl[2];  // the rows' ALiBi slopes in exp2 units (0 without)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = row_pos(r0 + 8 * i);
    qpos[i] = base + qrow[i];
    rvalid[i] = r0 + 8 * i < nrows;
    sl[i] = ALIBI ? alibi_slope(slopes, h * G + row_head(r0 + 8 * i)) : 0.f;
  }
  // keys every row of the tile may see without a mask: [start, base + pos0],
  // inside S_kv and the window of the tile's last row
  const int free_lo = max(start, window > 0 ? base + last_row - window + 1 : 0);
  const int free_hi = min(base + pos0, S_kv - 1);

  float m[2] = {LIA_NEG_INF, LIA_NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

  const uint32_t k_base = sb + L::K_OFF, v_base = sb + L::V_OFF;
  for (int it = wg, j = lo + wg; j < hi; it += NW, j += NW) {
    const int s = it % L::STAGES;
    mbar_wait(full0 + 8 * s, (it / L::STAGES) & 1);
    float sc[32];
    issue_qk<DP>(sc, sb, k_base + s * L::TILE);
    wgmma_wait();
    fence_regs(sc);
    const int k0 = j * BK;
    softmax_tile<DP, ALIBI>(sc, m, l, o, k0 >= free_lo && k0 + BK - 1 <= free_hi, k0, t, qpos, rvalid, start,
                            S_kv, window, sscale, sl);
    issue_pv<DP>(o, sc, v_base + s * L::TILE);
    wgmma_wait();
    fence_regs(o);
    mbar_arrive(empty0 + 8 * s);
  }

  if constexpr (NW == 2) {
    // the second warpgroup hands its (o, m, l) to the first, thread to thread
    // (the same fragment layout), which folds it into its own
    float* mb = reinterpret_cast<float*>(smem + L::MERGE_OFF);
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) mb[e * WG + wtid] = o[e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mb[(DP / 2 + i) * WG + wtid] = m[i];
        mb[(DP / 2 + 2 + i) * WG + wtid] = l[i];
      }
    }
    consumers_sync<NW>();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = mb[(DP / 2 + i) * WG + wtid], mx = fmaxf(m[i], m1);
      const float a0 = exp2f(m[i] - mx), a1 = exp2f(m1 - mx);
      m[i] = mx;
      l[i] = a0 * l[i] + a1 * mb[(DP / 2 + 2 + i) * WG + wtid];
#pragma unroll
      for (int e = 0; e < DP / 2; ++e)
        if (((e >> 1) & 1) == i) o[e] = a0 * o[e] + a1 * mb[e * WG + wtid];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (parts == 1) {
    // normalise into the Q tile's swizzled layout, then 16-byte stores
    wg0_sync();  // every warp's last product has read Q
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      const int r = r0 + 8 * i;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        *reinterpret_cast<uint32_t*>(smem + swz(r, 8 * n + 2 * t)) =
            pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
    wg0_sync();
    for (int idx = tid; idx < ROWS * CHP; idx += WG) {  // the tile's chunks; those past D stay unstored
      const int r = idx / CHP, c = idx % CHP;
      const int pos = row_pos(r);
      if (r < nrows && pos < C && c < CH)
        *reinterpret_cast<uint4*>(out + (((size_t)b * C + pos) * N + h * G + row_head(r)) * D + c * 8) =
            *reinterpret_cast<const uint4*>(smem + swz(r, c * 8));
    }
    return;
  }
  // partials: o unnormalised, m and l per row; a part with no tiles leaves m = -inf, l = 0
  const size_t R = (size_t)gridDim.z * C * N;
  float* ws_m = ws + (size_t)parts * R * D;
  float* ws_l = ws_m + (size_t)parts * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (!rvalid[i] || qrow[i] >= C) continue;
    const size_t row = (size_t)part * R + ((size_t)b * C + qrow[i]) * N + h * G + row_head(r);
    if (t == 0) {
      ws_m[row] = hi > lo ? m[i] : -INFINITY;
      ws_l[row] = l[i];
    }
    if (hi > lo) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        if (n < CH)
          *reinterpret_cast<float2*>(ws + row * D + 8 * n + 2 * t) = make_float2(o[4 * n + 2 * i], o[4 * n + 2 * i + 1]);
    }
  }
}

// out[row] = sum_i 2^(m_i - m) o_i / max(sum_i 2^(m_i - m) l_i, 1e-30), m the
// largest m_i; parts with m_i = -inf (no tiles) are skipped. One warp a row,
// a lane columns 2 lane + 64 i, + 1 of the row's D (DP / 64 pairs at most).
template <int DP>
__global__ void __launch_bounds__(32 * MERGE_WARPS)
merge_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int parts, int rows, int D) {
  constexpr int E = DP / 64;  // column pairs per lane
  if (DP != 128) D = DP;  // only width 128 takes several D: the others' D is known at compile time
  const int row = blockIdx.x * MERGE_WARPS + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ws_m = ws + (size_t)parts * rows * D;
  const float* ws_l = ws_m + (size_t)parts * rows;
  float mx = -INFINITY;
  for (int p = 0; p < parts; ++p) mx = fmaxf(mx, ws_m[(size_t)p * rows + row]);
  float acc[E][2] = {}, den = 0.f;
  for (int p = 0; p < parts; ++p) {
    const size_t pr = (size_t)p * rows + row;
    const float mi = ws_m[pr];
    if (mi == -INFINITY) continue;
    const float w = exp2f(mi - mx);
    den += w * ws_l[pr];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = 2 * lane + 64 * e;
      if (c < D) {
        const float2 x = *reinterpret_cast<const float2*>(ws + pr * D + c);
        acc[e][0] += w * x.x;
        acc[e][1] += w * x.y;
      }
    }
  }
  const float inv = 1.f / fmaxf(den, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = 2 * lane + 64 * e;
    if (c < D) *reinterpret_cast<uint32_t*>(out + (size_t)row * D + c) = pack_bf16(acc[e][0] * inv, acc[e][1] * inv);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// A plane [B * Nkv, S_kv, D] of bf16 as 64 x 64 boxes, 128-byte swizzled;
// rows past S_kv and columns past D read as zeros.
inline bool plane_map(CUtensorMap* map, const void* ptr, int planes, int S_kv, int D) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S_kv, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S_kv * D * 2};
  const cuuint32_t box[3] = {BOX_COLS, BK, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NW, bool FLAT, bool ALIBI>
int launch(const void* q, const void* k, const void* v, const void* kv_mask, const void* bases, int base_stride,
           void* out, void* ws, int parts, int B, int C, int S_kv, int N, int Nkv, int D, float sscale, int window,
           const float* slopes, cudaStream_t stream) {
  const int G = N / Nkv;
  CUtensorMap tmk, tmv;
  if (!plane_map(&tmk, k, B * Nkv, S_kv, D) || !plane_map(&tmv, v, B * Nkv, S_kv, D))
    return (int)cudaErrorInvalidValue;
  const int smem = Layout<DP, NW>::BYTES;
  auto kern = flash_kernel<DP, NW, FLAT, ALIBI>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = FLAT ? (C * G + ROWS - 1) / ROWS : (C + ROWS / G - 1) / (ROWS / G);
  dim3 grid(tiles * parts, Nkv, B);
  kern<<<grid, Layout<DP, NW>::THREADS, smem, stream>>>(tmk, tmv, static_cast<const __nv_bfloat16*>(q),
                                        static_cast<const uint8_t*>(kv_mask), static_cast<const int*>(bases),
                                        base_stride, static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
                                        parts, C, S_kv, N, Nkv, G, D, sscale, window, slopes);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const int rows = B * C * N;
  merge_kernel<DP><<<(rows + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(out), parts, rows, D);
  return (int)cudaGetLastError();
}


// Head-dim and warpgroup dispatch; returns a cudaError_t value, 0 on a
// successful launch. The wrapper chooses `parts` and `nw` (consumer
// warpgroups a block, 1 or 2, and 1 at D = 256) from the grid; D must be 64,
// 80, 96, 112, 128 or 256, G = N / Nkv any group (the wrapper admits 1 .. 128),
// parts > 1 needs a workspace of parts * B * C * N * (D + 2) floats, and
// slopes are ALiBi's (fp32 [N]) or null.
inline int dispatch(const void* q, const void* k, const void* v, const void* kv_mask, const void* bases,
                    int base_stride, void* out, void* ws, int parts, int nw, int B, int C, int S_kv, int N, int Nkv,
                    int D, float sscale, int window, const void* slopes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int DP = padded_dim(D);
  if (Nkv <= 0 || N % Nkv != 0 || C <= 0 || parts < 1 || (parts > 1 && !ws) || (nw != 1 && nw != 2) || DP == 0 ||
      (DP == 256 && nw != 1))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kern) {
    return kern(q, k, v, kv_mask, bases, base_stride, out, ws, parts, B, C, S_kv, N, Nkv, D, sscale, window,
                static_cast<const float*>(slopes), st);
  };
  auto by_shape = [&](auto alibi) {
    constexpr bool A = decltype(alibi)::value;
    if (N / Nkv > ROWS) {  // a group that straddles tiles
      if (DP == 256) return run(&launch<256, 1, true, A>);
      if (DP == 128) return nw == 2 ? run(&launch<128, 2, true, A>) : run(&launch<128, 1, true, A>);
      return nw == 2 ? run(&launch<64, 2, true, A>) : run(&launch<64, 1, true, A>);
    }
    if (DP == 256) return run(&launch<256, 1, false, A>);
    if (DP == 128) return nw == 2 ? run(&launch<128, 2, false, A>) : run(&launch<128, 1, false, A>);
    return nw == 2 ? run(&launch<64, 2, false, A>) : run(&launch<64, 1, false, A>);
  };
  return slopes ? by_shape(std::true_type{}) : by_shape(std::false_type{});
}

}  // namespace lia_flash

// Dynamic shared memory of one block of the kernel at head dim D with NW
// consumer warpgroups, in bytes (for the build report beside ptxas's
// registers and spills); 0 for a pair the body does not take.
extern "C" int lia_flash_smem_bytes(int D, int NW) {
  using namespace lia_flash;
  switch (padded_dim(D)) {
    case 64: return NW == 2 ? Layout<64, 2>::BYTES : Layout<64, 1>::BYTES;
    case 128: return NW == 2 ? Layout<128, 2>::BYTES : Layout<128, 1>::BYTES;
    case 256: return NW == 1 ? Layout<256, 1>::BYTES : 0;
  }
  return 0;
}
