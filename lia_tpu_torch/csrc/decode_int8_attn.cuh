// Decode attention of one layer over an INT8 KV cache with per-token f32
// scales, the fresh token merged last: the body shared by decode_fresh_int8.cu
// (a contiguous cache plane) and beam_decode_int8.cu (a group's prompt plane,
// then each beam's own generated tail), written for Hopper.
//
// Math, as the TPU kernels': q stays in its own type and the dot with the
// int8 key codes accumulates in fp32 (int8 values and their products with
// bf16 are exact there); the K scale and the softmax scale multiply the score
// after the dot, s * (ks * scale*log2(e)); the V scale multiplies the
// probability, and p * vs is rounded to q's type before it meets the value
// codes, as the TPU kernel feeds bf16 probs to its P.V dot. The fresh token
// merges in fp32 last; out = acc / max(l, 1e-30). A row with no valid key
// gives the fresh token's value. With ALiBi slopes (common.cuh: alibi_slope)
// a key scores slope * log2(e) * (its position - the query's) more: a plane
// slot s at s - length; over the beam cache a prompt slot s at s - plen -
// tlen, tail slot t at t - tlen; the fresh token at 0.
//
// How the fresh token arrives is a template flag (RAW):
// - raw (decode_fresh_int8.cu): unquantized, in q's type. The reference
//   quantizes it and dequantizes it again before the call, so attention sees
//   what later steps read back from the cache; here the kernel does the same,
//   bit for bit (fp32 amax over D, scale = max(amax/127, 1e-8), codes =
//   clip(rint(x/scale), -128, 127), value = code*scale rounded to q's type);
// - already dequantized (beam_decode_int8.cu), as the reference passes it.
//
// Where the keys live is the other template flag (BEAM):
// - a plane [B, Nkv, S, D] (+ scales [B, Nkv, S]): keys [start, length) of
//   (b, h) at row (b * Nkv + h) * S, start = length - popcount(slot_mask[b]);
// - the grouped beam cache: keys [pstart_g, plen) of the prompt plane [B0,
//   Nkv, S_p, D] of group g, read once for all of the group's beams, then
//   keys [0, tlen) of each beam's tail [B0 * nb, Nkv, T_max, D]; plen, tlen
//   and the prompt mask are read on the device.
//
// What bounds it on an H100: bytes (int8 codes plus one f32 scale a key row).
// The design:
// - One block for each (kv head, row) of a plane, or (kv head, group) of the
//   beam cache, holds all of that unit's queries (G heads, or nb beams x G
//   heads; up to NQ = 8, more go to further blocks): a group's prompt crosses
//   from memory once a launch and feeds every beam's queries.
// - Query chunks: a unit's queries, flattened (beam, head) as f = beam * G +
//   head, go to blocks in runs of qpc = min(bpc * G, NQ): bpc whole beams a
//   block where G <= NQ (bpc = 1 on a plane: one run of G), else runs of NQ
//   heads that may straddle two beams (Falcon-7B's G = 71: nine runs a row,
//   the last of 7; ChatGLM3-6B's G = 16: two). A block's tail ranges are those
//   of the beams its run reaches, each masked to that beam's columns; each
//   block takes the fresh token(s) of its own queries, and the split's merge
//   launch works a query row at a time, so neither cares where a run ends. A
//   ragged last run's missing columns hold q = 0 (finite scores) and are never
//   stored.
// - A producer warp copies each stage of UNIT keys (K and V codes, D bytes a
//   key, and their scales) into a ring of mbarrier stages, up to `stages`
//   ahead of the consumers: its 32 lanes issue 16-byte cp.async copies of the
//   codes and 4-byte ones of the scales, and each lane's completion arrives on
//   the stage's barrier (cp.async.mbarrier.arrive). Unlike a bulk copy, a
//   lane's copy places each 16-byte chunk where the consumers read it
//   without bank conflicts (code_at) and takes scales at any alignment.
// - Four consumer warps each take a 16-key tile of a stage through mma.sync
//   m16n8k16 with the keys as M and the (up to 8) queries as N: S^T = K Q^T,
//   then O^T += V^T P^T. The codes convert to bf16 exactly in registers (two
//   bit operations and one bf16x2 subtraction a pair); each lane reads 16
//   contiguous bytes of a code row at a time, so the dims and keys of the
//   mma fragments are permuted to match (a sum does not mind the order), and
//   the producer swizzles each row's 16-byte chunks (code_at) so those reads
//   meet no bank conflict. A column's running max needs 3 shuffles a 16-key
//   tile; the row sums stay per lane until the end. For fp32 q, q and the
//   probabilities are each split exactly into three bf16 pieces (three mma's
//   a product). A stage's tiles run in order over the plane's (or prompt's)
//   range, then each beam's tail range, so a short tail of every beam shares
//   one stage.
// - Nothing waits on a block barrier before the first copy: each warp reads
//   the lengths and counts the mask itself, and the consumers' q loads are in
//   flight under that count. The producer warp loads the fresh token(s) and
//   their queries at the start too, and computes their values (with RAW, the
//   round trip) and scores once every stage is issued: a plane row's one
//   token over the whole warp, a beam block's tokens in four 8-lane groups.
//   At the end the four consumer warps' partials and the fresh token merge
//   through shared memory over all consumer threads.
// - Where the blocks fill the card poorly and the walk is long, the wrapper
//   splits each unit's keys into `parts`, cut on the device from its own
//   lengths: a plane row's range
//   evenly; the beam cache's in units where a prompt key counts 1 and a tail
//   key nb (it is read once for each beam). The parts write fp32 (o, m, l)
//   partials to a workspace that merge_kernel, a second launch, combines with
//   the fresh token; every partial is written, so the workspace needs no
//   memset and the pair of launches replays in a CUDA graph.
// - Head dims: the ring's code rows are DP bytes (64, 128 or 256), a row in
//   memory D (both template parameters). The producer
//   copies each row's D bytes; the lanes' q slices past D load as zeros, so
//   the padding's codes (never copied, whatever the ring held: int8 codes are
//   finite) add nothing to a score, and the O^T dims past D are never
//   stored. D = 80, 96 and 112 so run the arithmetic of DP = 128. At DP = 256 a
//   lane's V slice is two 16-byte chunks, read one at a time, and the blocks
//   an SM drop to two (bf16) or one (fp32) so the doubled fragments fit.
#pragma once

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace lia_dec8 {

using namespace lia;  // the PTX wrappers of hopper.cuh

constexpr int NWC = 4;                   // consumer warps a block
constexpr int THREADS = 32 * (NWC + 1);  // and one producer warp
constexpr int TILE = 16;                 // keys of a consumer warp's mma tile
constexpr int UNIT = NWC * TILE;         // keys of a ring stage
constexpr int NQ = 8;                    // queries a block (the mma's n)
constexpr int MAX_STAGES = 8;
constexpr int SM_SMEM = 228 * 1024;      // shared memory of an SM
constexpr int BLOCK_SMEM = 227 * 1024;   // most a block takes
constexpr int MERGE_WARPS = 4;

// The keys of one layer: codes and scales of a plane or of the beam cache's
// group prompt plane (mask: the plane's [B, S] or the prompt mask [B0, S_p]);
// with BEAM, the tail's codes and scales [B, Nkv, T(, D)], nb beams a group
// and the tail length on the device.
struct Keys {
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const uint8_t* mask;
  int S;
  const int8_t* ktq;
  const float* kts;
  const int8_t* vtq;
  const float* vts;
  int T, nb;
  const int* tail_len;
};

// Bytes of one ring stage: K and V codes of UNIT keys (NWC tile slots of TILE
// keys, rows DP bytes), then their K and V scales (f32).
__host__ __device__ constexpr int stage_bytes(int DP) { return 2 * UNIT * DP + 2 * UNIT * 4; }
// The fresh token's scores [NQ] and values [NQ][DP] (fp32), after the ring.
__host__ __device__ constexpr int fresh_bytes(int DP) { return (NQ + NQ * DP) * 4; }
__host__ __device__ constexpr int smem_bytes(int DP, int stages) {
  return stages * stage_bytes(DP) + fresh_bytes(DP) + 16 * stages;
}

// Stages of the ring for a launch of `blocks` blocks on `sms` SMs: as many as
// fit when the blocks an SM (at most four: the registers' limit at a plane;
// three at the beam route; two at DP = 256) share its shared memory.
inline int ring_stages(int DP, int blocks, int sms) {
  const int per_sm = std::min(4, std::max(1, (blocks + sms - 1) / std::max(sms, 1)));
  const int room = std::min(SM_SMEM / per_sm - 1024, BLOCK_SMEM) - fresh_bytes(DP) - 16 * MAX_STAGES;
  return std::max(2, std::min(MAX_STAGES, room / stage_bytes(DP)));
}


// One contiguous chunk of global memory into shared memory, completing on `bar`
// (bytes a multiple of 16, both addresses 16-byte aligned).
// Loads of read-only inputs that stay where they are written: the block's
// start issues them ahead of the mask's count, and the compiler would
// otherwise sink them to their first use after it (a second round trip).
__device__ __forceinline__ uint4 ldg16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t ldg4(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Byte offset of 16-byte chunk `chunk` of code row `row` in a stage: from DP
// = 128 the chunks of a row are XOR-swizzled by its low 3 bits (inside
// aligned runs of 8 chunks), so at DP = 128 a phase of the consumers'
// fragment loads (8 lanes: two rows x four 32-byte K slices, or four rows x
// two 16-byte V slices) reads 8 distinct bank groups.
template <int DP>
__device__ __forceinline__ int code_at(int row, int chunk) {
  return row * DP + 16 * (DP >= 128 ? chunk ^ (row & 7) : chunk);
}

// 4 bytes from global to shared memory, asynchronously (cp.async).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// An arrival on `bar` once every cp.async this thread issued so far has
// landed (counted among the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// One range of keys [lo, hi) of a plane row; beam >= 0: a tail, whose keys
// only that beam's queries (columns beam * G ..) see.
struct Seg {
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  int lo, hi, beam;
};

// D (16 x 8, fp32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The transpose of an 8 x 8 matrix of 16-bit values held one row pair a lane.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// (a & mask) | c in one LOP3: with both constants as immediates the compiler
// spends two (an instruction holds one immediate), so c comes in a register.
template <uint32_t MASK>
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "n"(MASK), "r"(c));
  return d;
}

// The int8 codes in bytes 0 and 2 of x (bytes 1 and 3 ignored) as an exact
// bf16 pair: 0x4300 | (c & 0x7f) is 128 + (c & 0x7f), and subtracting 128
// (c >= 0) or 256 (c < 0, sign bit set) leaves c. hi43 holds 0x43004300.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t x, uint32_t hi43) {
  const uint32_t v = and_or<0x007f007fu>(x, hi43), s = and_or<0x00800080u>(x, hi43);
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

// x as the sum of PIECES bf16 values: itself rounded (PIECES 1), or exactly
// (3: the top 8 significant bits, the next 8, the rest).
template <int PIECES>
__device__ __forceinline__ void split_bf16(float x, float (&p)[PIECES]) {
  if constexpr (PIECES == 1) {
    p[0] = x;
  } else {
    p[0] = __uint_as_float(__float_as_uint(x) & 0xffff0000u);
    const float r = x - p[0];
    p[1] = __uint_as_float(__float_as_uint(r) & 0xffff0000u);
    p[2] = r - p[1];
  }
}

// One token row of D values spread over a warp (DL per lane; the lanes past D
// hold zeros, which leave the amax as it is), replaced by its int8 round
// trip: per-token symmetric scale, as ops/quant.py:quantize_kv then
// dequantize_kv(x, T) compute it on the card, bit for bit. Torch divides a
// CUDA tensor by a Python scalar as a product with the scalar's fp32
// reciprocal, so the scale is amax * fl(1/127), not fl(amax / 127): the two
// differ in the last bit for some amax, and bf16 rows often hold a value at
// exactly half the amax (x / scale = 63.5 +- an ulp), where that bit picks
// the code.
template <typename T, int DL>
__device__ __forceinline__ void quant_dequant(float* x) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < DL; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-8f);
#pragma unroll
  for (int e = 0; e < DL; ++e) {
    const float code = fminf(fmaxf(rintf(__fdiv_rn(x[e], scale)), -128.f), 127.f);
    x[e] = lia::round_to<T>(code * scale);
  }
}

// Number of nonzero bytes in mask[0, n), on every lane of the calling warp
// (no block barrier: each warp counts for itself). A lane counts 16 bytes a
// round with one 16-byte load where the bytes are aligned.
__device__ __forceinline__ int warp_count_true(const uint8_t* mask, int n, int lane) {
  int count = 0;
#pragma unroll 4
  for (int i = 16 * lane; i < n; i += 16 * 32) {
    if (i + 16 <= n && (reinterpret_cast<uintptr_t>(mask + i) & 15) == 0) {
      const uint4 w = *reinterpret_cast<const uint4*>(mask + i);
      count += (__popc(__vcmpne4(w.x, 0)) + __popc(__vcmpne4(w.y, 0)) + __popc(__vcmpne4(w.z, 0)) +
                __popc(__vcmpne4(w.w, 0))) >> 3;
    } else {
      for (int e = 0; e < 16 && i + e < n; ++e) count += mask[i + e] != 0;
    }
  }
  return __reduce_add_sync(0xffffffffu, count);
}

// The fresh key and value of one (row, kv head) over a warp, DL values a
// lane (zeros past D), in q's type (with RAW, after their int8 round trip).
template <typename T, int DL, bool RAW>
__device__ __forceinline__ void fresh_kv(const T* kf, const T* vf, float (&kx)[DL], float (&vx)[DL], int lane,
                                         int D) {
#pragma unroll
  for (int e = 0; e < DL; ++e) kx[e] = vx[e] = 0.f;
  if (lane * DL < D) {
    lia::load_vec<DL>(kf + lane * DL, kx);
    lia::load_vec<DL>(vf + lane * DL, vx);
  }
  if constexpr (RAW) {
    quant_dequant<T, DL>(kx);
    quant_dequant<T, DL>(vx);
  }
}

// The fresh key's score for the query row qr (q's values, the softmax scale
// applied to q as the plain version does), on every lane.
template <typename T, int DL>
__device__ __forceinline__ float fresh_score(const T* qr, const float (&kx)[DL], float sscale, int lane, int D) {
  float qx[DL] = {};
  if (lane * DL < D) lia::load_vec<DL>(qr + lane * DL, qx);
  float part = 0.f;
#pragma unroll
  for (int e = 0; e < DL; ++e) part = fmaf(qx[e] * sscale, kx[e], part);
  return lia::warp_sum(part);
}

// The q slice one consumer lane loads (row r, dims c * DP / 4 ..), as 16-byte
// words, and the B operand it becomes (see int8_kernel).
template <typename T, int DP>
struct QSlice {
  static constexpr int WORDS = (DP / 4) * (int)sizeof(T) / 16;
  static constexpr int PER_WORD = 16 / (int)sizeof(T);  // dims a word
};

// Q^T as the B operand, k16 chunk kk: column r (query r), k rows 2c, 2c + 1
// (and + 8, + 9) at dims c * DP / 4 + 4 kk + {0, 2} (and {1, 3}) of the
// lane's slice raw; zero where !valid. PIECES pieces for fp32.
template <typename T, int DP, int PIECES>
__device__ __forceinline__ void q_frags(const uint4 (&raw)[QSlice<T, DP>::WORDS], bool valid,
                                        uint32_t (&qf)[PIECES][DP / 16][2]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const float x[4] = {__uint_as_float(raw[kk].x), __uint_as_float(raw[kk].y), __uint_as_float(raw[kk].z),
                          __uint_as_float(raw[kk].w)};
      float p[4][PIECES];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_bf16<PIECES>(valid ? x[e] : 0.f, p[e]);
#pragma unroll
      for (int pc = 0; pc < PIECES; ++pc) {
        qf[pc][kk][0] = pack_bf16x2(p[0][pc], p[2][pc]);
        qf[pc][kk][1] = pack_bf16x2(p[1][pc], p[3][pc]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < QSlice<T, DP>::WORDS; ++i) {
      const uint4 x = valid ? raw[i] : make_uint4(0, 0, 0, 0);
      qf[0][2 * i][0] = __byte_perm(x.x, x.y, 0x5410);
      qf[0][2 * i][1] = __byte_perm(x.x, x.y, 0x7632);
      qf[0][2 * i + 1][0] = __byte_perm(x.z, x.w, 0x5410);
      qf[0][2 * i + 1][1] = __byte_perm(x.z, x.w, 0x7632);
    }
  }
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The fresh row group `grp` of the producer warp takes first, in flight from
// the block's start: token t0 = grp, its key, value and its first query's
// row in the block, DP / 8 dims a lane (zeros where the lane's dims lie past
// D: !valid).
// Held as the raw 16-byte words (the registers of the producer's other work
// stay free); unpack turns one array into the lane's DP / 8 values.
template <typename T, int DP>
struct FreshFirst {
  static constexpr int WORDS = (DP / 8) * (int)sizeof(T) / 16;
  uint4 k[WORDS], v[WORDS], q[WORDS];
  __device__ __forceinline__ void load(const T* kr, const T* vr, const T* qr, bool valid) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      k[i] = v[i] = q[i] = make_uint4(0, 0, 0, 0);
      if (valid) {
        k[i] = ldg16(reinterpret_cast<const uint4*>(kr) + i);
        v[i] = ldg16(reinterpret_cast<const uint4*>(vr) + i);
        q[i] = ldg16(reinterpret_cast<const uint4*>(qr) + i);
      }
    }
  }
  __device__ __forceinline__ static void unpack(const uint4 (&w)[WORDS], float (&x)[DP / 8]) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      const uint32_t u[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (std::is_same<T, float>::value) {
          x[4 * i + e] = __uint_as_float(u[e]);
        } else {
          x[8 * i + 2 * e] = __uint_as_float(u[e] << 16);
          x[8 * i + 2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
        }
      }
    }
  }
};

// A plane row's one fresh token and the block's nq queries' rows over the whole
// producer warp (DP / 32 dims a lane, zeros past D), held as raw 32-bit words
// from the block's start; compute() takes the token through its int8 round
// trip (RAW: a division a value, as quantize_kv) and writes its value and the
// queries' scores.
template <typename T, int DP>
struct FreshPlane {
  static constexpr int DL = DP / 32, WORDS = DL * (int)sizeof(T) / 4;
  uint32_t k[WORDS], v[WORDS], q[NQ][WORDS];
  __device__ __forceinline__ static void load_words(const T* p, uint32_t (&w)[WORDS], bool valid) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = valid ? ldg4(reinterpret_cast<const uint32_t*>(p) + i) : 0u;
  }
  __device__ __forceinline__ static void unpack(const uint32_t (&w)[WORDS], float (&x)[DL]) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      if constexpr (std::is_same<T, float>::value) {
        x[i] = __uint_as_float(w[i]);
      } else {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
  template <typename QRow>
  __device__ __forceinline__ void load(const T* kr, const T* vr, const T* qp, QRow qrow, int nq, int lane, int D) {
    const bool valid = lane * DL < D;
    load_words(kr + lane * DL, k, valid);
    load_words(vr + lane * DL, v, valid);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      if (j < nq) load_words(qp + qrow(j) * D + lane * DL, q[j], valid);
  }
  template <bool RAW>
  __device__ __forceinline__ void compute(int nq, float sscale, float* fresh_s, float* fresh_v, int lane) const {
    float kx[DL], vx[DL];
    unpack(k, kx);
    unpack(v, vx);
    if constexpr (RAW) {
      quant_dequant<T, DL>(kx);
      quant_dequant<T, DL>(vx);
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) fresh_v[lane * DL + e] = vx[e];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (j < nq) {
        float qx[DL];
        unpack(q[j], qx);
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) part = fmaf(qx[e] * sscale, kx[e], part);
        const float sf = lia::warp_sum(part);
        if (lane == 0) fresh_s[j] = sf;
      }
    }
  }
};

// The block's queries [first_query(t), first_query(t + 1)) of token t (beam
// j0 + t of a run of nq flat queries from q0, G a beam).
__device__ __forceinline__ int first_query(int t, int q0, int j0, int nq, int G) {
  return min(max((j0 + t) * G - q0, 0), nq);
}

// A beam block's fresh tokens (already dequantized) over one warp, in four
// groups of 8 lanes (each lane DP / 8 dims, zeros past D): a group takes a
// token, its value into fresh_v[token] (rows DP apart) and its queries'
// scores q * scale . k into fresh_s[query] (the block's queries of that beam:
// first_query). `first` holds each group's first token and query, loaded at
// the block's start.
template <typename T, int DP, typename FreshRow, typename QRow>
__device__ __forceinline__ void fresh_tokens(const T* kf, const T* vf, const T* q, FreshRow fresh_row, QRow qrow,
                                             int tokens, int q0, int j0, int nq, int G, int D, float sscale,
                                             float* fresh_s, float* fresh_v, int lane,
                                             const FreshFirst<T, DP>& first) {
  constexpr int DG = DP / 8;  // dims a lane
  const int grp = lane >> 3, gl = lane & 7;
  const bool on = gl * DG < D;
  const unsigned gmask = 0xffu << (8 * grp);  // the group's lanes: groups run apart
  for (int t = grp; t < tokens; t += 4) {
    float kx[DG] = {}, vx[DG] = {};
    if (t < 4) {
      FreshFirst<T, DP>::unpack(first.k, kx);
      FreshFirst<T, DP>::unpack(first.v, vx);
    } else if (on) {
      lia::load_vec<DG>(kf + fresh_row(t) + gl * DG, kx);
      lia::load_vec<DG>(vf + fresh_row(t) + gl * DG, vx);
    }
#pragma unroll
    for (int e = 0; e < DG; ++e) fresh_v[t * DP + gl * DG + e] = vx[e];
    const int jl = first_query(t, q0, j0, nq, G), jh = first_query(t + 1, q0, j0, nq, G);
    for (int j = jl; j < jh; ++j) {
      float qx[DG] = {};
      if (t < 4 && j == jl) {
        FreshFirst<T, DP>::unpack(first.q, qx);
      } else if (on) {
        lia::load_vec<DG>(q + qrow(j) * D + gl * DG, qx);
      }
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DG; ++e) part = fmaf(qx[e] * sscale, kx[e], part);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) part += __shfl_xor_sync(gmask, part, off);
      if (gl == 0) fresh_s[j] = part;
    }
  }
}

// One block: kv head blockIdx.x of plane row (or beam group) blockIdx.y, part
// blockIdx.z % parts of its keys, query chunk blockIdx.z / parts: the unit's
// flat queries [chunk * qpc, + qpc), qpc = min(bpc * G, NQ) (BEAM: bpc whole
// beams of the group where G <= NQ; a plane row's G heads in runs of NQ).
// The walk is a list of 16-key tiles: the plane's (or prompt's) range, then
// each beam's tail range; stage s holds tiles 4s .. 4s + 3, tile slot w for
// consumer warp w, and tiles of one range in a stage come in one copy.
// Registers: four blocks an SM for a plane (96 a thread), three for the beam
// route, whose tail ranges and fresh tokens would spill at 96; at DP = 256,
// two for a plane and one for the beam route (fp32: one). Rows lie D bytes
// apart in memory, DP in the ring.
template <typename T, int DP, int D, bool RAW, bool BEAM>
__global__ void __launch_bounds__(THREADS, std::is_same<T, float>::value ? (DP > 128 ? 1 : 2)
                                                                         : DP > 128 ? (BEAM ? 1 : 2) : (BEAM ? 3 : 4))
int8_kernel(const T* __restrict__ q,   // [B, N, D]
            const T* __restrict__ kf,  // [B, Nkv, D] fresh key (raw or dequantized)
            const T* __restrict__ vf,
            Keys keys,
            const int* __restrict__ lengths, int length_stride,  // plane: [B] or scalar; beam: plen
            T* __restrict__ out,        // [B, N, D] (parts == 1)
            float* __restrict__ ws,     // parts > 1: o [parts, B*N, D], m, l [parts, B*N]
            int parts, int Nkv, int G, int bpc, float sscale, int stages,
            const float* __restrict__ slopes) {  // ALiBi [N], or null
  constexpr int KW = DP / 16;  // k16 chunks of a lane's K slice (DP / 4 bytes of a key row)
  constexpr int VW = DP / 32;  // words of a lane's V slice (DP / 8 bytes of a key row)
  constexpr int VCH = VW >= 4 ? VW / 4 : 1;  // its 16-byte chunks (half of one at DP = 64)
  constexpr int VWC = VW >= 4 ? 4 : VW;      // words a chunk
  constexpr int MT = DP / 16;  // 16-dim tiles of O^T
  constexpr int PIECES = std::is_same<T, float>::value ? 3 : 1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int part = blockIdx.z % parts, chunk = blockIdx.z / parts;
  const int N = Nkv * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c = lane & 3;

  extern __shared__ __align__(128) unsigned char smem[];
  const int sbytes = stage_bytes(DP);
  float* fresh_s = reinterpret_cast<float*>(smem + stages * sbytes);  // [NQ]
  float* fresh_v = fresh_s + NQ;                                      // [NQ][DP]
  const uint32_t full0 = smem_addr(fresh_v + NQ * DP), empty0 = full0 + 8 * stages;
  float* pm = reinterpret_cast<float*>(smem);  // after the walk: m [NWC][NQ], l, o [NWC][NQ][DP]
  float* pl = pm + NWC * NQ;
  float* po = pl + NWC * NQ;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 32);    // every producer lane's copies land
      mbar_init(empty0 + 8 * s, NWC);  // every consumer warp releases every stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the block's only barrier before the walk: each warp reads the lengths itself
  // the chunk's flat queries [q0, q0 + nq) of the unit's G (or nb * G); the
  // beams j0 .. j0 + nbc - 1 they reach
  const int qpc = min(bpc * G, NQ), q0 = chunk * qpc;
  const int nq = min(qpc, (BEAM ? keys.nb : 1) * G - q0);
  const int j0 = BEAM ? q0 / G : 0, nbc = BEAM ? (q0 + nq - 1) / G - j0 + 1 : 1;
  const int tokens = nbc;
  // query j of the block: head h * G + q0 + j of row b, or flat query f = q0 + j
  // of group b, head h * G + f % G of beam f / G
  auto qrow = [&](int j) -> size_t {
    return BEAM ? ((size_t)(b * keys.nb + (q0 + j) / G) * N + h * G + (q0 + j) % G)
                : ((size_t)b * N + h * G + q0 + j);
  };
  auto fresh_row = [&](int t) -> size_t {  // the fresh k/v row of token t (beam j0 + t, or row b)
    return ((size_t)(BEAM ? b * keys.nb + j0 + t : b) * Nkv + h) * D;
  };

  // the consumers' q slices and the producer's first fresh rows, in flight
  // under the mask's count
  using QS = QSlice<T, DP>;
  uint4 qraw[QS::WORDS];
  // the producer's fresh rows: a plane row's token over the warp, or each
  // 8-lane group's first beam token and query
  typename std::conditional<BEAM, FreshFirst<T, DP>, FreshPlane<T, DP>>::type first;
  if (warp < NWC) {
    const int d0 = c * (DP / 4);  // the slice's first dim; its words past D load as zeros
    const uint4* qp = reinterpret_cast<const uint4*>(q + qrow(r < nq ? r : 0) * D + d0);
#pragma unroll
    for (int i = 0; i < QS::WORDS; ++i) qraw[i] = d0 + QS::PER_WORD * i < D ? ldg16(qp + i) : make_uint4(0, 0, 0, 0);
  } else if (parts == 1) {
    if constexpr (BEAM) {
      const int grp = lane >> 3, gl = lane & 7;
      const int t = min(grp, tokens - 1);
      first.load(kf + fresh_row(t) + gl * (DP / 8), vf + fresh_row(t) + gl * (DP / 8),
                 q + qrow(first_query(t, q0, j0, nq, G)) * D + gl * (DP / 8), gl * (DP / 8) < D);
    } else {
      first.load(kf + fresh_row(0), vf + fresh_row(0), q, qrow, nq, lane, D);
    }
  }

  // this block's keys, cut on the device by each warp from the lengths and the
  // mask; the query's ALiBi position against the prompt's (plane's) slots and
  // against the tail's
  int lo, hi, t_lo = 0, t_hi = 0, qpos_p, qpos_t = 0;
  if constexpr (BEAM) {
    const int plen = min(max(lengths[0], 0), keys.S);
    const int tl = min(max(*keys.tail_len, 0), keys.T);
    qpos_p = plen + tl;
    qpos_t = tl;
    const int pstart = max(plen - warp_count_true(keys.mask + (size_t)b * keys.S, keys.S, lane), 0);
    // units: a prompt key counts 1, a tail key nbc (one row for each beam)
    const long long pn = plen - pstart, units = pn + (long long)nbc * tl;
    const long long u0 = units * part / parts, u1 = units * (part + 1) / parts;
    lo = pstart + (int)min(u0, pn);
    hi = pstart + (int)min(u1, pn);
    t_lo = u0 <= pn ? 0 : (int)min((u0 - pn + nbc - 1) / nbc, (long long)tl);
    t_hi = u1 <= pn ? 0 : (int)min((u1 - pn + nbc - 1) / nbc, (long long)tl);
  } else {
    const int length = min(max(lengths[b * length_stride], 0), keys.S);
    const int start = max(length - warp_count_true(keys.mask + (size_t)b * keys.S, keys.S, lane), 0);
    qpos_p = length;
    const long long n = length - start;
    lo = start + (int)(n * part / parts);
    hi = start + (int)(n * (part + 1) / parts);
  }
  auto seg = [&](int sg) -> Seg {
    if (sg == 0) {
      const size_t row = ((size_t)b * Nkv + h) * keys.S;  // the plane row, or the group's prompt row
      return Seg{keys.kq + row * D, keys.ks + row, keys.vq + row * D, keys.vs + row, lo, hi, -1};
    }
    const size_t row = (((size_t)b * keys.nb + j0 + sg - 1) * Nkv + h) * keys.T;  // beam j0 + sg - 1's tail
    return Seg{keys.ktq + row * D, keys.kts + row, keys.vtq + row * D, keys.vts + row, t_lo, t_hi, sg - 1};
  };
  const int tiles0 = (hi - lo + TILE - 1) / TILE, tiles_t = BEAM ? (t_hi - t_lo + TILE - 1) / TILE : 0;
  const int tiles = tiles0 + (BEAM ? nbc * tiles_t : 0), nstages = (tiles + NWC - 1) / NWC;
  auto seg_tiles = [&](int sg) { return sg == 0 ? tiles0 : tiles_t; };
  // (range, tile in it) of a walk position, moved forward by k tiles (no division)
  auto advance = [&](int& sg, int& ti, int k) {
    for (ti += k; sg < (BEAM ? nbc : 0) && ti >= seg_tiles(sg); ++sg) ti -= seg_tiles(sg);
  };
  if (warp == NWC) {  // the producer warp: its 32 lanes issue every copy
    int sg = 0, ti = 0;
    advance(sg, ti, 0);
    Seg sgm = seg(sg);
    for (int s = 0; s < nstages; ++s) {
      const int st = s % stages;
      unsigned char* base = smem + (size_t)st * sbytes;
      mbar_wait(empty0 + 8 * st, ((s / stages) & 1) ^ 1);
      // the stage's runs: consecutive slots of one range
      for (int w = 0; w < NWC && NWC * s + w < tiles;) {
        const int k = min(NWC - w, seg_tiles(sg) - ti);
        const int k0 = sgm.lo + TILE * ti, n = min(sgm.hi, k0 + TILE * k) - k0;
        const unsigned char* kq = reinterpret_cast<const unsigned char*>(sgm.kq + (size_t)k0 * D);
        const unsigned char* vq = reinterpret_cast<const unsigned char*>(sgm.vq + (size_t)k0 * D);
        for (int i = 16 * lane; i < n * D; i += 16 * 32) {
          const int at = code_at<DP>(w * TILE + i / D, (i % D) / 16);
          lia::cp_async16(base + at, kq + i, true);
          lia::cp_async16(base + UNIT * DP + at, vq + i, true);
        }
        float* ksc = reinterpret_cast<float*>(base + 2 * UNIT * DP) + w * TILE;
        for (int e = lane; e < n; e += 32) {
          cp_async4(ksc + e, sgm.ks + k0 + e);
          cp_async4(ksc + UNIT + e, sgm.vs + k0 + e);
        }
        w += k;
        const int sg0 = sg;
        advance(sg, ti, k);
        if (sg != sg0) sgm = seg(sg);
      }
      cp_async_arrive(full0 + 8 * st);
    }
    // every stage is issued: the fresh token (the merge launch's where the
    // keys split), under the consumers' last stages; computed any earlier, it
    // holds back the issue of a short walk's remaining stages
    if (parts == 1) {
      if constexpr (BEAM) {
        static_assert(!RAW, "a beam block's fresh tokens come dequantized");
        fresh_tokens<T, DP>(kf, vf, q, fresh_row, qrow, tokens, q0, j0, nq, G, D, sscale, fresh_s, fresh_v, lane,
                            first);
      } else {
        first.template compute<RAW>(nq, sscale, fresh_s, fresh_v, lane);
      }
    }
    named_arrive(2, THREADS);
    return;
  }

  // ---- the consumer warps ----
  uint32_t qf[PIECES][KW][2];
  q_frags<T, DP, PIECES>(qraw, r < nq, qf);
  // the beams (0 .. nbc - 1 from j0) of this lane's columns 2c and 2c + 1
  const int cb0 = BEAM ? (q0 + 2 * c) / G - j0 : 0, cb1 = BEAM ? (q0 + 2 * c + 1) / G - j0 : 0;
  float csl[2];  // their ALiBi slopes in exp2 units
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int f = q0 + 2 * c + e;
    csl[e] = 2 * c + e < nq ? alibi_slope(slopes, h * G + (BEAM ? f % G : f)) : 0.f;
  }

  // per lane: O^T tile m at dims r * DP / 8 + 2 m (+ 1) of queries 2c, 2c + 1;
  // each column's running max and this lane's part of its sum
  float o[MT][4], mcol[2] = {LIA_NEG_INF, LIA_NEG_INF}, lpart[2] = {0.f, 0.f};
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[m][e] = 0.f;

  // the lane's fragment offsets in a stage (the swizzle fixed by the lane):
  // K rows r and r + 8 at its DP / 64 16-byte chunks, V rows 2c, 2c + 1, 2c +
  // 8, 2c + 9 at its DP / 8 bytes (VCH chunks, or half of one at DP = 64)
  int koff[2][KW / 4], voff[4][VCH];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
    for (int w4 = 0; w4 < KW / 4; ++w4)
      koff[h2][w4] = code_at<DP>(warp * TILE + r + 8 * h2, (c * (DP / 4) + 16 * w4) / 16);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int vc = 0; vc < VCH; ++vc)
      voff[kk][vc] = UNIT * DP + code_at<DP>(warp * TILE + 2 * c + (kk & 1) + 8 * (kk >> 1),
                                             (r * (DP / 8) + 16 * vc) / 16) + (r * (DP / 8)) % 16;
  uint32_t hi43;  // 0x43004300 in a register (see and_or)
  asm volatile("mov.b32 %0, 0x43004300;\n" : "=r"(hi43));

  int sg = 0, ti = 0;  // this warp's tile of the stage: NWC * s + warp
  advance(sg, ti, warp);
  for (int s = 0; s < nstages; ++s, advance(sg, ti, NWC)) {
    const int st = s % stages, i = NWC * s + warp;
    mbar_wait(full0 + 8 * st, (s / stages) & 1);
    if (i < tiles) {
      const Seg sgm = seg(sg);
      const int k0 = sgm.lo + TILE * ti, nv = min(TILE, sgm.hi - k0);
      const unsigned char* base = smem + (size_t)st * sbytes;

      const float* kscl = reinterpret_cast<const float*>(base + 2 * UNIT * DP) + warp * TILE;
      const float* vscl = kscl + UNIT;
      // columns this range's keys reach: all, or one beam's
      const bool ok0 = sgm.beam < 0 || cb0 == sgm.beam, ok1 = sgm.beam < 0 || cb1 == sgm.beam;
      // S^T = K Q^T: A rows r, r + 8 are keys r, r + 8 of the tile, each lane
      // its D / 4 contiguous bytes of them (two accumulators: shorter chains)
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int w4 = 0; w4 < KW; w4 += 4) {  // 16 bytes of each row: four k16 chunks
        const uint4 x0 = *reinterpret_cast<const uint4*>(base + koff[0][w4 / 4]);
        const uint4 x1 = *reinterpret_cast<const uint4*>(base + koff[1][w4 / 4]);
        const uint32_t k0w[4] = {x0.x, x0.y, x0.z, x0.w}, k1w[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a0 = codes_bf16x2(k0w[kk], hi43), a1 = codes_bf16x2(k1w[kk], hi43);
          const uint32_t a2 = codes_bf16x2(k0w[kk] >> 8, hi43), a3 = codes_bf16x2(k1w[kk] >> 8, hi43);
#pragma unroll
          for (int pc = 0; pc < PIECES; ++pc) {
            if (kk & 1)
              mma_bf16(s1, a0, a1, a2, a3, qf[pc][w4 + kk][0], qf[pc][w4 + kk][1]);
            else
              mma_bf16(s0, a0, a1, a2, a3, qf[pc][w4 + kk][0], qf[pc][w4 + kk][1]);
          }
        }
      }
      // scores of keys r (sc[0], sc[1]) and r + 8 (sc[2], sc[3]) for columns 2c, 2c + 1
      const bool v0 = r < nv, v1 = r + 8 < nv;
      const float ks0 = v0 ? kscl[r] * sscale : 0.f, ks1 = v1 ? kscl[r + 8] * sscale : 0.f;
      const float vs0 = v0 ? vscl[r] : 0.f, vs1 = v1 ? vscl[r + 8] : 0.f;
      const bool in[4] = {v0 && ok0, v0 && ok1, v1 && ok0, v1 && ok1};
      float sc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = in[e] ? (s0[e] + s1[e]) * (e < 2 ? ks0 : ks1) : LIA_NEG_INF;
      if (slopes) {  // ALiBi: keys r and r + 8 of the tile
        const int kb = k0 + r - (sgm.beam < 0 ? qpos_p : qpos_t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (in[e]) sc[e] = fmaf(csl[e & 1], (float)(kb + 8 * (e >> 1)), sc[e]);
      }
      float pw[4], alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mt = fmaxf(sc[e], sc[e + 2]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
        const float m_new = fmaxf(mcol[e], mt);
        alpha[e] = exp2f(mcol[e] - m_new);
        const float p0 = in[e] ? exp2f(sc[e] - m_new) : 0.f, p1 = in[e + 2] ? exp2f(sc[e + 2] - m_new) : 0.f;
        lpart[e] = lpart[e] * alpha[e] + p0 + p1;
        mcol[e] = m_new;
        pw[e] = p0 * vs0;
        pw[e + 2] = p1 * vs1;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a column's max moved
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          o[m][0] *= alpha[0];
          o[m][1] *= alpha[1];
          o[m][2] *= alpha[0];
          o[m][3] *= alpha[1];
        }
      }
      // P^T (keys x queries) in q's type as the B operand: the C layout of
      // each 8-key half, transposed
      uint32_t pb[PIECES][2];
      {
        float x0[PIECES], x1[PIECES], x2[PIECES], x3[PIECES];
        split_bf16<PIECES>(pw[0], x0);
        split_bf16<PIECES>(pw[1], x1);
        split_bf16<PIECES>(pw[2], x2);
        split_bf16<PIECES>(pw[3], x3);
#pragma unroll
        for (int pc = 0; pc < PIECES; ++pc) {
          pb[pc][0] = movmatrix_trans(pack_bf16x2(x0[pc], x1[pc]));
          pb[pc][1] = movmatrix_trans(pack_bf16x2(x2[pc], x3[pc]));
        }
      }
      // O^T += V^T P^T: A rows are dims, k columns the tile's keys 2c, 2c + 1
      // (and + 8, + 9), each lane DP / 8 contiguous bytes of those four keys,
      // read a 16-byte chunk (VWC words: tiles 2 VWC) at a time
#pragma unroll
      for (int vc = 0; vc < VCH; ++vc) {
        uint32_t vw[4][VWC];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const unsigned char* row = base + voff[kk][vc];
          if constexpr (VWC == 4) {
            const uint4 x = *reinterpret_cast<const uint4*>(row);
            vw[kk][0] = x.x; vw[kk][1] = x.y; vw[kk][2] = x.z; vw[kk][3] = x.w;
          } else {
            const uint2 x = *reinterpret_cast<const uint2*>(row);
            vw[kk][0] = x.x; vw[kk][1] = x.y;
          }
        }
#pragma unroll
        for (int mm = 0; mm < 2 * VWC; ++mm) {
          const int m = 2 * VWC * vc + mm;
          const uint32_t sel = (mm & 1) ? 0x7632u : 0x5410u;
          const uint32_t xa = __byte_perm(vw[0][mm >> 1], vw[1][mm >> 1], sel);
          const uint32_t xb = __byte_perm(vw[2][mm >> 1], vw[3][mm >> 1], sel);
          const uint32_t a0 = codes_bf16x2(xa, hi43), a1 = codes_bf16x2(xa >> 8, hi43);
          const uint32_t a2 = codes_bf16x2(xb, hi43), a3 = codes_bf16x2(xb >> 8, hi43);
#pragma unroll
          for (int pc = 0; pc < PIECES; ++pc) mma_bf16(o[m], a0, a1, a2, a3, pb[pc][0], pb[pc][1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // the warps' partials, through the (now idle) ring
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lpart[e] += __shfl_xor_sync(0xffffffffu, lpart[e], 4);
    lpart[e] += __shfl_xor_sync(0xffffffffu, lpart[e], 8);
    lpart[e] += __shfl_xor_sync(0xffffffffu, lpart[e], 16);
  }
  named_sync(1, NWC * 32);
  if (r == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pm[warp * NQ + 2 * c + e] = mcol[e];
      pl[warp * NQ + 2 * c + e] = lpart[e];
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(po + (warp * NQ + 2 * c + e) * DP + r * (DP / 8) + 2 * m) =
          make_float2(o[m][e], o[m][e + 2]);
  named_sync(1, NWC * 32);

  named_sync(2, THREADS);  // the producer's fresh token is in shared memory
  // merged over the warps (and, with one part, the fresh token last), a pair of
  // dims a thread
  const size_t rows_all = (size_t)gridDim.y * (BEAM ? keys.nb : 1) * N;
  for (int idx = tid; idx < nq * (D / 2); idx += NWC * 32) {
    const int j = idx / (D / 2), d = 2 * (idx % (D / 2));
    float M = parts == 1 ? fresh_s[j] : LIA_NEG_INF;
#pragma unroll
    for (int w = 0; w < NWC; ++w) M = fmaxf(M, pm[w * NQ + j]);
    float L = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < NWC; ++w) {
      const float a = exp2f(pm[w * NQ + j] - M);
      L += pl[w * NQ + j] * a;
      const float2 x = *reinterpret_cast<const float2*>(po + (w * NQ + j) * DP + d);
      o0 = fmaf(x.x, a, o0);
      o1 = fmaf(x.y, a, o1);
    }
    const size_t row = qrow(j);
    if (parts == 1) {
      const float pf = exp2f(fresh_s[j] - M);
      const float* v = fresh_v + (BEAM ? (q0 + j) / G - j0 : 0) * DP + d;
      L = fmaxf(L + pf, 1e-30f);
      out[row * D + d] = lia::from_f32<T>(fmaf(pf, v[0], o0) / L);
      out[row * D + d + 1] = lia::from_f32<T>(fmaf(pf, v[1], o1) / L);
    } else {
      *reinterpret_cast<float2*>(ws + ((size_t)part * rows_all + row) * D + d) = make_float2(o0, o1);
      if (d == 0) {
        ws[(size_t)parts * rows_all * D + part * rows_all + row] = M;
        ws[(size_t)parts * rows_all * (D + 1) + part * rows_all + row] = L;
      }
    }
  }
}

// The parts' partials of each query row merged (one warp a row, DP / 32 dims
// a lane, the lanes past D idle), then the fresh token (with RAW, after its
// round trip; none where kf is null: the bf16 plane route of beam_attn.cuh for
// B7/B8), normalised and written out.
template <typename T, int DP, bool RAW>
__global__ void __launch_bounds__(32 * MERGE_WARPS)
merge_kernel(const float* __restrict__ ws, const T* __restrict__ q, const T* __restrict__ kf,
             const T* __restrict__ vf, T* __restrict__ out, int parts, int rows, int N, int G, int D, float sscale) {
  constexpr int DL = DP / 32;
  if (DP != 128) D = DP;  // only width 128 takes several D: the others' D is known at compile time
  const int row = blockIdx.x * MERGE_WARPS + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bool on = DP != 128 || lane * DL < D;
  const size_t fr = ((size_t)(row / N) * (N / G) + (row % N) / G) * D;
  float kx[DL], vx[DL], sf = LIA_NEG_INF;
  if (kf) {
    fresh_kv<T, DL, RAW>(kf + fr, vf + fr, kx, vx, lane, D);
    sf = fresh_score<T, DL>(q + (size_t)row * D, kx, sscale, lane, D);
  }
  const float* ws_m = ws + (size_t)parts * rows * D;
  const float* ws_l = ws_m + (size_t)parts * rows;
  float M = sf, L = 0.f, o[DL];
  for (int p = 0; p < parts; ++p) M = fmaxf(M, ws_m[(size_t)p * rows + row]);
#pragma unroll
  for (int e = 0; e < DL; ++e) o[e] = 0.f;
  for (int p = 0; p < parts; ++p) {
    const float a = exp2f(ws_m[(size_t)p * rows + row] - M);
    L += ws_l[(size_t)p * rows + row] * a;
    float v[DL] = {};
#pragma unroll
    for (int e = 0; e < DL; e += 2) {
      if (!on) break;
      const float2 x = *reinterpret_cast<const float2*>(ws + ((size_t)p * rows + row) * D + lane * DL + e);
      v[e] = x.x;
      v[e + 1] = x.y;
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) o[e] = fmaf(v[e], a, o[e]);
  }
  if (kf) {
    const float pf = exp2f(sf - M);
    L += pf;
#pragma unroll
    for (int e = 0; e < DL; ++e) o[e] = fmaf(pf, vx[e], o[e]);
  }
  L = fmaxf(L, 1e-30f);
  if (!on) return;
#pragma unroll
  for (int e = 0; e < DL; ++e) out[(size_t)row * D + lane * DL + e] = lia::from_f32<T>(o[e] / L);
}

template <typename T, int DP, int D, bool RAW, bool BEAM>
int launch(const void* q, const void* kf, const void* vf, const Keys& keys, const void* lengths, int length_stride,
           void* out, void* ws, int parts, int B, int Nkv, int G, int bpc, int sms, float sscale,
           const float* slopes, cudaStream_t stream) {
  auto kern = int8_kernel<T, DP, D, RAW, BEAM>;
  static const cudaError_t attr = [&] {  // once an instantiation: the launch sits on the decode path
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int qpc = std::min(bpc * G, NQ), chunks = ((BEAM ? keys.nb : 1) * G + qpc - 1) / qpc;
  const int units = BEAM ? B / keys.nb : B;  // plane rows, or beam groups
  const dim3 grid(Nkv, units, parts * chunks);
  const int stages = ring_stages(DP, Nkv * units * parts * chunks, sms);
  kern<<<grid, THREADS, smem_bytes(DP, stages), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf), keys,
      static_cast<const int*>(lengths), length_stride, static_cast<T*>(out), static_cast<float*>(ws), parts, Nkv, G,
      bpc, sscale, stages, slopes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const int rows = B * Nkv * G;
  merge_kernel<T, DP, RAW><<<(rows + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf),
      static_cast<T*>(out), parts, rows, Nkv * G, G, D, sscale);
  return (int)cudaGetLastError();
}

// Type and head-dim dispatch, after the checks every entry shares: D 64, 80,
// 96, 112, 128 or 256, any group G = N / Nkv (the wrapper admits 1 .. 128),
// slopes ALiBi's (fp32 [N]) or null, bpc
// beams a chunk with bpc * G <= NQ or bpc = 1 (runs of NQ queries),
// parts >= 1 (a workspace of parts * B * N * (D + 2) floats when parts > 1),
// the codes 16-byte aligned. Returns a cudaError_t value, 0 on a successful
// launch.
template <bool RAW, bool BEAM>
int dispatch(const void* q, const void* kf, const void* vf, const Keys& keys, const void* lengths,
             int length_stride, void* out, void* ws, int parts, int B, int N, int Nkv, int D, int bpc, int sms,
             float sscale, int is_bf16, const void* slopes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nkv <= 0 || N % Nkv != 0 || B < 1 || parts < 1 || (parts > 1 && !ws) || sms < 1) return (int)cudaErrorInvalidValue;
  const int G = N / Nkv, DP = padded_dim(D);
  if (DP == 0 || bpc < 1 || (bpc > 1 && bpc * G > NQ) ||
      ((reinterpret_cast<uintptr_t>(keys.kq) | reinterpret_cast<uintptr_t>(keys.vq)) & 15) != 0 ||
      (BEAM && ((reinterpret_cast<uintptr_t>(keys.ktq) | reinterpret_cast<uintptr_t>(keys.vtq)) & 15) != 0))
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto kern) {
    return kern(q, kf, vf, keys, lengths, length_stride, out, ws, parts, B, Nkv, G, bpc, sms, sscale,
                static_cast<const float*>(slopes), st);
  };
  auto by_dim = [&](auto type) {
    using T = decltype(type);
    switch (D) {
      case 64: return run(&launch<T, 64, 64, RAW, BEAM>);
      case 80: return run(&launch<T, 128, 80, RAW, BEAM>);
      case 96: return run(&launch<T, 128, 96, RAW, BEAM>);
      case 112: return run(&launch<T, 128, 112, RAW, BEAM>);
      case 128: return run(&launch<T, 128, 128, RAW, BEAM>);
    }
    return run(&launch<T, 256, 256, RAW, BEAM>);
  };
  return is_bf16 ? by_dim(__nv_bfloat16{}) : by_dim(0.f);
}

}  // namespace lia_dec8
