// Grouped-beam decode attention over one layer of a bf16 beam cache, written
// for Hopper: the body behind beam_decode.cu (B9) for bf16 calls, the group's
// shared prompt plane, then each beam's own generated tail, then this step's
// fresh token, in one online softmax.
//
// Math, as the TPU kernel's: scores are dots of bf16 q and K rows summed in
// fp32 (bf16 products are exact there), times scale*log2(e) after the dot;
// the valid keys go through an online softmax in exp2 units with fp32
// probabilities; the fresh token merges in fp32 last; out = acc / max(l,
// 1e-30). plen, tlen and the prompt mask (pstart_g = plen -
// popcount(prompt_mask[g])) are read on the device, so a call never syncs
// and can be captured in a CUDA graph. With ALiBi slopes (common.cuh:
// alibi_slope) a key scores slope * log2(e) * (pos - plen - tlen) more, pos
// its slot in the prompt (its tail index t plus plen for a tail key): the
// reference's positions (a prompt slot's rank, real_len + t, the fresh token
// at real_len + tlen) less the query's, so the fresh token's term is 0. The
// term is a template flag (ALIBI); the instances without it are those before
// the port of ALiBi (a runtime branch cost them 1-5% on an H100).
//
// What bounds it on an H100: bytes, each group's prompt rows read once plus
// each beam's tail rows (~18.7 MB a launch at OPT-6.7B's heads with 4 groups
// of 4 beams over a 256-slot prompt, ~5.6 us at 3.35 TB/s). The first warp
// body (decode_attn.cuh) ran one block a beam, so a group's prompt crossed
// from memory, or from L2, once for each beam, and walked keys in scalar FMAs
// behind a 5-shuffle sum a key. The design, after decode_int8_attn.cuh's:
// - One block for each (kv head, beam group, chunk of beams) holds up to NQ =
//   16 queries (bpc beams x G heads, two n8 column tiles): a group's prompt
//   crosses from memory once a launch for all of them (OPT-6.7B, G = 1: 4
//   beams, 4 queries, 128 blocks at 4 x 4 beams; Llama-3-8B, G = 4: 16
//   queries, 32 blocks). More queries go to further blocks: a group's
//   queries, flattened (beam, head) as f = beam * G + head, go to blocks in
//   runs of qpc = min(bpc * G, NQ), whole beams where G <= 16, else runs of
//   16 heads that may straddle two beams (Falcon-7B's G = 71 at 4 beams: 18
//   runs, the last of 12). A block's tail ranges are those of the beams its
//   run reaches, each masked to that beam's columns, and it takes the fresh
//   tokens of its own queries; a ragged run's missing columns hold q = 0 and
//   are never stored.
// - A producer warp copies each stage of UNIT = 64 keys (K and V rows, 2D
//   bytes each) into a ring of mbarrier stages, up to `stages` ahead of the
//   consumers; the ring's depth follows the blocks an SM (ring_stages). Its 32
//   lanes issue 16-byte cp.async copies and each lane's completion arrives on
//   the stage's barrier (cp.async.mbarrier.arrive.noinc, count 32): a lane's
//   copy places each 16-byte chunk c of row r at chunk c ^ (r & 7) of the
//   row, so the consumers' ldmatrix phases (8 rows x 16 bytes) meet 8
//   distinct bank groups: no bank conflict. A 1-D bulk copy of a run would
//   leave the rows at a 256-byte stride, every row on the same banks; a bulk
//   copy a row into rows padded by 16 bytes was tried on an H100 and was
//   several times slower: the TMA unit serves 256-byte requests slowly.
// - Four consumer warps each take a 16-key tile of a stage through mma.sync
//   m16n8k16 in bf16, keys as M and queries as N: S^T = K Q^T with K's
//   fragments from ldmatrix.x4 and q's in registers from the block's start
//   (no conversion: the rows are bf16), scaled after the dot in fp32; then
//   O^T += V^T P^T with V^T's fragments from ldmatrix.x4.trans and P^T from
//   the score fragments through movmatrix.trans. A tile of a beam's tail is
//   masked to that beam's query columns; a tile's rows past its range are
//   masked to -1e30 and their V fragments zeroed (their shared memory may hold
//   anything, a NaN among it).
// - The probabilities stay fp32 in effect: P is split into hi = bf16(p) and
//   lo = bf16(p - hi), two mma's a V tile, so P.V sees p to ~2^-17 relative
//   (bf16(p) alone would err by up to 2^-9, as large as the output's own bf16
//   rounding). The sums run in fp32; against the plain version (fp32
//   throughout) the outputs differ by their bf16 rounding and the order of
//   the sums.
// - Stage s holds tiles 4s .. 4s + 3 of the walk: the prompt's range first,
//   then each beam's tail range, so a short tail of every beam shares one
//   stage, and tiles of one range in a stage come in one run of copies.
// - Nothing waits on a block barrier before the first copy: each warp reads
//   the lengths and counts the mask itself before the block's one barrier
//   (the ring's barriers initialised), and the consumers' q loads and the
//   producer's first fresh rows are in flight under that count. The producer
//   takes the fresh tokens' values and scores once every stage is issued; the
//   four consumer warps' partials and the fresh token merge through shared
//   memory at the end.
// - Where the blocks fill the card poorly and the walk is long, the wrapper
//   splits each group's keys into `parts`, cut on the device as B10's (units
//   where a prompt key counts 1 and a tail key nbc); the parts write fp32 (o,
//   m, l) partials to a workspace that decode_int8_attn.cuh's merge_kernel, a
//   second launch, combines with the fresh token. Every partial is written,
//   so the workspace needs no memset and the pair of launches replays in a
//   CUDA graph.
// - Head dims: the ring's rows are DP wide (64, 128 or 256; the swizzle
//   permutes a row's chunks within aligned runs of 8), while a row in memory
//   is D wide (both template parameters). The producer
//   copies a row's D / 8 chunks only, and the consumers' products step over
//   the D / 16 dims a tile that hold data, so D = 80, 96 and 112 (DP = 128) do the
//   arithmetic of their own width and never read the padding. At DP = 256 a
//   block holds up to QN = 8 queries (one column tile), so its O^T and q
//   fragments stay at 96 registers.
// fp32 calls (tests and CPU-parity tools only; no model path on the card
// runs fp32) stay on decode_attn.cuh's warp body, exact in fp32.
//
// The same body serves bf16 plane decode at query-head groups past 8 (B2
// through decode_fresh.cu, B7/B8 through decode.cu): a plane row is a group
// of one beam (nb = 1) whose prompt is the cache plane, with per-row lengths
// (Keys::len_stride 1), no tail (a null tail_len) and, for B7/B8, no fresh
// token (null kf: the plane already holds it). decode_attn.cuh's warp body
// took 0.045 ms there (Falcon-7B's and ChatGLM3-6B's heads, b16, past 272,
// on an H100), above SDPA's time, against ~0.01 for this body at beams of
// those heads: it walks every key once per 8 heads and sums each score over
// the warp with five shuffles.
#pragma once

#include "decode_int8_attn.cuh"  // mma_bf16, movmatrix_trans, the fresh tokens, the mask count, merge_kernel

namespace lia_beam {
// Internal linkage: beam_decode.cu, decode_fresh.cu and decode.cu each build
// their own copy of the body into their own library, and a function-local
// static of a template with external linkage would be one object across the
// libraries of a process (a GNU unique symbol): the first library's launch
// would set its kernel's shared-memory attribute and the others' never.
namespace {

using namespace lia;  // the PTX wrappers of hopper.cuh
using bf16 = __nv_bfloat16;

constexpr int NWC = 4;                   // consumer warps a block
constexpr int THREADS = 32 * (NWC + 1);  // and one producer warp
constexpr int TILE = 16;                 // keys of a consumer warp's mma tile
constexpr int UNIT = NWC * TILE;         // keys of a ring stage
constexpr int NQ = 16;                   // queries a block: two n8 column tiles (8 at DP = 256: qn)
constexpr int MAX_STAGES = 8;
constexpr int MAX_PER_SM = 4;
constexpr int SM_SMEM = 228 * 1024;      // shared memory of an SM
constexpr int BLOCK_SMEM = 227 * 1024;   // most a block takes
constexpr int PO_PAD = 4;                // floats after each row of the partials' o: writes spread over the banks

// The keys of one layer: the group prompt plane [B0, Nkv, S, D] and its mask
// [B0, S], its length at prompt_len[g * len_stride] (one for all groups, or a
// plane row's own); each beam's tail [B0 * nb, Nkv, T, D], nb beams a group,
// the tail length on the device (null: no tail).
struct Keys {
  const bf16* kp;
  const bf16* vp;
  const uint8_t* mask;
  int S;
  const bf16* kt;
  const bf16* vt;
  int T, nb;
  const int* tail_len;
  int len_stride;
};

// Queries a block holds at width DP: NQ, or one column tile at DP = 256.
__host__ __device__ constexpr int qn(int DP) { return DP > 128 ? 8 : NQ; }
// Bytes of one ring stage: the K rows of UNIT keys, then their V rows.
__host__ __device__ constexpr int stage_bytes(int DP) { return 2 * UNIT * DP * 2; }
// The fresh tokens' scores [NQ] and values [qn][DP] (fp32), after the ring.
__host__ __device__ constexpr int fresh_bytes(int DP) { return (NQ + qn(DP) * DP) * 4; }
__host__ __device__ constexpr int smem_bytes(int DP, int stages) {
  return stages * stage_bytes(DP) + fresh_bytes(DP) + 16 * stages;
}
// The consumer warps' partials (m, l [NWC][NQ], o [NWC][NQ][DP + PO_PAD]) go
// through the ring once the walk is over: two stages hold them.
static_assert(2 * NWC * NQ * 4 + NWC * NQ * (64 + PO_PAD) * 4 <= 2 * stage_bytes(64), "partials exceed the ring");
static_assert(2 * NWC * NQ * 4 + NWC * NQ * (128 + PO_PAD) * 4 <= 2 * stage_bytes(128), "partials exceed the ring");
static_assert(2 * NWC * NQ * 4 + NWC * NQ * (256 + PO_PAD) * 4 <= 2 * stage_bytes(256), "partials exceed the ring");

// Stages of the ring for a launch of `blocks` blocks on `sms` SMs: as many as
// fit when the blocks an SM share its shared memory.
inline int ring_stages(int DP, int blocks, int sms) {
  const int per_sm = std::min(MAX_PER_SM, std::max(1, (blocks + sms - 1) / std::max(sms, 1)));
  const int room = std::min(SM_SMEM / per_sm - 1024, BLOCK_SMEM) - fresh_bytes(DP) - 16 * MAX_STAGES;
  return std::max(2, std::min(MAX_STAGES, room / stage_bytes(DP)));
}


// Four 8 x 8 matrices of 16-bit values from shared memory, lanes 8i .. 8i + 7
// giving the row addresses of matrix i; .trans hands each lane the transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// Byte offset of 16-byte chunk `ch` of K or V row `row` in a stage's half.
template <int DP>
__device__ __forceinline__ int row_at(int row, int ch) {
  return row * (2 * DP) + ((ch ^ (row & 7)) << 4);
}

// One range of keys [lo, hi) of the prompt row or of a beam's tail row; beam
// >= 0: a tail, whose keys only that beam's queries (columns beam * G ..) see.
struct Seg {
  const bf16* k;
  const bf16* v;
  int lo, hi, beam;
};

// One block: kv head blockIdx.x of beam group blockIdx.y, part blockIdx.z %
// parts of its keys, the group's flat queries [chunk * qpc, + qpc) with chunk
// = blockIdx.z / parts and qpc = min(bpc * G, qn(DP)). NT column tiles of 8
// queries (NT = 2 past 8 queries). Rows lie D apart in memory, DP apart in the
// ring. Two blocks an SM, one at DP = 256 (its 16 O^T tiles and q fragments
// spill at the 168 registers of two).
template <int DP, int D, int NT, bool ALIBI>
__global__ void __launch_bounds__(THREADS, DP > 128 ? 1 : 2)
beam_kernel(const bf16* __restrict__ q,   // [B, N, D]
            const bf16* __restrict__ kf,  // [B, Nkv, D] fresh key, or null
            const bf16* __restrict__ vf,
            Keys keys,
            const int* __restrict__ prompt_len,
            bf16* __restrict__ out,       // [B, N, D] (parts == 1)
            float* __restrict__ ws,       // parts > 1: o [parts, B*N, D], m, l [parts, B*N]
            int parts, int Nkv, int G, int bpc, float sscale, int stages,
            const float* __restrict__ slopes) {  // ALiBi [N] (ALIBI only)
  constexpr int KK = DP / 16;  // k16 chunks of a K row; 16-dim tiles of O^T (those below D / 16 hold data)
  constexpr int QN = qn(DP);   // queries a block at most
  constexpr int PO = DP + PO_PAD;
  constexpr int CH = D / 8;    // 16-byte chunks of a row in memory
  const int h = blockIdx.x, g = blockIdx.y;
  const int part = blockIdx.z % parts, chunk = blockIdx.z / parts;
  const int N = Nkv * G;
  const bool fresh = kf != nullptr;  // a fresh token a beam (null: B7/B8's plane already holds it)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c = lane & 3;

  extern __shared__ __align__(128) unsigned char smem[];
  const int sbytes = stage_bytes(DP);
  float* fresh_s = reinterpret_cast<float*>(smem + stages * sbytes);  // [NQ]
  float* fresh_v = fresh_s + NQ;                                      // [QN][DP]
  const uint32_t full0 = smem_addr(fresh_v + QN * DP), empty0 = full0 + 8 * stages;
  float* pm = reinterpret_cast<float*>(smem);  // after the walk: m [NWC][NQ], l, o [NWC][NQ][PO]
  float* pl = pm + NWC * NQ;
  float* po = pl + NWC * NQ;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 32);    // every producer lane's copies land
      mbar_init(empty0 + 8 * s, NWC);  // every consumer warp releases every stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the chunk's flat queries [q0, q0 + nq) of the group's nb * G, and the
  // beams j0 .. j0 + nbc - 1 they reach: bpc whole beams (no division on the
  // block's way to its first copies), or a run of QN that may straddle two
  int q0, nq, j0, nbc;
  if (bpc * G <= QN) {
    j0 = chunk * bpc;
    nbc = min(bpc, keys.nb - j0);
    q0 = j0 * G;
    nq = nbc * G;
  } else {
    q0 = chunk * QN;
    nq = min(QN, keys.nb * G - q0);
    j0 = q0 / G;
    nbc = (q0 + nq - 1) / G - j0 + 1;
  }
  const int off = q0 - j0 * G;  // the run's first query's head in beam j0 (0 for whole beams)
  // query j of the block: flat query f = q0 + j, head h * G + f % G of beam f / G of group g
  auto qrow = [&](int j) -> size_t {
    return (size_t)(g * keys.nb + j0 + (off + j) / G) * N + h * G + (off + j) % G;
  };
  auto fresh_row = [&](int t) -> size_t { return ((size_t)(g * keys.nb + j0 + t) * Nkv + h) * D; };

  // the consumers' q fragments and the producer's first fresh rows, in flight
  // under the mask's count: lane (r, c) holds query 8 nt + r's dims 16 kk +
  // 2c, + 1 and 16 kk + 2c + 8, + 9 (Q^T's B fragment of chunk kk)
  uint32_t qf[NT][KK][2];
  lia_dec8::FreshFirst<bf16, DP> first;
  if (warp < NWC) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = 8 * nt + r;
      const bf16* qp = q + qrow(j < nq ? j : 0) * D + 2 * c;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        qf[nt][kk][0] = qf[nt][kk][1] = 0u;
        if (16 * kk < D) {
          qf[nt][kk][0] = lia_dec8::ldg4(qp + 16 * kk);
          qf[nt][kk][1] = lia_dec8::ldg4(qp + 16 * kk + 8);
        }
      }
    }
  } else if (parts == 1 && fresh) {
    const int grp = lane >> 3, gl = lane & 7;
    const int t = min(grp, nbc - 1);
    first.load(kf + fresh_row(t) + gl * (DP / 8), vf + fresh_row(t) + gl * (DP / 8),
               q + qrow(lia_dec8::first_query(t, q0, j0, nq, G)) * D + gl * (DP / 8), gl * (DP / 8) < D);
  }

  // this block's keys, cut on the device by each warp from the lengths and the mask
  const int plen = min(max(prompt_len[(size_t)g * keys.len_stride], 0), keys.S);
  const int tl = keys.tail_len ? min(max(*keys.tail_len, 0), keys.T) : 0;
  const int pstart = max(plen - lia_dec8::warp_count_true(keys.mask + (size_t)g * keys.S, keys.S, lane), 0);
  // units: a prompt key counts 1, a tail key nbc (one row for each beam)
  const long long pn = plen - pstart, units = pn + (long long)nbc * tl;
  const long long u0 = units * part / parts, u1 = units * (part + 1) / parts;
  const int lo = pstart + (int)min(u0, pn), hi = pstart + (int)min(u1, pn);
  const int t_lo = u0 <= pn ? 0 : (int)min((u0 - pn + nbc - 1) / nbc, (long long)tl);
  const int t_hi = u1 <= pn ? 0 : (int)min((u1 - pn + nbc - 1) / nbc, (long long)tl);
  auto seg = [&](int sg) -> Seg {
    if (sg == 0) {
      const size_t row = ((size_t)g * Nkv + h) * keys.S;  // the group's prompt row
      return Seg{keys.kp + row * D, keys.vp + row * D, lo, hi, -1};
    }
    const size_t row = (((size_t)g * keys.nb + j0 + sg - 1) * Nkv + h) * keys.T;  // beam j0 + sg - 1's tail
    return Seg{keys.kt + row * D, keys.vt + row * D, t_lo, t_hi, sg - 1};
  };
  const int tiles0 = (hi - lo + TILE - 1) / TILE, tiles_t = (t_hi - t_lo + TILE - 1) / TILE;
  const int tiles = tiles0 + nbc * tiles_t, nstages = (tiles + NWC - 1) / NWC;
  auto seg_tiles = [&](int sg) { return sg == 0 ? tiles0 : tiles_t; };
  // (range, tile in it) of a walk position, moved forward by k tiles (no division)
  auto advance = [&](int& sg, int& ti, int k) {
    for (ti += k; sg < nbc && ti >= seg_tiles(sg); ++sg) ti -= seg_tiles(sg);
  };
  // the block's only barrier before the walk (the ring's barriers are
  // initialised), after each warp has read the lengths and the mask itself
  __syncthreads();

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
        const unsigned char* kg = reinterpret_cast<const unsigned char*>(sgm.k + (size_t)k0 * D);
        const unsigned char* vg = reinterpret_cast<const unsigned char*>(sgm.v + (size_t)k0 * D);
        for (int i = lane; i < n * CH; i += 32) {
          const int at = row_at<DP>(w * TILE + i / CH, i % CH);
          lia::cp_async16(base + at, kg + 16 * i, true);
          lia::cp_async16(base + UNIT * 2 * DP + at, vg + 16 * i, true);
        }
        w += k;
        const int sg0 = sg;
        advance(sg, ti, k);
        if (sg != sg0) sgm = seg(sg);
      }
      lia_dec8::cp_async_arrive(full0 + 8 * st);
    }
    // every stage is issued: the fresh tokens (the merge launch's where the
    // keys split), under the consumers' last stages
    if (parts == 1 && fresh)
      lia_dec8::fresh_tokens<bf16, DP>(kf, vf, q, fresh_row, qrow, nbc, q0, j0, nq, G, D, sscale, fresh_s, fresh_v,
                                       lane, first);
    lia_dec8::named_arrive(2, THREADS);
    return;
  }

  // ---- the consumer warps ----
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (8 * nt + r >= nq) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) qf[nt][kk][0] = qf[nt][kk][1] = 0u;
    }
  // the beams (0 .. nbc - 1 from j0) of this lane's columns 8 nt + 2c, + 1;
  // -1 past the run's queries
  int cbeam[NT][2];
  float csl[NT][2];  // the columns' ALiBi slopes in exp2 units
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * nt + 2 * c + e;
      cbeam[nt][e] = col < nq ? (off + col) / G : -1;
      csl[nt][e] = ALIBI && col < nq ? alibi_slope(slopes, h * G + (off + col) % G) : 0.f;
    }

  // per lane: O^T tile m, column tile nt at dims 16 m + r (and + 8) of
  // queries 8 nt + 2c, + 1; each column's running max and this lane's part of
  // its sum
  float o[KK][NT][4], mcol[NT][2], lpart[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mcol[nt][e] = LIA_NEG_INF;
      lpart[nt][e] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < KK; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][nt][e] = 0.f;
  }

  // the lane's ldmatrix rows: matrix mi = lane / 8, row li = lane % 8. K (A
  // = K, keys x dims): keys 8 (mi & 1) + li, chunk 2 kk + mi / 2. V (A = V^T,
  // dims x keys, transposed on load): keys 8 (mi / 2) + li, chunk 2 m + (mi & 1).
  const int mi = lane >> 3, li = lane & 7;
  const uint32_t ring = smem_addr(smem);
  const uint32_t koff = (warp * TILE + 8 * (mi & 1) + li) * (2 * DP);
  const uint32_t voff = UNIT * 2 * DP + (warp * TILE + 8 * (mi >> 1) + li) * (2 * DP);
  const int kch = mi >> 1, vch = mi & 1;
  auto chunk_at = [&](int c) -> uint32_t { return (c ^ li) << 4; };  // chunk c of the lane's row, swizzled

  int sg = 0, ti = 0;  // this warp's tile of the stage: NWC * s + warp
  advance(sg, ti, warp);
  for (int s = 0; s < nstages; ++s, advance(sg, ti, NWC)) {
    const int st = s % stages, i = NWC * s + warp;
    mbar_wait(full0 + 8 * st, (s / stages) & 1);
    if (i < tiles) {
      const Seg sgm = seg(sg);
      const int nv = min(TILE, sgm.hi - (sgm.lo + TILE * ti));
      const uint32_t base = ring + st * sbytes;
      // S^T = K Q^T (two accumulators a column tile: shorter chains)
      float sacc[NT][2][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][0][e] = sacc[nt][1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        if (16 * kk >= D) break;  // the ring's padding: never copied
        uint32_t a[4];
        ldsm_x4(a, base + koff + chunk_at(2 * kk + kch));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          lia_dec8::mma_bf16(sacc[nt][kk & 1], a[0], a[1], a[2], a[3], qf[nt][kk][0], qf[nt][kk][1]);
      }
      // scores of keys r (e = 0, 1) and r + 8 (e = 2, 3) for columns 8 nt + 2c, + 1
      const bool v0 = r < nv, v1 = r + 8 < nv;
      uint32_t pb[NT][2][2];  // P^T as the B operand: [column tile][hi, lo][keys 0-7, 8-15]
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // columns this range's keys reach: the block's, or one beam's
        const bool ok0 = cbeam[nt][0] >= 0 && (sgm.beam < 0 || cbeam[nt][0] == sgm.beam);
        const bool ok1 = cbeam[nt][1] >= 0 && (sgm.beam < 0 || cbeam[nt][1] == sgm.beam);
        const bool in[4] = {v0 && ok0, v0 && ok1, v1 && ok0, v1 && ok1};
        float sc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[e] = in[e] ? (sacc[nt][0][e] + sacc[nt][1][e]) * sscale : LIA_NEG_INF;
        if constexpr (ALIBI) {  // key r (r + 8) of the tile against the query after the prompt and tail
          const int kb = sgm.lo + TILE * ti + r - (sgm.beam < 0 ? plen + tl : tl);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (in[e]) sc[e] = fmaf(csl[nt][e & 1], (float)(kb + 8 * (e >> 1)), sc[e]);
        }
        float pw[4], alpha[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mt = fmaxf(sc[e], sc[e + 2]);
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
          const float m_new = fmaxf(mcol[nt][e], mt);
          alpha[e] = exp2f(mcol[nt][e] - m_new);
          pw[e] = in[e] ? exp2f(sc[e] - m_new) : 0.f;
          pw[e + 2] = in[e + 2] ? exp2f(sc[e + 2] - m_new) : 0.f;
          lpart[nt][e] = lpart[nt][e] * alpha[e] + pw[e] + pw[e + 2];
          mcol[nt][e] = m_new;
        }
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a column's max moved
#pragma unroll
          for (int m = 0; m < KK; ++m) {
            o[m][nt][0] *= alpha[0];
            o[m][nt][1] *= alpha[1];
            o[m][nt][2] *= alpha[0];
            o[m][nt][3] *= alpha[1];
          }
        }
        // hi = bf16(p), lo = bf16(p - hi); each 8-key half's C layout, transposed
        float ph[4], plo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ph[e] = __bfloat162float(__float2bfloat16_rn(pw[e]));
          plo[e] = pw[e] - ph[e];
        }
        pb[nt][0][0] = lia_dec8::movmatrix_trans(lia_dec8::pack_bf16x2(ph[0], ph[1]));
        pb[nt][0][1] = lia_dec8::movmatrix_trans(lia_dec8::pack_bf16x2(ph[2], ph[3]));
        pb[nt][1][0] = lia_dec8::movmatrix_trans(lia_dec8::pack_bf16x2(plo[0], plo[1]));
        pb[nt][1][1] = lia_dec8::movmatrix_trans(lia_dec8::pack_bf16x2(plo[2], plo[3]));
      }
      // O^T += V^T P^T: lane (r, c)'s A fragment holds keys 2c, 2c + 1 (a0,
      // a1) and 2c + 8, 2c + 9 (a2, a3); keys past the range are zeroed
      const uint32_t km0 = (2 * c < nv ? 0x0000ffffu : 0u) | (2 * c + 1 < nv ? 0xffff0000u : 0u);
      const uint32_t km1 = (2 * c + 8 < nv ? 0x0000ffffu : 0u) | (2 * c + 9 < nv ? 0xffff0000u : 0u);
#pragma unroll
      for (int m = 0; m < KK; ++m) {
        if (16 * m >= D) break;
        uint32_t a[4];
        ldsm_x4_trans(a, base + voff + chunk_at(2 * m + vch));
        if (nv < TILE) {
          a[0] &= km0;
          a[1] &= km0;
          a[2] &= km1;
          a[3] &= km1;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int pc = 0; pc < 2; ++pc)
            lia_dec8::mma_bf16(o[m][nt], a[0], a[1], a[2], a[3], pb[nt][pc][0], pb[nt][pc][1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  // the warps' partials, through the (now idle) ring
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lpart[nt][e] += __shfl_xor_sync(0xffffffffu, lpart[nt][e], 4);
      lpart[nt][e] += __shfl_xor_sync(0xffffffffu, lpart[nt][e], 8);
      lpart[nt][e] += __shfl_xor_sync(0xffffffffu, lpart[nt][e], 16);
    }
  named_sync(1, NWC * 32);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (r == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pm[warp * NQ + 8 * nt + 2 * c + e] = mcol[nt][e];
        pl[warp * NQ + 8 * nt + 2 * c + e] = lpart[nt][e];
      }
    }
#pragma unroll
    for (int m = 0; m < KK; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* row = po + (warp * NQ + 8 * nt + 2 * c + e) * PO + 16 * m + r;
        row[0] = o[m][nt][e];
        row[8] = o[m][nt][e + 2];
      }
  }
  named_sync(1, NWC * 32);

  named_sync(2, THREADS);  // the producer's fresh tokens are in shared memory
  // merged over the warps (and, with one part, the fresh token last), a pair of
  // dims a thread
  const size_t rows_all = (size_t)gridDim.y * keys.nb * N;
  for (int idx = tid; idx < nq * (D / 2); idx += NWC * 32) {
    const int j = idx / (D / 2), d = 2 * (idx % (D / 2));
    float M = parts == 1 && fresh ? fresh_s[j] : LIA_NEG_INF;
#pragma unroll
    for (int w = 0; w < NWC; ++w) M = fmaxf(M, pm[w * NQ + j]);
    float L = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < NWC; ++w) {
      const float a = exp2f(pm[w * NQ + j] - M);
      L += pl[w * NQ + j] * a;
      const float2 x = *reinterpret_cast<const float2*>(po + (w * NQ + j) * PO + d);
      o0 = fmaf(x.x, a, o0);
      o1 = fmaf(x.y, a, o1);
    }
    const size_t row = qrow(j);
    if (parts == 1) {
      if (fresh) {  // (without one, fresh_v holds no value: it is never read)
        const float pf = exp2f(fresh_s[j] - M);
        const float* v = fresh_v + ((off + j) / G) * DP + d;
        L += pf;
        o0 = fmaf(pf, v[0], o0);
        o1 = fmaf(pf, v[1], o1);
      }
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

template <int DP, int D, int NT, bool ALIBI>
int launch(const void* q, const void* kf, const void* vf, const Keys& keys, const void* prompt_len, void* out,
           void* ws, int parts, int B, int Nkv, int G, int bpc, int sms, float sscale, const float* slopes,
           cudaStream_t stream) {
  auto kern = beam_kernel<DP, D, NT, ALIBI>;
  static const cudaError_t attr = [&] {  // once an instantiation: the launch sits on the decode path
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, BLOCK_SMEM);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const int qpc = std::min(bpc * G, qn(DP)), chunks = (keys.nb * G + qpc - 1) / qpc, groups = B / keys.nb;
  const dim3 grid(Nkv, groups, parts * chunks);
  const int stages = ring_stages(DP, Nkv * groups * parts * chunks, sms);
  kern<<<grid, THREADS, smem_bytes(DP, stages), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kf), static_cast<const bf16*>(vf), keys,
      static_cast<const int*>(prompt_len), static_cast<bf16*>(out), static_cast<float*>(ws), parts, Nkv, G, bpc,
      sscale, stages, slopes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const int rows = B * Nkv * G;
  lia_dec8::merge_kernel<bf16, DP, false>
      <<<(rows + lia_dec8::MERGE_WARPS - 1) / lia_dec8::MERGE_WARPS, 32 * lia_dec8::MERGE_WARPS, 0, stream>>>(
          static_cast<const float*>(ws), static_cast<const bf16*>(q), static_cast<const bf16*>(kf),
          static_cast<const bf16*>(vf), static_cast<bf16*>(out), parts, rows, Nkv * G, G, D, sscale);
  return (int)cudaGetLastError();
}

// Head-dim and column-tile dispatch, after the checks: D 64, 80, 96, 112, 128
// or 256, any group G = N / Nkv (the wrapper admits 1 .. 128), slopes ALiBi's
// (fp32 [N]) or null, bpc beams a chunk
// with bpc * G <= qn or bpc = 1 (runs of qn queries: 16, or 8 at D = 256),
// parts >= 1 (a
// workspace of parts * B * N * (D + 2) floats when parts > 1), q, the fresh
// k/v and the caches 16-byte aligned. Returns a cudaError_t value, 0 on a
// successful launch.
inline int dispatch(const void* q, const void* kf, const void* vf, const Keys& keys, const void* prompt_len,
                    void* out, void* ws, int parts, int B, int N, int Nkv, int D, int bpc, int sms, float sscale,
                    const void* slopes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Nkv <= 0 || N % Nkv != 0 || B < 1 || parts < 1 || (parts > 1 && !ws) || sms < 1) return (int)cudaErrorInvalidValue;
  const int G = N / Nkv;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(kf) |
                         reinterpret_cast<uintptr_t>(vf) | reinterpret_cast<uintptr_t>(keys.kp) |
                         reinterpret_cast<uintptr_t>(keys.vp) | reinterpret_cast<uintptr_t>(keys.kt) |
                         reinterpret_cast<uintptr_t>(keys.vt);
  const int DP = padded_dim(D);
  if (DP == 0 || bpc < 1 || (bpc > 1 && bpc * G > qn(DP)) || (addr & 15) != 0) return (int)cudaErrorInvalidValue;
  auto run = [&](auto kern) {
    return kern(q, kf, vf, keys, prompt_len, out, ws, parts, B, Nkv, G, bpc, sms, sscale,
                static_cast<const float*>(slopes), st);
  };
  const bool one = std::min(bpc * G, NQ) <= 8;  // one column tile of 8 queries
  auto by_dim = [&](auto alibi) {
    constexpr bool A = decltype(alibi)::value;
    if (D == 256) return run(&launch<256, 256, 1, A>);
    switch (D) {
      case 64: return one ? run(&launch<64, 64, 1, A>) : run(&launch<64, 64, 2, A>);
      case 80: return one ? run(&launch<128, 80, 1, A>) : run(&launch<128, 80, 2, A>);
      case 96: return one ? run(&launch<128, 96, 1, A>) : run(&launch<128, 96, 2, A>);
      case 112: return one ? run(&launch<128, 112, 1, A>) : run(&launch<128, 112, 2, A>);
    }
    return one ? run(&launch<128, 128, 1, A>) : run(&launch<128, 128, 2, A>);
  };
  return slopes ? by_dim(std::true_type{}) : by_dim(std::false_type{});
}

}  // namespace
}  // namespace lia_beam
