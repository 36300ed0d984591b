// Paged decode attention of one layer, bf16 (or fp32): the body behind
// paged_decode.cu, written for Hopper. C queries per sequence (C = 1 decode,
// C = k + 1 speculative verify) over the keys [0, length_b) of a paged pool
// layer [nb, Nkv, bs, D], walked through the block table; then (with a fresh
// chunk) chunk row c merges the fresh keys 0..c last, the causal triangle
// inside the chunk. The table and the lengths are read on the device.
//
// Math, all in fp32 as decode_attn.cuh's: q is scaled by scale*log2(e), the
// valid keys go through an online softmax in exp2 units, out = acc / max(l,
// 1e-30), so a row with no valid key and no fresh chunk comes out 0. With
// ALiBi slopes (common.cuh: alibi_slope), page key j scores slope * log2(e) *
// (j - length_b) more and fresh key c' slope * log2(e) * c': the reference's
// logical positions (lia_tpu/ops/paged.py: attend_chunk_paged) less length_b,
// the same for every chunk row of the block (a chunk row's own position would
// cost registers the kernel spills). The term is a template flag (ALIBI): at
// one query a warp the body holds 8 keys' K and V rows in registers (4 at
// width 256) and sits at the 96 registers of four blocks an SM, where the
// term made ptxas spill 16 bytes, and at three blocks an SM the ALiBi
// instance took 1.48x the time of the plain one on an H100 (chip_smoke.py's
// timing rows); so its one-query instances take half the keys a step and
// keep four blocks an SM. The instances without the flag are those before
// the port of ALiBi.
//
// What bounds it on an H100: bytes; each (batch row, kv head) streams its
// valid K and V rows once (~71 MB a launch at OPT-6.7B b16 with ~272 cached
// tokens, ~21 us at 3.35 TB/s). decode_attn.cuh's body walked the pool key by
// key with the page looked up inside every 8-key step, so each K/V load waited
// on a table load. Here no key load waits on anything but its copy:
// - The unit of work is a page of one kv head: bs x D contiguous elements (4 KB
//   at bs 16, D 128, bf16), or a slice of UNIT_BYTES where a page is larger. A
//   block stages its share of the row's block-table entries in shared memory
//   once, with one coalesced load, and a producer warp copies whole K and V
//   units (the rows below the length only) into a ring of mbarrier stages with
//   cp.async.bulk (TMA's 1-D bulk copy: no tensor map, no registers), up to
//   `stages` units ahead of the consumers. Page and slot come from the loop
//   counters: no key's address takes a division.
// - All G query heads and all C chunk rows of a (kv head, row) read each staged
//   unit: four consumer warps split the block's queries (QPW a warp) and, where
//   the queries are fewer than the warps, the unit's keys; a lane holds D / 32
//   dimensions of a key row, so a warp reads a row of shared memory at once.
//   C > 1 reads the keys from memory once (up to 16 queries a block; more go to
//   further blocks, which read them again from L2).
// - Where the (kv head, row) blocks fill the card poorly (Llama's G = 4: 128
//   blocks), the wrapper splits each row's pages into `parts` even ranges, cut
//   on the device from the row's own length (a range past the length exits at
//   once with an empty partial). The parts write fp32 (o, m, l) partials to a
//   workspace that a second launch (merge_kernel) merges with the fresh chunk.
//   Every partial is written, so the workspace needs no memset and the pair of
//   launches can be captured in a CUDA graph.
// Pages past the frontier (the null page 0 in unused entries) are never read.
// - Head dims: a lane holds DP / 32 dims of a width DP of 64, 128 or 256 (the
//   template parameter); rows lie D apart (a runtime argument) in the pool and
//   in the ring, so a page copies as it is. At D = 80, 96 and 112 (DP = 128) the
//   lanes past D / 4 hold zeros and read and store nothing; at DP = 256 a
//   step takes four keys (two with four queries a warp), so a lane's loads
//   stay those of DP = 128.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace lia_paged {

using namespace lia;  // the PTX wrappers of hopper.cuh

constexpr int NWC = 4;                   // consumer warps a block
constexpr int THREADS = 32 * (NWC + 1);  // and one producer warp
constexpr int MAXP = 256;                // block-table entries a block stages (the wrapper's PAGED_MAX_TABLE)
constexpr int UNIT_BYTES = 8192;         // most K bytes of one ring unit
constexpr int RING_BYTES = 24 * 1024;    // K and V bytes of the ring (registers keep four blocks an SM)
constexpr int MAX_STAGES = 8;
constexpr int MERGE_WARPS = 4;

// Rows of a ring unit, stages of the ring and dynamic shared memory of a
// block, from the element size, D, bs and the queries a warp (QPW). The
// warps' partials reuse the ring once the walk is over.
struct Geo {
  int unit, stages, ring, bytes;
  __host__ __device__ Geo(int es, int D, int bs, int qpw) {
    const int umax = UNIT_BYTES / (D * es);
    unit = bs < umax ? bs : umax;
    stages = RING_BYTES / (2 * unit * D * es);
    stages = stages < 2 ? 2 : stages > MAX_STAGES ? MAX_STAGES : stages;
    ring = 2 * stages * unit * D * es;
    const int partials = NWC * qpw * (D + 2) * 4;
    bytes = (ring > partials ? ring : partials) + MAXP * 4 + 2 * stages * 8;
  }
};

// One contiguous chunk of global memory into shared memory, completing on `bar`
// (bytes a multiple of 16, both addresses 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Keys a consumer step at width DP with QPW queries a warp (at DP = 256 the
// lane's loads stay those of DP = 128, and its four queries' registers fit).
__host__ __device__ constexpr int keys_a_step(int DP, int QPW) { return DP > 128 ? (QPW == 4 ? 2 : 4) : 8; }


// q . k over the warp for one key row k (DL elements a lane; the lanes past
// the row's D (!on) add nothing).
template <typename T, int DL>
__device__ __forceinline__ float score(const float (&qr)[DL], const T* k, int lane, bool on) {
  float kx[DL] = {};
  if (on) lia::load_vec<DL>(k + lane * DL, kx);
  float part = 0.f;
#pragma unroll
  for (int e = 0; e < DL; ++e) part = fmaf(qr[e], kx[e], part);
  return lia::warp_sum(part);
}

// The walk's merged (m, l, o) of one query row, with the fresh keys 0..c of
// kf / vf ([C, D] of this (row, kv head), or null) merged last, normalised and
// written to dst. qr is the row's query, already scaled; sl its ALiBi slope in
// exp2 units (0 without), fresh key j scoring sl * j more.
template <typename T, int DL, bool ALIBI>
__device__ __forceinline__ void finish(float m, float l, float (&o)[DL], const float (&qr)[DL], const T* kf,
                                       const T* vf, int c, T* dst, int lane, int D, bool on, float sl) {
  auto fresh = [&](int j) {  // fresh key j's score
    const float sc = score<T, DL>(qr, kf + (size_t)j * D, lane, on);
    return ALIBI ? fmaf(sl, (float)j, sc) : sc;
  };
  float M = m;
  if (kf)
    for (int j = 0; j <= c; ++j) M = fmaxf(M, fresh(j));
  const float a = exp2f(m - M);
  float L = l * a;
#pragma unroll
  for (int e = 0; e < DL; ++e) o[e] *= a;
  if (kf) {
    for (int j = 0; j <= c; ++j) {
      const float p = exp2f(fresh(j) - M);
      float vx[DL] = {};
      if (on) lia::load_vec<DL>(vf + (size_t)j * D + lane * DL, vx);
      L += p;
#pragma unroll
      for (int e = 0; e < DL; ++e) o[e] = fmaf(p, vx[e], o[e]);
    }
  }
  L = fmaxf(L, 1e-30f);
  if (!on) return;
#pragma unroll
  for (int e = 0; e < DL; ++e) dst[lane * DL + e] = lia::from_f32<T>(o[e] / L);
}

// One block: kv head blockIdx.x of row blockIdx.y, part blockIdx.z % parts of
// the row's pages, queries chunk blockIdx.z / parts (NWC * QPW queries of the
// G * C, query j = chunk row j / G, head j % G of the kv head's group).
// Blocks an SM: four with one query a warp (96 registers), two with four
// (their queries' accumulators); named, ptxas otherwise trades spills for
// occupancy at width 64 with four queries a warp.
template <typename T, int DP, int QPW, bool ALIBI>
__global__ void __launch_bounds__(THREADS, QPW == 1 ? 4 : 2)
paged_kernel(const T* __restrict__ q,         // [B, C, N, D]
             const T* __restrict__ kf,        // [B, Nkv, C, D] fresh keys, or null
             const T* __restrict__ vf,        // [B, Nkv, C, D] fresh values, or null
             const T* __restrict__ kc,        // one layer of the pool [nb, Nkv, bs, D]
             const T* __restrict__ vc,
             const int* __restrict__ table,   // [B, P]
             const int* __restrict__ lengths, int length_stride,  // [B] or a scalar
             T* __restrict__ out,             // [B, C, N, D] (parts == 1)
             float* __restrict__ ws,          // partials (parts > 1): o [parts, B*C*N, D], m, l [parts, B*C*N]
             int parts, int C, int G, int Nkv, int P, int bs, int D, float sscale,
             const float* __restrict__ slopes) {  // ALiBi [N] (ALIBI only)
  constexpr int DL = DP / 32;  // dims per lane
  constexpr int KT = keys_a_step(DP, QPW) / (ALIBI && QPW == 1 ? 2 : 1);
  constexpr int ES = sizeof(T);
  if (DP != 128) D = DP;  // only width 128 takes several D: the others' D is known at compile time

  const Geo geo(ES, D, bs, QPW);
  const int h = blockIdx.x, b = blockIdx.y;
  const int part = blockIdx.z % parts, qc = blockIdx.z / parts;
  const int N = Nkv * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool on = DP != 128 || lane * DL < D;  // the lane's dims lie inside the row
  // the lane's K/V offset in a ring row: past D, the row's first dims (finite
  // values that meet q = 0, and an O the lane never stores)
  const int loff = on ? lane * DL : 0;

  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);             // [stages][unit][D]
  T* vs = ks + geo.stages * geo.unit * D;         // [stages][unit][D]
  float* pm = reinterpret_cast<float*>(smem);     // after the walk: m [NWC][QPW], l, o [NWC][QPW][D]
  float* pl = pm + NWC * QPW;
  float* po = pl + NWC * QPW;
  const int bytes_ring = geo.bytes - MAXP * 4 - 2 * geo.stages * 8;
  int* tbl = reinterpret_cast<int*>(smem + bytes_ring);  // the part's table entries
  const uint32_t full0 = smem_addr(tbl + MAXP), empty0 = full0 + 8 * geo.stages;

  // this part's pages [p0, p1) of the row's np, cut from the row's length
  const int len = min(max(lengths[b * length_stride], 0), P * bs);
  const int np = (len + bs - 1) / bs;
  const int p0 = (int)((long long)np * part / parts), p1 = (int)((long long)np * (part + 1) / parts);
  if (tid == 0) {
    for (int s = 0; s < geo.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWC);  // every consumer warp releases every stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < p1 - p0; j += THREADS) tbl[j] = table[(size_t)b * P + p0 + j];
  __syncthreads();

  if (warp == NWC) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      int i = 0;
      for (int pi = p0; pi < p1; ++pi) {
        const int rows_page = min(bs, len - pi * bs);
        const size_t page = (size_t)tbl[pi - p0] * Nkv + h;
        for (int r0 = 0; r0 < rows_page; r0 += geo.unit, ++i) {
          const int s = i % geo.stages;
          const uint32_t full = full0 + 8 * s, bytes = min(geo.unit, rows_page - r0) * D * ES;
          mbar_wait(empty0 + 8 * s, ((i / geo.stages) & 1) ^ 1);
          mbar_expect_tx(full, 2 * bytes);
          const size_t off = (page * bs + r0) * D;
          bulk_load(smem_addr(ks + (size_t)s * geo.unit * D), kc + off, bytes, full);
          bulk_load(smem_addr(vs + (size_t)s * geo.unit * D), vc + off, bytes, full);
        }
      }
    }
    return;
  }

  // ---- the consumer warps: query group qg, key slice kslice of each unit ----
  const int qb0 = qc * NWC * QPW;
  const int nq = min(G * C - qb0, NWC * QPW);
  const int QG = (nq + QPW - 1) / QPW, KS = NWC / QG;
  const int qg = warp % QG, kslice = warp / QG;
  const bool active = kslice < KS;
  float qr[QPW][DL], m[QPW], l[QPW], acc[QPW][DL];
  float sl[QPW];  // the queries' ALiBi slopes in exp2 units
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int j = qb0 + qg * QPW + i;
    sl[i] = ALIBI && j < qb0 + nq ? alibi_slope(slopes, h * G + j % G) : 0.f;
    if (active && j < qb0 + nq && on) {
      lia::load_vec<DL>(q + (((size_t)b * C + j / G) * N + h * G + j % G) * D + lane * DL, qr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < DL; ++e) qr[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      qr[i][e] *= sscale;
      acc[i][e] = 0.f;
    }
    m[i] = LIA_NEG_INF;
    l[i] = 0.f;
  }

  int it = 0;
  for (int pi = p0; pi < p1; ++pi) {
    const int rows_page = min(bs, len - pi * bs);
    for (int r0 = 0; r0 < rows_page; r0 += geo.unit, ++it) {
      const int s = it % geo.stages, rows = min(geo.unit, rows_page - r0);
      mbar_wait(full0 + 8 * s, (it / geo.stages) & 1);
      const T* K = ks + (size_t)s * geo.unit * D;
      const T* V = vs + (size_t)s * geo.unit * D;
      if (active) {
        for (int k0 = kslice; k0 < rows; k0 += KS * KT) {
          float kx[KT][DL], vx[KT][DL];
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            const int key = min(k0 + kk * KS, rows - 1);  // past the unit: a valid row, masked below
            lia::load_vec<DL>(K + key * D + loff, kx[kk]);
            lia::load_vec<DL>(V + key * D + loff, vx[kk]);
          }
#pragma unroll
          for (int i = 0; i < QPW; ++i) {
            float sc[KT];
            float mt = LIA_NEG_INF;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
              float dot = 0.f;
#pragma unroll
              for (int e = 0; e < DL; ++e) dot = fmaf(qr[i][e], kx[kk][e], dot);
              sc[kk] = lia::warp_sum(dot);
              if constexpr (ALIBI) sc[kk] = fmaf(sl[i], (float)(pi * bs + r0 + k0 + kk * KS - len), sc[kk]);
              if (k0 + kk * KS < rows) mt = fmaxf(mt, sc[kk]);
            }
            const float m_new = fmaxf(m[i], mt);
            const float alpha = exp2f(m[i] - m_new);
            float psum = 0.f, pv[DL];
#pragma unroll
            for (int e = 0; e < DL; ++e) pv[e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
              if (k0 + kk * KS < rows) {
                const float p = exp2f(sc[kk] - m_new);
                psum += p;
#pragma unroll
                for (int e = 0; e < DL; ++e) pv[e] = fmaf(p, vx[kk][e], pv[e]);
              }
            }
            l[i] = l[i] * alpha + psum;
#pragma unroll
            for (int e = 0; e < DL; ++e) acc[i][e] = acc[i][e] * alpha + pv[e];
            m[i] = m_new;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
  }

  // the warps' partials, through the (now idle) ring
  named_sync(1, NWC * 32);
  if (active) {
#pragma unroll
    for (int i = 0; i < QPW; ++i) {
      if (lane == 0) {
        pm[warp * QPW + i] = m[i];
        pl[warp * QPW + i] = l[i];
      }
      if (on)
#pragma unroll
        for (int e = 0; e < DL; ++e) po[(warp * QPW + i) * D + lane * DL + e] = acc[i][e];
    }
  }
  named_sync(1, NWC * 32);
  if (!active) return;
  const size_t rows_all = (size_t)gridDim.y * C * N;
#pragma unroll
  for (int i = 0; i < QPW; ++i) {
    const int j = qb0 + qg * QPW + i;
    if (i % KS != kslice || j >= qb0 + nq) continue;
    float M = LIA_NEG_INF, L = 0.f, o[DL];
    for (int x = 0; x < KS; ++x) M = fmaxf(M, pm[(qg + QG * x) * QPW + i]);
#pragma unroll
    for (int e = 0; e < DL; ++e) o[e] = 0.f;
    for (int x = 0; x < KS; ++x) {
      const int w = (qg + QG * x) * QPW + i;
      const float a = exp2f(pm[w] - M);
      L += pl[w] * a;
      if (on)
#pragma unroll
        for (int e = 0; e < DL; ++e) o[e] = fmaf(po[w * D + lane * DL + e], a, o[e]);
    }
    const int c = j / G;
    const size_t row = ((size_t)b * C + c) * N + h * G + j % G;
    if (parts == 1) {
      const size_t fresh = ((size_t)b * Nkv + h) * C * D;
      finish<T, DL, ALIBI>(M, L, o, qr[i], kf ? kf + fresh : nullptr, vf ? vf + fresh : nullptr, c, out + row * D,
                           lane, D, on, sl[i]);
    } else {
      float* wo = ws + ((size_t)part * rows_all + row) * D + lane * DL;
      if (on)
#pragma unroll
        for (int e = 0; e < DL; ++e) wo[e] = o[e];
      if (lane == 0) {
        ws[(size_t)parts * rows_all * D + part * rows_all + row] = M;
        ws[(size_t)parts * rows_all * (D + 1) + part * rows_all + row] = L;
      }
    }
  }
}

// The parts' partials of each query row merged (one warp a row), then the fresh
// keys 0..c, normalised and written out.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * MERGE_WARPS)
merge_kernel(const float* __restrict__ ws, const T* __restrict__ q, const T* __restrict__ kf,
             const T* __restrict__ vf, T* __restrict__ out, int parts, int rows, int C, int N, int G, int D,
             float sscale, const float* __restrict__ slopes) {
  constexpr int DL = DP / 32;
  if (DP != 128) D = DP;  // only width 128 takes several D: the others' D is known at compile time
  const int row = blockIdx.x * MERGE_WARPS + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bool on = DP != 128 || lane * DL < D;
  const float* ws_m = ws + (size_t)parts * rows * D;
  const float* ws_l = ws_m + (size_t)parts * rows;
  float M = LIA_NEG_INF, L = 0.f, o[DL];
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
  float qr[DL] = {};
  if (on) lia::load_vec<DL>(q + (size_t)row * D + lane * DL, qr);
#pragma unroll
  for (int e = 0; e < DL; ++e) qr[e] *= sscale;
  const int n = row % N, c = (row / N) % C, b = row / (N * C);
  const size_t fresh = ((size_t)b * (N / G) + n / G) * C * D;
  if (slopes)
    finish<T, DL, true>(M, L, o, qr, kf ? kf + fresh : nullptr, vf ? vf + fresh : nullptr, c, out + (size_t)row * D,
                        lane, D, on, alibi_slope(slopes, n));
  else
    finish<T, DL, false>(M, L, o, qr, kf ? kf + fresh : nullptr, vf ? vf + fresh : nullptr, c, out + (size_t)row * D,
                         lane, D, on, 0.f);
}

template <typename T, int DP, int QPW, bool ALIBI>
int launch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc, const void* table,
           const void* lengths, int length_stride, void* out, void* ws, int parts, int B, int C, int N, int Nkv,
           int P, int bs, int D, float sscale, const float* slopes, cudaStream_t stream) {
  const Geo geo(sizeof(T), D, bs, QPW);
  auto kern = paged_kernel<T, DP, QPW, ALIBI>;
  static const cudaError_t attr = [&] {  // once an instantiation: the launch sits on the decode path;
    // the SM keeps its largest carveout, for as many blocks as the registers allow
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 96 * 1024);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  if (geo.bytes > 96 * 1024) return (int)cudaErrorInvalidValue;
  const int G = N / Nkv, qchunks = (G * C + NWC * QPW - 1) / (NWC * QPW);
  const dim3 grid(Nkv, B, parts * qchunks);
  kern<<<grid, THREADS, geo.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(table), static_cast<const int*>(lengths), length_stride,
      static_cast<T*>(out), static_cast<float*>(ws), parts, C, G, Nkv, P, bs, D, sscale, slopes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const int rows = B * C * N;
  merge_kernel<T, DP><<<(rows + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const T*>(q), static_cast<const T*>(kf), static_cast<const T*>(vf),
      static_cast<T*>(out), parts, rows, C, N, G, D, sscale, slopes);
  return (int)cudaGetLastError();
}

// Queries a consumer warp holds: 1 where a block's G * C queries are at most
// the warps (the warps then split each unit's keys), else 4.
inline int queries_a_warp(int G, int C) { return G * C <= NWC ? 1 : 4; }

// Type, head-dim and queries-a-warp dispatch. D must be 64, 80, 96, 112, 128 or 256, C >= 1,
// slopes ALiBi's (fp32 [N]) or null,
// parts >= 1 with ceil(P / parts) <= MAXP, and parts > 1 needs a workspace of
// parts * B * C * N * (D + 2) floats. Returns a cudaError_t value, 0 on a
// successful launch.
inline int dispatch(const void* q, const void* kf, const void* vf, const void* kc, const void* vc,
                    const void* table, const void* lengths, int length_stride, void* out, void* ws, int parts, int B,
                    int C, int N, int Nkv, int P, int bs, int D, float sscale, int is_bf16, const void* slopes,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int DP = padded_dim(D);
  if (B < 1 || Nkv <= 0 || N % Nkv != 0 || C < 1 || P < 1 || bs < 1 || parts < 1 || (parts > 1 && !ws) ||
      (P + parts - 1) / parts > MAXP || DP == 0 ||
      reinterpret_cast<uintptr_t>(kc) % 16 != 0 || reinterpret_cast<uintptr_t>(vc) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const bool four = queries_a_warp(N / Nkv, C) == 4;
  auto run = [&](auto kern) {
    return kern(q, kf, vf, kc, vc, table, lengths, length_stride, out, ws, parts, B, C, N, Nkv, P, bs, D, sscale,
                static_cast<const float*>(slopes), st);
  };
  auto by_width = [&](auto type, auto alibi) {
    using T = decltype(type);
    constexpr bool A = decltype(alibi)::value;
    if (DP == 256) return four ? run(&launch<T, 256, 4, A>) : run(&launch<T, 256, 1, A>);
    if (DP == 128) return four ? run(&launch<T, 128, 4, A>) : run(&launch<T, 128, 1, A>);
    return four ? run(&launch<T, 64, 4, A>) : run(&launch<T, 64, 1, A>);
  };
  if (is_bf16)
    return slopes ? by_width(__nv_bfloat16{}, std::true_type{}) : by_width(__nv_bfloat16{}, std::false_type{});
  return slopes ? by_width(0.f, std::true_type{}) : by_width(0.f, std::false_type{});
}

}  // namespace lia_paged
