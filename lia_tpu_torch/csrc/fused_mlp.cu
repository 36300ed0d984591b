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
// Design: a persistent grid of one block an SM, launched cooperatively (all
// blocks resident), in two phases over one ring of 16 KB TMA stages. One
// producer warp issues the copies; eight consumer warps compute, so the mma
// work of a stage stays well under the time its bytes take to arrive.
//   - Phase 1 (up): F is split evenly over the blocks in granules of 16 columns
//     (Llama-3-8B's 896 granules: 6 or 7 a block). Each block copies its rows
//     of x into shared memory (one TMA box: 16 rows of H, fewer where 16 do
//     not fit) and normalizes them there once, as bf16. The producer streams
//     all of the block's columns (up to 16 granules a pass) of w1 (and wg), ks
//     rows of H a stage (six stages at H 4096: ~90 KB in flight an SM). One 3-D
//     TMA box a matrix a stage takes the granules side by side, so each row of
//     the weight is read as one run of the block's columns, and lays them out
//     granule by granule, 32-byte swizzled, for conflict-free ldmatrix. The
//     consumers take every eighth 8-column slice: mma.sync m16n8k16 (bf16 in,
//     fp32 sums) with the A fragments from the normalized rows; the
//     activation, rounded to bf16, goes to a global [R, F] scratch.
//   - A grid barrier (a counter the last block leaves zero: no memset, so the
//     launch can be captured in a CUDA graph). The producer does not wait at
//     it: they go on to phase 2's first stages.
//   - Phase 2 (down): H is cut into tiles of 32 columns, one tile a block
//     (H 4096: 128 tiles). A block streams its tile's w2 column slice over all
//     of F, 256 rows a stage (one TMA box), while the activation comes in by
//     TMA in chunks of F (two buffers in the rows' place). Its eight warps take
//     every eighth 16-row step of each stage, and their [16, 32] fp32 partials
//     add in shared memory in a fixed order before b2, the residual and the
//     one rounding. Nothing is added with atomics: the sum's order is fixed,
//     so a launch gives the same bits every run.
// Rows past 16 (up to the wrapper's 256) go in chunks of rows side by side:
// in phase 1 the grid splits into groups of blocks, one chunk of rows a group,
// each group splitting F; in phase 2 a tile's chunks go to neighbouring
// blocks. The blocks that read the same weights run at once, so the L2
// serves them after the first.
// Measured on the H100 (Llama-3-8B's SwiGLU, 16 rows): phase 1 streams at
// ~73% of the card's bandwidth and phase 2 at ~80%; a deeper ring, wider
// granules and 2-D boxes did not move phase 1 (the consumers' mma work is
// hidden: without it phase 1 takes as long).
#include "hopper.cuh"

namespace {

using namespace lia;

constexpr int NWC = 8;                    // consumer warps
constexpr int THREADS = 32 * (NWC + 1);   // and one producer warp
constexpr int KB = 256;                   // F rows of a phase-2 stage (one box)
constexpr int UW = 32;                    // H columns of a phase-2 tile
constexpr int GW = 16;                    // F columns of a granule, phase 1's grain (32-byte rows)
constexpr int TPG = GW / 8;               // 8-column mma slices a granule
constexpr int PG = 256 / GW;              // granules of a phase-1 pass (a piece): 256 columns
constexpr int TPW = 256 / 8 / NWC;        // a warp's 8-column slices of a piece (at most)
constexpr int SPW = KB / 16 / NWC;        // a warp's 16-row steps of a phase-2 stage
constexpr int STAGE_BYTES = KB * UW * 2;  // 16 KB: a w2 box, or w1 + wg boxes (8 KB each at most)
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;        // an H100 block's dynamic shared memory
constexpr int MAX_H = 16384;              // x's TMA box: at most 256 slices of 64 columns
constexpr int RED_BYTES = NWC * 16 * UW * 4;  // phase 2's partials
constexpr int ACT_MIN = 2 * 16 * KB * 2;  // two activation buffers of one stage's F
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8 + 32 + 128;  // the ring's full and empty barriers, the
                                                          // rows' and the two activation buffers' barriers,
                                                          // the rows' means and reciprocal deviations

enum Act { RELU = 0, GELU = 1, GELU_TANH = 2, SWIGLU = 3 };

// Shared memory of a block: [1 KB alignment slack][ring][rows][barriers]. The
// rows: in phase 1 a chunk of rch rows of x (16, or the most of 8, 4, 2, 1
// that fit beside the ring: 16 up to H 5120, 8 up to H 10240, 4 up to
// MAX_H), as [H / 64][rch][64] 128-byte swizzled, normalized in place; in
// phase 2 two buffers of the activation, each [cf / 64][16][64] swizzled
// alike (cf columns of F), and the warps' partials past them.
struct Geo {
  int rch, xs_bytes, cf, stages, bytes;
  __host__ __device__ explicit Geo(int H) {
    const int avail = SMEM_LIMIT - 1024 - BAR_BYTES - MIN_STAGES * STAGE_BYTES;
    rch = 16;
    while (rch > 0 && rch * H * 2 > avail) rch /= 2;
    const int need = ACT_MIN + RED_BYTES;
    xs_bytes = ((rch * H * 2 > need ? rch * H * 2 : need) + 1023) / 1024 * 1024;
    cf = (xs_bytes - RED_BYTES) / (2 * 16 * 2) / KB * KB;
    stages = (SMEM_LIMIT - 1024 - BAR_BYTES - xs_bytes) / STAGE_BYTES;
    stages = stages > MAX_STAGES ? MAX_STAGES : stages;
    bytes = 1024 + stages * STAGE_BYTES + xs_bytes + BAR_BYTES;
  }
};

// Phase 1's split of the grid over chunks of rows and F: `groups` chunks of
// rows side by side (all of them up to the blocks: past 16 rows the blocks of
// one F share read the same weights at about the same time, and the L2 serves
// all but the first), each over `shares` blocks that split F evenly.
struct Split {
  int groups, shares;
  __host__ __device__ Split(int chunks, int nb) {
    groups = chunks < nb ? chunks : nb;
    shares = nb / groups;
  }
};

// Byte offset of row r's 16-byte piece j (columns 8 j .. 8 j + 7) in the rows:
// the box's 128-byte line (j / 8) * rch + r, its pieces swizzled by the
// line's place in its 1 KB (the rows start on 1 KB), as TMA writes them.
__device__ __forceinline__ uint32_t xs_off(int rch, int r, int j) {
  const int line = (j >> 3) * rch + r;
  return line * 128 + (((j & 7) ^ (line & 7)) << 4);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// Two 8x8 bf16 matrices, transposed on the way: lanes 0-7 give the rows of the
// first, lanes 8-15 those of the second (a B fragment from a row-major [k][n] tile).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// Byte offset of 16-byte chunk `c` of row `r` in a box that TMA wrote with
// rows of 64 bytes (SWIZZLE_64B) or of 32 bytes (SWIZZLE_32B).
__device__ __forceinline__ uint32_t swz64(int r, int c) { return r * 64 + 16 * (c ^ ((r >> 1) & 3)); }
__device__ __forceinline__ uint32_t swz32(int r, int c) { return r * 32 + 16 * (c ^ ((r >> 2) & 1)); }
// Both patterns repeat every 16 rows: row 16 k + r sits 16 k rows past row r.

// The tensor maps. w1 and wg as [granule][H row][16 columns] boxes of cnt[i]
// granules by ks rows (three granule counts: a full piece and the two last
// pieces a block can have); w2 [F, H] as 256 x 32 boxes; x as [H / 64][rch
// rows][64 columns] boxes and the activation as [cf / 64][16 rows][64
// columns] boxes (rows past R, and columns past F, read as zeros).
struct Maps {
  CUtensorMap w1[3], wg[3], w2, x, act;
  int cnt[3], ks;
};

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

__device__ __forceinline__ uint32_t ld_acquire(const unsigned int* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <bool RMS, bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
fused_mlp_kernel(const __grid_constant__ Maps maps,          // w1, wg (GATED) [H, F]; w2 [F, H]
                 const __nv_bfloat16* __restrict__ x,        // [R, H]
                 const __nv_bfloat16* __restrict__ lnw,      // [H]
                 const __nv_bfloat16* __restrict__ lnb,      // [H] or null
                 const __nv_bfloat16* __restrict__ b1,       // [F] or null
                 const __nv_bfloat16* __restrict__ b2,       // [H] or null
                 __nv_bfloat16* __restrict__ out,            // [R, H]
                 __nv_bfloat16* __restrict__ act_ws,         // [R, F] scratch: the activation
                 unsigned int* __restrict__ bar,             // [2] grid barrier, zero between launches
                 int R, int H, int F, int act, float eps) {
  extern __shared__ unsigned char smem_raw[];
  const Geo geo(H);
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t xs = ring + geo.stages * STAGE_BYTES;   // the rows (bf16); phase 2: [NWC][16][32] fp32
  unsigned char* xs_ptr = smem_raw + (xs - raw);
  const uint32_t full0 = xs + geo.xs_bytes, empty0 = full0 + 8 * MAX_STAGES, xbar = empty0 + 8 * MAX_STAGES;
  const uint32_t abar0 = xbar + 8;  // the activation buffers' barriers (two)
  float* stat = reinterpret_cast<float*>(smem_raw + (abar0 + 24 - raw));  // [2][16]: mean, 1 / deviation
  const int S = geo.stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = F / GW, nb = gridDim.x;
  const int nc1 = (R + geo.rch - 1) / geo.rch, nc2 = (R + 15) / 16;
  const Split sp(nc1, nb);
  const int grp = blockIdx.x % sp.groups, share = blockIdx.x / sp.groups;  // chunks grp, grp + groups, ...
  const int g0 = share < sp.shares ? (int)((long long)ng * share / sp.shares) : 0;
  const int g1 = share < sp.shares ? (int)((long long)ng * (share + 1) / sp.shares) : 0;
  const int ntiles = H / UW, nf = (F + KB - 1) / KB, ks = maps.ks;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, NWC);  // every consumer warp releases every stage
    }
    mbar_init(xbar, 1);
    mbar_init(abar0, 1);
    mbar_init(abar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWC) {  // the producer warp: one lane issues every copy
    if (lane == 0) {
      prefetch_tensormap(&maps.w2);
      int i = 0;
      auto stage = [&](uint32_t bytes) {  // the next stage, once its consumers released it
        const int s = i % S;
        mbar_wait(empty0 + 8 * s, ((i / S) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, bytes);
        return s;
      };
      for (int rc = grp; rc < nc1; rc += sp.groups)
        for (int p = g0; p < g1; p += PG) {
          const int n = min(PG, g1 - p), mi = n == maps.cnt[0] ? 0 : n == maps.cnt[1] ? 1 : 2;
          const uint32_t box = n * ks * GW * 2;
          for (int k = 0; k < H; k += ks, ++i) {
            const int s = stage(GATED ? 2 * box : box);
            const uint32_t dst = ring + s * STAGE_BYTES, full = full0 + 8 * s;
            tma_load(dst, &maps.w1[mi], full, 0, k, p);
            if (GATED) tma_load(dst + STAGE_BYTES / 2, &maps.wg[mi], full, 0, k, p);
          }
        }
      for (int u = blockIdx.x; u < ntiles * nc2; u += nb)
        for (int f = 0; f < F; f += KB, ++i) {
          const int s = stage(STAGE_BYTES);  // rows past F read as zeros, and count
          tma_load(ring + s * STAGE_BYTES, &maps.w2, full0 + 8 * s, u / nc2 * UW, f);
        }
    }
    return;
  }

  // ---- the consumer warps ----
  const int gq = lane >> 2, tq = lane & 3;
  int it = 0;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  };

  // phase 1: for each of its chunks of rch rows (the n-th: the rows' barrier's
  // n-th phase), copy them in (one TMA box) and normalize them in place, then
  // the pieces
  for (int rc = grp, n = 0; rc < nc1; rc += sp.groups, ++n) {
    const int r0 = rc * geo.rch, rows = min(geo.rch, R - r0);
    named_sync(1, NWC * 32);  // the previous chunk's rows are read
    if (tid == 0) {
      fence_proxy_async();  // those reads and writes before the copy's writes
      mbar_expect_tx(xbar, geo.rch * H * 2);
      tma_load(xs, &maps.x, xbar, 0, r0, 0);
    }
    mbar_wait(xbar, n & 1);
    for (int r = warp; r < rows; r += NWC) {  // each row's statistics: warp w rows w, w + 4, ...
      float s = 0.f;
      for (int j = lane; j < H / 8; j += 32) {
        float v[8];
        lia::load_vec<8>(reinterpret_cast<const __nv_bfloat16*>(xs_ptr + xs_off(geo.rch, r, j)), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += RMS ? v[e] * v[e] : v[e];
      }
      s = lia::warp_sum(s) / H;
      float mu = 0.f, rs;
      if (RMS) {
        rs = rsqrtf(s + eps);
      } else {
        mu = s;
        float ss = 0.f;
        for (int j = lane; j < H / 8; j += 32) {
          float v[8];
          lia::load_vec<8>(reinterpret_cast<const __nv_bfloat16*>(xs_ptr + xs_off(geo.rch, r, j)), v);
#pragma unroll
          for (int e = 0; e < 8; ++e) ss += (v[e] - mu) * (v[e] - mu);
        }
        rs = rsqrtf(lia::warp_sum(ss) / H + eps);
      }
      if (lane == 0) stat[r] = mu, stat[16 + r] = rs;
    }
    named_sync(1, NWC * 32);
    for (int j = tid; j < H / 8; j += NWC * 32) {  // normalize: thread t columns 8 t.., every row
      float sc[8], bi[8] = {};
      lia::load_vec<8>(lnw + 8 * j, sc);
      if (lnb) lia::load_vec<8>(lnb + 8 * j, bi);
      for (int r = 0; r < rows; ++r) {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(xs_ptr + xs_off(geo.rch, r, j));
        const float mu = stat[r], rs = stat[16 + r];
        float v[8];
        lia::load_vec<8>(dst, v);
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16_rn((RMS ? v[e] : v[e] - mu) * rs * sc[e] + bi[e]);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      }
    }
    named_sync(1, NWC * 32);  // the rows are normalized

    // A fragment rows lane & 15 (rows past a chunk of fewer than 16 read its
    // rows again, masked), k half lane >> 4; fragment rows past the chunk read as zero
    const int arow = (lane & 15) % geo.rch;
    const bool lo_ok = gq < rows, hi_ok = gq + 8 < rows;
    for (int p = g0; p < g1; p += PG) {  // a piece of up to 256 columns: 8-column slices j = warp + NWC i
      const int nt = TPG * min(PG, g1 - p);
      float up[TPW][4] = {}, gt[TPW][4] = {};
      uint32_t boff[TPW];  // slice j's B rows in a stage, at its first 16-row step
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int j = warp + NWC * i;
        boff[i] = (j / TPG) * ks * GW * 2 + swz32(lane & 15, j % TPG);  // granule j / TPG
      }
      for (int k = 0; k < H; k += ks, ++it) {
        const int s = it % S;
        mbar_wait(full0 + 8 * s, (it / S) & 1);
        const uint32_t w = ring + s * STAGE_BYTES;
        for (int kk = 0; kk < ks; kk += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, xs + xs_off(geo.rch, arow, ((k + kk) >> 3) + (lane >> 4)));
          if (!lo_ok) a[0] = a[2] = 0u;
          if (!hi_ok) a[1] = a[3] = 0u;
#pragma unroll
          for (int i = 0; i < TPW; ++i) {
            if (warp + NWC * i >= nt) continue;
            const uint32_t b = w + boff[i] + kk * GW * 2;
            uint32_t b0, b1v;
            ldmatrix_x2_trans(b0, b1v, b);
            mma_bf16(up[i], a, b0, b1v);
            if (GATED) {
              ldmatrix_x2_trans(b0, b1v, b + STAGE_BYTES / 2);
              mma_bf16(gt[i], a, b0, b1v);
            }
          }
        }
        release(s);
      }
#pragma unroll
      for (int i = 0; i < TPW; ++i) {  // the activation of this warp's slices, rounded to bf16
        const int j = warp + NWC * i;
        if (j >= nt) continue;
        const int col = p * GW + j * 8 + 2 * tq;
        const float2 bv = b1 ? lia::load_pair(b1 + col) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = gq + 8 * h;
          if (row >= rows) continue;
          const __nv_bfloat162 v = __floats2bfloat162_rn(activate(act, up[i][2 * h] + bv.x, gt[i][2 * h]),
                                                         activate(act, up[i][2 * h + 1] + bv.y, gt[i][2 * h + 1]));
          *reinterpret_cast<__nv_bfloat162*>(act_ws + (size_t)(r0 + row) * F + col) = v;
        }
      }
    }
  }

  // the grid barrier: every block's activation is written (the producer goes on)
  asm volatile("fence.proxy.async.global;\n" ::: "memory");  // the writes, before TMA reads them
  named_sync(1, NWC * 32);
  if (tid == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (ld_acquire(bar) < (unsigned)nb) __nanosleep(64);
    __threadfence();
    if (atomicAdd(bar + 1, 1u) == (unsigned)nb - 1) {  // the last block past it leaves both zero
      bar[0] = 0u;
      bar[1] = 0u;
    }
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  named_sync(1, NWC * 32);

  // phase 2: tile t's 32 columns of w2 over all of F, for each chunk of 16
  // rows; the activation's chunks q = 0, 1, ... of cf columns alternate
  // between the two buffers, thread 0 copying chunk q + 2 in once chunk q is read
  const int na = (F + geo.cf - 1) / geo.cf, spc = geo.cf / KB;  // chunks a pass, stages a chunk
  const uint32_t abuf = xs, abytes = 16 * geo.cf * 2;
  float* red = reinterpret_cast<float*>(xs_ptr + 2 * abytes);  // [NWC][16][32]
  int q = 0;  // chunks copied in so far, over all passes
  auto fetch = [&](int r0, int c) {  // chunk c of rows r0.. into buffer q % 2
    const uint32_t b = abar0 + 8 * (q & 1);
    mbar_expect_tx(b, abytes);
    tma_load(abuf + (q & 1) * abytes, &maps.act, b, 0, r0, c * geo.cf / 64);
    ++q;
  };
  int qr = 0;  // chunks read so far
  for (int u = blockIdx.x; u < ntiles * nc2; u += nb) {  // units (tile t, rows rc): a tile's chunks side by side
    const int t = u / nc2, rc = u % nc2;
    const int r0 = rc * 16, rows = min(16, R - r0);
    if (tid == 0) {
      fetch(r0, 0);
      if (na > 1) fetch(r0, 1);
    }
    float acc[4][4] = {};
    uint32_t a_base = 0;
    const uint32_t bsw = swz64(lane & 15, 0) - (lane & 15) * 64;  // row lane % 16's chunk swizzle
    for (int fs = 0; fs < nf; ++fs, ++it) {
      const int c = fs / spc, cs = fs % spc;  // the stage's chunk, and its stage in the chunk
      if (cs == 0) {  // a new chunk: wait for its copy
        a_base = abuf + (qr & 1) * abytes;
        mbar_wait(abar0 + 8 * (qr & 1), (qr >> 1) & 1);
      }
      const int s = it % S, nk = min(KB, F - fs * KB) / 16;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      const uint32_t w = ring + s * STAGE_BYTES;
      const int arow = lane & 15;
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int kk = warp + NWC * j;  // this warp's 16-row steps of the stage
        if (kk >= nk) continue;
        uint32_t a[4];
        ldmatrix_x4(a, a_base + xs_off(16, arow, cs * (KB / 8) + kk * 2 + (lane >> 4)));
        const uint32_t b = w + (kk * 16 + (lane & 15)) * 64;  // F row kk * 16 + lane % 16 of the stage
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t b0, b1v;
          ldmatrix_x2_trans(b0, b1v, b + (16 * nt ^ bsw));
          mma_bf16(acc[nt], a, b0, b1v);
        }
      }
      release(s);
      if (cs == spc - 1 || fs == nf - 1) {  // the chunk is read: its buffer takes chunk c + 2
        named_sync(1, NWC * 32);
        ++qr;
        if (tid == 0 && c + 2 < na) {
          fence_proxy_async();
          fetch(r0, c + 2);
        }
      }
    }
    // the warps' partials add in a fixed order; then b2, the residual, one rounding
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(warp * 16 + gq + 8 * (e >> 1)) * UW + nt * 8 + 2 * tq + (e & 1)] = acc[nt][e];
    named_sync(1, NWC * 32);
    const int row = tid / (UW / 2), c0 = (tid % (UW / 2)) * 2;  // two columns a thread
    if (row < rows) {
      const int h0 = t * UW + c0;
      const size_t off = (size_t)(r0 + row) * H + h0;
      float2 sum = make_float2(0.f, 0.f);
#pragma unroll
      for (int ww = 0; ww < NWC; ++ww) {
        sum.x += red[(ww * 16 + row) * UW + c0];
        sum.y += red[(ww * 16 + row) * UW + c0 + 1];
      }
      const float2 xv = lia::load_pair(x + off);
      const float2 bv = b2 ? lia::load_pair(b2 + h0) : make_float2(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(xv.x + (sum.x + bv.x), xv.y + (sum.y + bv.y));
    }
    named_sync(1, NWC * 32);  // the partials are read
  }
}

// w2, a row-major bf16 [F, H], as boxes of 32 columns x 256 rows, 64-byte swizzled.
inline bool down_map(CUtensorMap* map, const void* ptr, int F, int H) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)F};
  const cuuint64_t strides[1] = {(cuuint64_t)H * 2};
  const cuuint32_t box[2] = {(cuuint32_t)UW, (cuuint32_t)KB};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w1 or wg, a row-major bf16 [H, F], viewed as [granule][H row][16 columns]:
// boxes of `cnt` granules by `ks` rows, each granule's rows 32-byte swizzled.
inline bool up_map(CUtensorMap* map, const void* ptr, int H, int F, int cnt, int ks) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)GW, (cuuint64_t)H, (cuuint64_t)(F / GW)};
  const cuuint64_t strides[2] = {(cuuint64_t)F * 2, (cuuint64_t)GW * 2};
  const cuuint32_t box[3] = {(cuuint32_t)GW, (cuuint32_t)ks, (cuuint32_t)cnt};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major bf16 [R, cols] (x, or the activation), viewed as [cols / 64][row]
// [64 columns]: boxes of `rows` rows by `width` columns, 128-byte swizzled.
inline bool row_map(CUtensorMap* map, const void* ptr, int R, int cols, int rows, int width) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {64, (cuuint64_t)R, (cuuint64_t)(cols / 64)};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, 128};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, (cuuint32_t)(width / 64)};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Granules of a block's last piece of n (n >= 1).
inline int last_piece(int n) { return n - PG * ((n - 1) / PG); }

// H rows of a phase-1 stage: the most of 128, 64, 32 and 16 that keep a
// piece's boxes (w1, and wg where gated) within a stage.
inline int stage_rows(int cnt, bool gated) {
  int ks = 128;
  while (ks > 16 && ks * cnt * GW * 2 * (gated ? 2 : 1) > STAGE_BYTES) ks /= 2;
  return ks;
}

// Blocks of the persistent grid: one an SM, at most one a granule or a tile.
inline int grid_blocks(int H, int F) {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!sms[dev] && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  const int work = F / GW > H / UW ? F / GW : H / UW;
  return work < sms[dev] ? work : sms[dev];
}

template <bool RMS, bool GATED>
int launch(const void* x, const void* lnw, const void* lnb, const void* w1, const void* b1, const void* wg,
           const void* w2, const void* b2, void* out, void* act_ws, void* bar, int R, int H, int F, int act,
           float eps, cudaStream_t stream) {
  auto kern = fused_mlp_kernel<RMS, GATED>;
  static const cudaError_t attr =  // once an instantiation: the launch sits on the decode path
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return (int)attr;
  const Geo geo(H);
  const int nb = grid_blocks(H, F);
  if (geo.rch < 1 || geo.stages < MIN_STAGES || geo.bytes > SMEM_LIMIT || nb < 1 || H > MAX_H || geo.cf / 64 > 256)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const Split sp((R + geo.rch - 1) / geo.rch, nb);
  const int ng = F / GW, nlo = ng / sp.shares, nhi = nlo + (ng % sp.shares != 0);
  maps.cnt[0] = nhi < PG ? nhi : PG;  // a full piece (or a block's only one)
  maps.cnt[1] = last_piece(nlo > 0 ? nlo : 1);
  maps.cnt[2] = last_piece(nhi);
  maps.ks = stage_rows(maps.cnt[0], GATED);
  if (!down_map(&maps.w2, w2, F, H) || !row_map(&maps.x, x, R, H, geo.rch, H) ||
      !row_map(&maps.act, act_ws, R, F, 16, geo.cf))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (!up_map(&maps.w1[i], w1, H, F, maps.cnt[i], maps.ks) ||
        (GATED && !up_map(&maps.wg[i], wg, H, F, maps.cnt[i], maps.ks)))
      return (int)cudaErrorInvalidValue;
  using B = const __nv_bfloat16*;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = geo.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;  // every block resident: the grid barrier needs it
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, maps, static_cast<B>(x), static_cast<B>(lnw), static_cast<B>(lnb),
      static_cast<B>(b1), static_cast<B>(b2), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(act_ws), static_cast<unsigned int*>(bar), R, H, F, act, eps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// act: 0 relu, 1 gelu (erf), 2 gelu_new (tanh), 3 SwiGLU (wg required);
// rms: RMSNorm, else LayerNorm; ln_bias, b1 and b2 may be null (ln_bias is
// added after the scale under either norm, as in the TPU kernel). act_ws is a
// bf16 scratch of >= R * F elements (no memset: every element read is written
// first), bar two uint32 counters, zero before the launch and left zero after
// it. Returns a cudaError_t value: 0 on a successful launch. The wrapper checks
// types, shapes and alignment: H % 128 == 0 and H <= 16384 (MAX_H), F % 64 ==
// 0, 16-byte aligned rows.
extern "C" int lia_fused_mlp(const void* x, const void* lnw, const void* lnb, const void* w1, const void* b1,
                             const void* wg, const void* w2, const void* b2, void* out, void* act_ws,
                             void* bar, int R, int H, int F, int act, int rms, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || H % 128 != 0 || H > MAX_H || F % 64 != 0 || act < RELU || act > SWIGLU || (act == SWIGLU) != (wg != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool gated = act == SWIGLU;
  if (rms && gated) return launch<true, true>(x, lnw, lnb, w1, b1, wg, w2, b2, out, act_ws, bar, R, H, F, act, eps, st);
  if (rms) return launch<true, false>(x, lnw, lnb, w1, b1, wg, w2, b2, out, act_ws, bar, R, H, F, act, eps, st);
  if (gated) return launch<false, true>(x, lnw, lnb, w1, b1, wg, w2, b2, out, act_ws, bar, R, H, F, act, eps, st);
  return launch<false, false>(x, lnw, lnb, w1, b1, wg, w2, b2, out, act_ws, bar, R, H, F, act, eps, st);
}

// Dynamic shared memory of a block at hidden size H, its ring stages and the
// rows one phase-1 pass normalizes (for the build report); and the blocks of
// the persistent grid on the current device.
extern "C" int lia_fused_mlp_smem_bytes(int H) { return Geo(H).bytes; }
extern "C" int lia_fused_mlp_stages(int H) { return Geo(H).stages; }
extern "C" int lia_fused_mlp_row_chunk(int H) { return Geo(H).rch; }
extern "C" int lia_fused_mlp_blocks(int H, int F) { return grid_blocks(H, F); }
