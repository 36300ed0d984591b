// Causal GQA flash attention over a left-padded prompt, bf16 in and out.
//
// Replaces lia_tpu/ops/pallas_attention.py:flash_attention_prefill (_flash_kernel).
// Same math: scores are bf16 dots with fp32 accumulation, scaled after the
// dot by scale*log2(e) so the online softmax runs in exp2 units; the
// probabilities are rounded to bf16 before P.V, as the TPU kernel casts them
// to V's dtype; out = acc / max(l, 1e-30). Validity is one contiguous range
// [start, S) per sequence, start = S - popcount(mask[b]), counted on the
// device.
//
// What bounds it on an H100: bytes. At OPT-6.7B b16 s256 the causal product
// is ~8.6 GFLOP per layer against ~134 MB of q/k/v/o (64 FLOP/byte, under the
// card's ~295 FLOP/byte balance point of bf16 tensor cores and HBM3), so the
// floor is ~40 us of memory traffic. Design: one block of four warps per
// (q tile, kv head, batch row), the tile's 64 query rows being the G query
// heads of that kv head at 64/G positions (no K/V replication); each warp owns
// 16 rows. Both products run on the tensor cores with mma.sync m16n8k16 (bf16
// in, fp32 accumulate): Q's fragments stay in registers, each 64-key K/V tile
// is staged in shared memory (rows padded by 16 bytes so fragment loads hit
// distinct banks), V's fragments come from ldmatrix.trans, and the score
// fragments are rounded to bf16 in registers to become P's A fragments. kv
// tiles before start // 64 or past the causal frontier are skipped. The
// tiles are loaded synchronously: a later PR overlaps the next tile's load
// (cp.async or TMA) and moves to wgmma.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 16 * WARPS;  // query rows per block (positions x G heads)
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 32 * WARPS;

template <int D>
struct Smem {
  static constexpr int STRIDE = D + 8;  // bf16 elements per row: 16 bytes of padding
  static constexpr size_t tile = sizeof(__nv_bfloat16) * 64 * STRIDE;
  static constexpr size_t bytes = 3 * tile;  // Q, K, V
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices, transposed on the way: lanes 0-7 give the rows of the
// first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,  // [B, S, N, D]
                     const __nv_bfloat16* __restrict__ k,  // [B, Nkv, S, D]
                     const __nv_bfloat16* __restrict__ v,  // [B, Nkv, S, D]
                     const uint8_t* __restrict__ input_mask,  // [B, S]
                     __nv_bfloat16* __restrict__ out,      // [B, S, N, D]
                     int S, int N, int Nkv, int G, float sscale, int window) {
  constexpr int ST = Smem<D>::STRIDE;
  constexpr int KS = D / 16;  // k-steps of Q.K^T over D
  constexpr int NT = BK / 8;  // 8-key score tiles per kv tile
  constexpr int DT = D / 8;   // 8-wide output tiles
  constexpr int CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + 64 * ST;
  __nv_bfloat16* Vs = Ks + 64 * ST;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int h = blockIdx.y, b = blockIdx.z;
  const int bqp = ROWS / G;  // query positions per block
  const int nrows = bqp * G;
  const int pos0 = blockIdx.x * bqp;
  const int start = S - lia::block_count_true(input_mask + (size_t)b * S, S);
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Q tile: row r is position pos0 + r / G, head h * G + r % G
  for (int idx = tid; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH;
    const int pos = pos0 + r / G;
    uint4 val = zero;
    if (r < nrows && pos < S)
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * S + pos) * N + h * G + r % G) * D + c * 8);
    *reinterpret_cast<uint4*>(Qs + r * ST + c * 8) = val;
  }
  __syncthreads();

  // this warp's rows: r0 = warp*16 + g and r0 + 8; Q's A fragments stay in registers
  const int r0 = warp * 16 + g;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* base = Qs + ks * 16 + 2 * t;
    qa[ks][0] = ld32(base + r0 * ST);
    qa[ks][1] = ld32(base + (r0 + 8) * ST);
    qa[ks][2] = ld32(base + r0 * ST + 8);
    qa[ks][3] = ld32(base + (r0 + 8) * ST + 8);
  }
  int qpos[2];
  bool rvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = pos0 + (r0 + 8 * i) / G;
    rvalid[i] = r0 + 8 * i < nrows;
  }
  float m[2] = {LIA_NEG_INF, LIA_NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  // kv tiles before start or past this q tile's last row are fully masked
  const int last_pos = min(pos0 + bqp, S) - 1;
  int j_lo = start / BK;
  if (window > 0) j_lo = max(j_lo, max(0, pos0 - window + 1) / BK);
  const int j_hi = last_pos / BK + 1;
  const size_t kv_base = ((size_t)b * Nkv + h) * S;

  for (int j = j_lo; j < j_hi; ++j) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * CH; idx += THREADS) {
      const int c = idx / CH, ch = idx % CH;
      const int kp = j * BK + c;
      uint4 kv = zero, vv = zero;
      if (kp < S) {
        kv = *reinterpret_cast<const uint4*>(k + (kv_base + kp) * D + ch * 8);
        vv = *reinterpret_cast<const uint4*>(v + (kv_base + kp) * D + ch * 8);
      }
      *reinterpret_cast<uint4*>(Ks + c * ST + ch * 8) = kv;
      *reinterpret_cast<uint4*>(Vs + c * ST + ch * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T: s[n] holds rows g / g+8, keys n*8 + 2t, +1
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * ST + ks * 16 + 2 * t;
        mma_bf16(s[n], qa[ks], ld32(kb), ld32(kb + 8));
      }

    // scale, mask, online softmax (rows are shared by the 4 lanes of a quad)
    float mt[2] = {LIA_NEG_INF, LIA_NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kp = j * BK + n * 8 + 2 * t + (e & 1);
        const bool masked = !rvalid[i] || kp > qpos[i] || kp < start || kp >= S ||
                            (window > 0 && kp <= qpos[i] - window);
        s[n][e] = masked ? LIA_NEG_INF : s[n][e] * sscale;
        mt[i] = fmaxf(mt[i], s[n][e]);
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
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[n][e] = p;
      }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: P's A fragments are the score fragments of two 8-key tiles,
    // rounded to bf16; V's B fragments come from ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = Vs + (kk * 16 + (lane & 15)) * ST;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + dt * 8);
        mma_bf16(o[dt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = r0 + 8 * i;
    if (!rvalid[i] || qpos[i] >= S) continue;
    const float den = fmaxf(li, 1e-30f);
    __nv_bfloat16* dst = out + (((size_t)b * S + qpos[i]) * N + h * G + r % G) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) = pack_bf16(o[dt][2 * i] / den, o[dt][2 * i + 1] / den);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int S, int N, int Nkv, float sscale, int window, cudaStream_t stream) {
  const int G = N / Nkv;
  const size_t smem = Smem<D>::bytes;
  auto kern = flash_prefill_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int bqp = ROWS / G;
  dim3 grid((S + bqp - 1) / bqp, Nkv, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), S, N, Nkv, G, sscale, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t value: 0 on a successful launch. The wrapper checks
// shapes, type and contiguity; D must be 64 or 128 and G = N / Nkv at most 64.
extern "C" int lia_flash_prefill(const void* q, const void* k, const void* v, const void* mask,
                                 void* out, int B, int S, int N, int Nkv, int D, float sscale,
                                 int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N % Nkv != 0 || N / Nkv > ROWS) return (int)cudaErrorInvalidValue;
  if (D == 128) return launch<128>(q, k, v, mask, out, B, S, N, Nkv, sscale, window, st);
  if (D == 64) return launch<64>(q, k, v, mask, out, B, S, N, Nkv, sscale, window, st);
  return (int)cudaErrorInvalidValue;
}
