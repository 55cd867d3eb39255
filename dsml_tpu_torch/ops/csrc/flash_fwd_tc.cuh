// The flash-attention forward's block body on Hopper's tensor cores, for
// bf16 q, k and v: the route flash_fwd_tile.cuh takes for bf16 in both
// kernel 1 (flash_fwd.cu) and kernel 4 (flash_stream.cu).
//
// What one block computes: out = softmax(q kᵀ · scale + mask) v with an
// online softmax in f32, and lse = m + log(l), for the 64-row q tile q0 of
// the (batch·head) row bh; the function, masks and numeric edges of
// flash_fwd_tile.cuh (masked scores -1e30, the running max starting at and
// floored at -1e20, the denominator floored at 1e-30; m and lse in natural-
// log units).
//
// Design (see flash_fwd.cu for the bound). 4 warps; warp w owns q rows
// 16w .. 16w + 15 of the tile, and a thread the rows g and g + 8 of those
// (g = lane / 4), in m16n8k16 fragment layout (mma_bf16.cuh).
//   - The q tile is copied once into shared memory and read once with
//     ldmatrix into A fragments that stay in registers for the whole walk.
//   - K and V tiles (64 rows) stream through a 2-stage cp.async ring: tile
//     t + 1 is in flight while tile t's products run, with one barrier per
//     tile. Ragged q and kv tails use the zero-fill form, so no padded
//     copy is made; rows must start 16-byte aligned (the wrapper checks).
//   - s = q kᵀ on mma.sync with k from ldmatrix as the B operand; the f32
//     C fragments of s become p in registers, rounded to bf16 as the A
//     fragment of acc += p v (to_a_frag), v through ldmatrix.trans: p never
//     touches shared memory.
//   - The causal mask is the loop bound (tiles past the diagonal are never
//     loaded) and is applied only on tiles that cross the diagonal or the
//     ragged kv tail; zero-filled K rows score 0, so they are masked too.
//   - Row max over the 4 lanes of a quad (shfl_xor 1, 2); each lane keeps
//     its own partial row sum, summed over the quad once at the end.
//   - p = exp2(s · scale · log2 e - m · log2 e): one FMA and one exp2.
// Every multiply-add outside the mmas is an explicit fmaf and every other
// product a __fmul_rn, so the compiler contracts the same operations in
// both kernels that inline this body.

#pragma once

#include "mma_bf16.cuh"

namespace flash_fwd_tc {

using mma_bf16::bf16;

constexpr int BM = mma_bf16::ROWS;  // q rows per block
constexpr int BN = mma_bf16::ROWS;  // kv rows per tile
constexpr int NT = mma_bf16::NT;
constexpr float NEG_INF = -1e30f;
constexpr float MAX_FLOOR = -1e20f;
constexpr float LOG2E = 1.4426950408889634f;

// Blocks an SM runs at once, given to ptxas as the register budget
// (65536 / (128 · blocks) registers a thread): 3 at d = 64, 2 at d = 128.
template <int D>
__host__ __device__ constexpr int min_blocks() { return D == 64 ? 3 : 2; }

// the q tile and 2 stages of (k, v) tiles
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(bf16) * 5 * (size_t)mma_bf16::tile_elems<D>();
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// smem holds smem_bytes<D>() bytes, 16-byte aligned.
template <int D>
__device__ __forceinline__ void tile(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v, bf16* __restrict__ out,
                                     float* __restrict__ lse, int s_q, int s_kv, int q_start,
                                     int k_start, int causal, float scale, int q0, int bh,
                                     unsigned char* smem) {
  using namespace mma_bf16;
  constexpr int LD = D + PAD;
  constexpr int TILE = tile_elems<D>();
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* skv = sq + TILE;  // stage i: k at skv + 2i·TILE, v after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t q_base = (size_t)bh * s_q * D, kv_base = (size_t)bh * s_kv * D;

  int n_tiles = (s_kv + BN - 1) / BN;
  if (causal) {
    // tiles whose first column lies after this q tile's last row add nothing
    const int reach = q_start + min(q0 + BM, s_q) - 1 - k_start;
    n_tiles = reach < 0 ? 0 : min(n_tiles, reach / BN + 1);
  }

  if (n_tiles > 0) {
    load_tile<D>(sq, q + q_base, q0, s_q);
    load_tile<D>(skv, k + kv_base, 0, s_kv);
    load_tile<D>(skv + TILE, v + kv_base, 0, s_kv);
  }
  cp_async_commit();

  const int a_off = a_offset<LD>(warp, lane);
  const int b_off = b_offset<LD>(lane);
  const int bt_off = bt_offset<LD>(lane);
  const float sl2 = __fmul_rn(scale, LOG2E);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  // m: running max of the scaled scores; l: this lane's share of the row
  // sum (its 16 of each 64 columns)
  float m[2] = {MAX_FLOOR, MAX_FLOOR}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[D / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_0();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qf[kk], sq + a_off + kk * 16);
    }
    if (t + 1 < n_tiles) {
      bf16* nxt = skv + ((t + 1) & 1) * 2 * TILE;
      load_tile<D>(nxt, k + kv_base, (t + 1) * BN, s_kv);
      load_tile<D>(nxt + TILE, v + kv_base, (t + 1) * BN, s_kv);
    }
    cp_async_commit();
    const bf16* sk = skv + (t & 1) * 2 * TILE;
    const bf16* sv = sk + TILE;
    const int kv0 = t * BN;

    // s = q kᵀ: 16 × 64 per warp
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, sk + np * 16 * LD + b_off + kk * 16);
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // the masks, on a tile that crosses the diagonal or the ragged kv tail
    if (kv0 + BN > s_kv || (causal && k_start + kv0 + BN - 1 > q_start + q0)) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + n * 8 + 2 * t4 + (e & 1);
          const int q_pos = q_start + row0 + 8 * (e >> 1);
          if (col >= s_kv || (causal && q_pos < k_start + col)) s[n][e] = NEG_INF;
        }
    }

    // online softmax: max and rescale in natural-log units, p in log2 units
    float m2[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      // the max of the raw scores, scaled once (scale > 0 keeps the order)
      const float m_new = fmaxf(m[h], __fmul_rn(quad_max(mx), scale));
      m2[h] = __fmul_rn(m_new, LOG2E);
      // exactly 1 while the max stays put, at the floor too (an fmaf of
      // m·log2 e - m2 would leave m2's rounding error, up to 4e12 there)
      corr[h] = exp2f(__fmul_rn(m[h] - m_new, LOG2E));
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score gives exp2(-1.8e29 - m2) = 0
        const float p = exp2f(fmaf(s[n][e], sl2, -m2[e >> 1]));
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = fmaf(l[h], corr[h], sum[h]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fmul_rn(acc[n][e], corr[e >> 1]);

    // acc += p v: p from the registers, v through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      to_a_frag(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, sv + j * 16 * LD + bt_off + dn * 16);
        mma(acc[2 * dn], a, b[0], b[1]);
        mma(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait_0();

  // every lane of a quad takes part in the sums before any row is skipped
  float l_fin[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) l_fin[h] = fmaxf(quad_sum(l[h]), 1e-30f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= s_q) continue;
    const float inv = 1.f / l_fin[h];
    bf16* dst = out + q_base + (size_t)row * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(__fmul_rn(acc[n][2 * h], inv), __fmul_rn(acc[n][2 * h + 1], inv));
    if (t4 == 0) lse[(size_t)bh * s_q + row] = m[h] + logf(l_fin[h]);
  }
}

}  // namespace flash_fwd_tc
