// The flash-attention forward's block body, shared by flash_fwd.cu (kernel 1)
// and flash_stream.cu (kernel 4, the fused ring hop), routed by type: bf16
// runs the tensor-core body of flash_fwd_tc.cuh (128 threads), f32 the FMA
// body below (256 threads; a tensor-core product would round f32 to TF32,
// about three decimal digits). Both kernels inline the same function at
// the same tile sizes and grid, so a ring hop computed by kernel 4 gives the
// same bits as kernel 1 on the same inputs: the fused and the unfused ring
// schedules merge identical (out, lse) pairs.
//
// What one block computes: out = softmax(q kᵀ · scale + mask) v with an
// online softmax in f32, and lse = m + log(l), for the 64-row q tile q0 of
// the (batch·head) row bh. The mask compares GLOBAL positions (q_start + row
// >= k_start + col) and drops the ragged kv tail (col >= s_kv). The numeric
// edges are the TPU kernel's: masked scores are -1e30, the running max starts
// at and is floored at -1e20 (a fully masked row gives exp(-1e30 + 1e20) = 0,
// not NaN), the final denominator is max(l, 1e-30). See flash_fwd.cu for the
// design and its bound.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "flash_fwd_tc.cuh"

namespace flash_tile {

constexpr int BM = 64;   // q rows per block, in both bodies
constexpr int BN = 64;   // kv columns per tile
constexpr int NT = 256;  // threads per block of the FMA body: 16 row groups × 16 column lanes
constexpr float NEG_INF = -1e30f;
constexpr float MAX_FLOOR = -1e20f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// max and sum over the 16 lanes that hold one row (xor offsets < 16 stay in
// the half warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

static_assert(BM == flash_fwd_tc::BM, "both bodies tile q by BM rows: one grid for both");

template <int D>
constexpr __host__ __device__ size_t smem_bytes() {
  return sizeof(float) * (size_t)(BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1));
}

// q0 of the block at blockIdx.x: blocks are issued heaviest-first (the last q
// tiles see the most kv tiles under a causal mask)
__device__ __forceinline__ int tile_q0() { return (gridDim.x - 1 - blockIdx.x) * BM; }

// The FMA body (f32). Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty*4 .. ty*4+3 of the q tile, score columns tx + 16j of each kv tile, and
// output columns tx + 16j. smem holds smem_bytes<D>() bytes. Every
// multiply-add is an explicit fmaf, so the compiler contracts the same
// operations in both kernels.
template <int D>
__device__ __forceinline__ void fma_tile(const float* __restrict__ q, const float* __restrict__ k,
                                         const float* __restrict__ v, float* __restrict__ out,
                                         float* __restrict__ lse, int s_q, int s_kv, int q_start,
                                         int k_start, int causal, float scale, int q0, int bh,
                                         float* smem) {
  constexpr int LD = D + 1;   // padded row stride of the q, k and v tiles
  constexpr int LDP = BN + 1; // padded row stride of the probability tile
  constexpr int DC = D / 16;  // output columns per thread
  float* sq = smem;
  float* sk = sq + BM * LD;
  float* sv = sk + BN * LD;
  float* sp = sv + BN * LD;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_base = (size_t)bh * s_q * D;
  const size_t kv_base = (size_t)bh * s_kv * D;

  for (int i = tid; i < BM * D; i += NT) {
    const int r = i / D, c = i % D;
    sq[r * LD + c] = q0 + r < s_q ? q[q_base + (size_t)(q0 + r) * D + c] : 0.f;
  }

  int n_tiles = (s_kv + BN - 1) / BN;
  if (causal) {
    // tiles whose first column lies after this q tile's last row add nothing
    const int reach = q_start + min(q0 + BM, s_q) - 1 - k_start;
    n_tiles = reach < 0 ? 0 : min(n_tiles, reach / BN + 1);
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MAX_FLOOR;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BN;
    __syncthreads();  // the q tile is stored, and the last tile's readers are done
    for (int i = tid; i < BN * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = kv0 + r < s_kv;
      const size_t g = kv_base + (size_t)(kv0 + r) * D + c;
      sk[r * LD + c] = in ? k[g] : 0.f;
      sv[r * LD + c] = in ? v[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int q_pos = q_start + q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        const bool keep = col < s_kv && (!causal || q_pos >= k_start + col);
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[row * LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = fmaf(l[i], corr, row_sum(sum));
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pa[4], vb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vb[j] = sv[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_q) continue;
    const float l_fin = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) out[q_base + (size_t)row * D + tx + 16 * j] = acc[i][j] / l_fin;
    if (tx == 0) lse[(size_t)bh * s_q + row] = m[i] + logf(l_fin);
  }
}

// The route by type: threads per block, dynamic shared memory and body.
template <typename T>
constexpr __host__ __device__ int block_threads() {
  return std::is_same_v<T, float> ? NT : flash_fwd_tc::NT;
}
template <typename T, int D>
constexpr __host__ __device__ size_t block_smem() {
  return std::is_same_v<T, float> ? smem_bytes<D>() : flash_fwd_tc::smem_bytes<D>();
}
template <typename T, int D>
__device__ __forceinline__ void block(const T* __restrict__ q, const T* __restrict__ k,
                                      const T* __restrict__ v, T* __restrict__ out,
                                      float* __restrict__ lse, int s_q, int s_kv, int q_start,
                                      int k_start, int causal, float scale, int q0, int bh,
                                      unsigned char* smem) {
  if constexpr (std::is_same_v<T, float>)
    fma_tile<D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale, q0, bh,
                reinterpret_cast<float*>(smem));
  else
    flash_fwd_tc::tile<D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale, q0, bh,
                          smem);
}

}  // namespace flash_tile
