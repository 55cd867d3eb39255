// Flash-attention forward for Hopper (sm_90a).
//
// Replaces dsml_tpu/ops/flash.py::_fwd_kernel (the Pallas TPU kernel behind
// flash_attention / flash_attention_lse). Same function: out = softmax(q kᵀ
// · d^-½ + mask) v with an online softmax in f32, plus lse = m + log(l) per
// query row, where the mask compares GLOBAL positions (q_start + row >=
// k_start + col) and drops the ragged kv tail (k_start + col >= kv_stop,
// kv_stop = k_start + s_kv). The numeric edges are the TPU kernel's: masked
// scores are -1e30, the running max starts at and is floored at -1e20 (a
// fully masked row gives exp(-1e30 + 1e20) = 0, not NaN), the final
// denominator is max(l, 1e-30).
//
// What bounds it. At GPT-2's prefill shape (d = 64, s = 512, causal) each
// head does 2·s²·d operations on 8·s·d bytes of q, k, v and out in bf16:
// s/4 = 128 operations per byte, below the H100's ~295 bf16 operations per
// byte, so the least time is set by device-memory bytes. This first kernel
// does not reach that bound: its inner products are f32 FMAs over tiles in
// shared memory (no tensor cores), so it is bounded by shared-memory reads
// and FMA issue instead.
//
// Design. The TPU walks kv blocks in order along a grid axis and carries the
// accumulators in VMEM scratch between grid steps. Hopper runs blocks in
// parallel and in no order, so here one thread block owns one (batch·head,
// 64-row q tile) and walks the kv tiles in a loop inside the block, keeping
// m, l and the output accumulator in registers. Tiles are stored in shared
// memory in f32 (converted on load from f32 or bf16), 3 × 64 × (d+1) + 64 ×
// 65 floats: above the 48 KB static limit, so the launch raises the dynamic
// limit first. Row strides are padded by one float so that the 16 threads
// that share a row read 16 different banks. Causal tile skipping becomes the
// loop bound: a kv tile whose first column lies after the q tile's last row
// is never loaded. Ragged edges of s_q and s_kv are masked in the kernel, so
// no padded copy is made. Blocks are issued heaviest-first (the last q tiles
// see the most kv tiles under a causal mask).
//
// Interface: plain C, loaded with ctypes. flash_fwd returns a cudaError_t
// (0 on success): the launch is checked with cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;   // q rows per block
constexpr int BN = 64;   // kv columns per tile
constexpr int NT = 256;  // threads per block: 16 row groups × 16 column lanes
constexpr float NEG_INF = -1e30f;
constexpr float MAX_FLOOR = -1e20f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BM * (D + 1) + 2 * BN * (D + 1) + BM * (BN + 1));
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 .. ty*4+3 of the q
// tile, score columns tx + 16j of each kv tile, and output columns tx + 16j.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int s_q, int s_kv,
                 int q_start, int k_start, int causal, float scale) {
  constexpr int LD = D + 1;   // padded row stride of the q, k and v tiles
  constexpr int LDP = BN + 1; // padded row stride of the probability tile
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BM * LD;
  float* sv = sk + BN * LD;
  float* sp = sv + BN * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t q_base = (size_t)bh * s_q * D;
  const size_t kv_base = (size_t)bh * s_kv * D;

  for (int i = tid; i < BM * D; i += NT) {
    const int r = i / D, c = i % D;
    sq[r * LD + c] = q0 + r < s_q ? to_f32(q[q_base + (size_t)(q0 + r) * D + c]) : 0.f;
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
      sk[r * LD + c] = in ? to_f32(k[g]) : 0.f;
      sv[r * LD + c] = in ? to_f32(v[g]) : 0.f;
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
      l[i] = l[i] * corr + row_sum(sum);
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
    for (int j = 0; j < DC; ++j)
      store(&out[q_base + (size_t)row * D + tx + 16 * j], acc[i][j] / l_fin);
    if (tx == 0) lse[(size_t)bh * s_q + row] = m[i] + logf(l_fin);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int bh, int s_q, int s_kv, int q_start, int k_start, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + BM - 1) / BM, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s_q, s_kv, q_start, k_start, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [bh, s_q, d], k and v [bh, s_kv, d], out [bh, s_q, d], all contiguous and
// of one type (f32, or bf16 when is_bf16); lse [bh, s_q] f32. d is 64 or 128;
// scale is d^-½ as the caller rounds it.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int bh, int s_q, int s_kv, int d, int q_start, int k_start,
                         int causal, int is_bf16, float scale, void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, st)
                   : launch<float, 64>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  if (d == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, st)
                   : launch<float, 128>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
