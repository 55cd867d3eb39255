// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces dsml_tpu/ops/flash.py::_dq_kernel (:481) and ::_dkv_kernel
// (:526), the Pallas TPU kernels behind the custom VJP of flash_attention /
// flash_attention_lse. Same function. With s = q kᵀ · d^-½ masked to -1e30
// (global positions: q_start + row >= k_start + col under the causal mask,
// and the ragged kv edge col < s_kv), p = exp(s - lse) from the lse the
// forward saved (f32 [bh, s_q]; it already carries the -1e20 max floor and
// the 1e-30 denominator floor), dp = do vᵀ, ds = p · (dp - delta + g_lse)
// where delta = rowsum(do · out) (computed by the caller, as the TPU code
// does outside Pallas) and g_lse is the cotangent of the lse output:
//   dq = d^-½ · Σ_kv ds k          (flash_bwd_dq_kernel)
//   dv = Σ_q pᵀ do,  dk = d^-½ · Σ_q dsᵀ q   (flash_bwd_dkv_kernel)
// The scale is applied to dq and dk once, at the end, as on the TPU.
//
// What bounds it. At GPT-2-small's training shape (bf16 [96, 1024, 64],
// causal) the dq kernel does 3 products of 2·d operations per kept score
// (q kᵀ, do vᵀ, ds k) and the dk/dv kernel 4 (q kᵀ, do vᵀ, pᵀ do, dsᵀ q):
// 19 and 26 GFLOP against 64 and 77 MB of inputs and outputs, about 300
// operations per byte, at the H100's bf16 ridge (~295), so the least time is
// set by operations on the tensor cores. This first version does not reach
// it: its products are f32 FMAs over tiles in shared memory (no tensor
// cores), so shared-memory load issue and FMA issue bound it, as in
// flash_fwd.cu.
//
// Design. The TPU carries the dq accumulator across the kv axis of a
// sequential grid, and the dk/dv accumulators across the q axis. Hopper runs
// blocks in parallel and in no order, so each accumulator is owned by one
// thread block that walks the other axis in a loop and keeps the sum in f32
// registers: one block per (batch·head, 64-row q tile) for dq, one per
// (batch·head, 64-row kv tile) for dk and dv. Keeping the TPU's two-kernel
// split recomputes p in both kernels but needs no atomics and is
// deterministic. The causal skip (pl.when on the TPU) becomes each loop's
// bound: the dq block stops at the last kv tile that reaches its rows, the
// dk/dv block starts at the first q tile that reaches its columns. Tiles
// are stored in shared memory in f32 (converted on load from f32 or bf16)
// with row strides padded by one float, so the 16 lanes that share a row
// read 16 banks. At d = 128 the tiles take up to 165 KB, above the 48 KB
// static limit, so each launch raises the dynamic limit first. Ragged s_q
// and s_kv are masked in the kernel: no padded copy is made.
//
// Interface: plain C, loaded with ctypes. Each launcher returns a
// cudaError_t (0 on success), checked with cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;   // q rows per tile
constexpr int BN = 64;   // kv rows per tile
constexpr int NT = 256;  // threads per block: 16 row groups × 16 column lanes
constexpr int LDP = BN + 1;  // padded row stride of a 64 × 64 score tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows r0 .. r0 + 63 of a [n, D] tensor into a [64, D + 1] f32 tile; rows
// past n are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int r0, int n) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r0 + r < n ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// Thread (ty, tx) computes the 4 × 4 score entries (rows ty*4 + i, columns
// tx + 16j) of a (q tile, kv tile) pair: s = q kᵀ and dp = do vᵀ, then
// p = exp(s·scale - lse) with the masks and ds = p (dp - delta + g_lse).
// Rows past s_q get p = ds = 0.
template <int D>
__device__ __forceinline__ void scores(const float* sq, const float* sdo, const float* sk,
                                       const float* sv, const float* lse_r, const float* dg_r,
                                       int q0, int kv0, int s_q, int s_kv, int q_start,
                                       int k_start, int causal, float scale, float (&p)[4][4],
                                       float (&ds)[4][4]) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = sq[(ty * 4 + i) * LD + d];
      oa[i] = sdo[(ty * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = sk[(tx + 16 * j) * LD + d];
      vb[j] = sv[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const int q_pos = q_start + row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = kv0 + tx + 16 * j;
      const bool keep = col < s_kv && (!causal || q_pos >= k_start + col);
      const float sc = keep ? s[i][j] * scale : NEG_INF;
      p[i][j] = row < s_q ? expf(sc - lse_r[i]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - dg_r[i]);
    }
  }
}

// lse and (delta - g_lse) of rows q0 + ty*4 + i; rows past s_q read 0
__device__ __forceinline__ void row_stats(const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          const float* __restrict__ glse, size_t base, int q0,
                                          int s_q, float (&lse_r)[4], float (&dg_r)[4]) {
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool in = row < s_q;
    lse_r[i] = in ? lse[base + row] : 0.f;
    dg_r[i] = in ? delta[base + row] - (glse ? glse[base + row] : 0.f) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(4 * BM * (D + 1) + BM * LDP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * BM * (D + 1) + 2 * BM * LDP);
}

// One block per (batch·head = blockIdx.y, q tile). Thread (ty, tx) owns dq
// rows ty*4 .. ty*4+3 and columns tx + 16j.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ glse,
                    T* __restrict__ dq, int s_q, int s_kv, int q_start, int k_start, int causal,
                    float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + BM * LD;
  float* sk = sdo + BM * LD;
  float* sv = sk + BN * LD;
  float* sds = sv + BN * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest (last) q tiles first
  const int bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t q_base = (size_t)bh * s_q * D, kv_base = (size_t)bh * s_kv * D;
  load_tile<T, D>(sq, q + q_base, q0, s_q);
  load_tile<T, D>(sdo, dout + q_base, q0, s_q);
  float lse_r[4], dg_r[4];
  row_stats(lse, delta, glse, (size_t)bh * s_q, q0, s_q, lse_r, dg_r);

  int n_tiles = (s_kv + BN - 1) / BN;
  if (causal) {
    // kv tiles whose first column lies after this q tile's last row add nothing
    const int reach = q_start + min(q0 + BM, s_q) - 1 - k_start;
    n_tiles = reach < 0 ? 0 : min(n_tiles, reach / BN + 1);
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * BN;
    __syncthreads();  // the q tiles are stored, and the last tile's readers are done
    load_tile<T, D>(sk, k + kv_base, kv0, s_kv);
    load_tile<T, D>(sv, v + kv_base, kv0, s_kv);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<D>(sq, sdo, sk, sv, lse_r, dg_r, q0, kv0, s_q, s_kv, q_start, k_start, causal,
              scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sds[(ty * 4 + i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float da[4], kb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = sds[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) kb[j] = sk[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s_q) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) store(&dq[q_base + (size_t)row * D + tx + 16 * j], acc[i][j] * scale);
  }
}

// One block per (batch·head = blockIdx.y, kv tile). Thread (ty, tx) owns dk
// and dv rows ty*4 .. ty*4+3 (kv positions) and columns tx + 16j.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ glse,
                     T* __restrict__ dk, T* __restrict__ dv, int s_q, int s_kv, int q_start,
                     int k_start, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + BN * LD;
  float* sq = sv + BN * LD;
  float* sdo = sq + BM * LD;
  float* sp = sdo + BM * LD;
  float* sds = sp + BM * LDP;

  const int kv0 = blockIdx.x * BN;  // the first kv tiles see the most q tiles under a causal mask
  const int bh = blockIdx.y;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t q_base = (size_t)bh * s_q * D, kv_base = (size_t)bh * s_kv * D;
  load_tile<T, D>(sk, k + kv_base, kv0, s_kv);
  load_tile<T, D>(sv, v + kv_base, kv0, s_kv);

  const int n_tiles = (s_q + BM - 1) / BM;
  int t0 = 0;
  if (causal) {
    // q tiles whose last row lies before this kv tile's first column see none of it
    const int x = k_start + kv0 - q_start;
    t0 = x > 0 ? x / BM : 0;
  }

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
    const int q0 = t * BM;
    __syncthreads();  // the kv tiles are stored, and the last tile's readers are done
    load_tile<T, D>(sq, q + q_base, q0, s_q);
    load_tile<T, D>(sdo, dout + q_base, q0, s_q);
    float lse_r[4], dg_r[4];
    row_stats(lse, delta, glse, (size_t)bh * s_q, q0, s_q, lse_r, dg_r);
    __syncthreads();
    float p[4][4], ds[4][4];
    scores<D>(sq, sdo, sk, sv, lse_r, dg_r, q0, kv0, s_q, s_kv, q_start, k_start, causal,
              scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sp[(ty * 4 + i) * LDP + tx + 16 * j] = p[i][j];
        sds[(ty * 4 + i) * LDP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dv[kv, :] += Σ_r p[r, kv] do[r, :],  dk[kv, :] += Σ_r ds[r, kv] q[r, :]
#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float pa[4], da[4], ob[DC], qb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = sp[r * LDP + ty * 4 + i];
        da[i] = sds[r * LDP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        ob[j] = sdo[r * LD + tx + 16 * j];
        qb[j] = sq[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dv_acc[i][j] = fmaf(pa[i], ob[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(da[i], qb[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kv0 + ty * 4 + i;
    if (row >= s_kv) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const size_t g = kv_base + (size_t)row * D + tx + 16 * j;
      store(&dk[g], dk_acc[i][j] * scale);
      store(&dv[g], dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* glse, void* dq, int bh,
                      int s_q, int s_kv, int q_start, int k_start, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + BM - 1) / BM, bh);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, glse, static_cast<T*>(dq), s_q, s_kv, q_start,
      k_start, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const float* glse, void* dk,
                       void* dv, int bh, int s_q, int s_kv, int q_start, int k_start, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_kv + BN - 1) / BN, bh);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, glse, static_cast<T*>(dk), static_cast<T*>(dv),
      s_q, s_kv, q_start, k_start, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout and dq [bh, s_q, d]; k, v, dk and dv [bh, s_kv, d], all contiguous
// and of one type (f32, or bf16 when is_bf16); lse, delta and glse [bh, s_q]
// f32, glse may be null (a zero cotangent). d is 64 or 128; scale is d^-½
// as the caller rounds it.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* glse, void* dq,
                            int bh, int s_q, int s_kv, int d, int q_start, int k_start,
                            int causal, int is_bf16, float scale, void* stream) {
  const float *l = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta),
              *g = static_cast<const float*>(glse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, dl, g, dq, bh, s_q, s_kv, q_start, k_start, causal, scale, st)
                   : launch_dq<float, 64>(q, k, v, dout, l, dl, g, dq, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  if (d == 128)
    return is_bf16 ? launch_dq<__nv_bfloat16, 128>(q, k, v, dout, l, dl, g, dq, bh, s_q, s_kv, q_start, k_start, causal, scale, st)
                   : launch_dq<float, 128>(q, k, v, dout, l, dl, g, dq, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* glse, void* dk,
                             void* dv, int bh, int s_q, int s_kv, int d, int q_start,
                             int k_start, int causal, int is_bf16, float scale, void* stream) {
  const float *l = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta),
              *g = static_cast<const float*>(glse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dl, g, dk, dv, bh, s_q, s_kv, q_start, k_start, causal, scale, st)
                   : launch_dkv<float, 64>(q, k, v, dout, l, dl, g, dk, dv, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  if (d == 128)
    return is_bf16 ? launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dl, g, dk, dv, bh, s_q, s_kv, q_start, k_start, causal, scale, st)
                   : launch_dkv<float, 128>(q, k, v, dout, l, dl, g, dk, dv, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
