// The fused ring-attention hop for Hopper (sm_90a): flash forward of one q
// block against the resident K/V half, while the same kernel streams that
// K/V half into the ring neighbour's receive slot.
//
// Replaces dsml_tpu/ops/flash.py::_stream_fwd_kernel (kernel 4, the Pallas
// TPU kernel behind flash_stream_hop, which ring attention calls under
// DSML_RING_FUSED=dma). The same function:
// - the math: kernel 1's block (flash_fwd_tile.cuh, shared with flash_fwd.cu,
//   so the hop's (out, lse) equal kernel 1's bit for bit): q kᵀ · scale
//   under the global-position causal mask and the ragged kv tail, online
//   softmax in f32, out in q's type and an f32 lse;
// - the skip: with pred == 0 the block writes the merge identity (out = 0,
//   lse = -1e30) and does no math, as the TPU kernel's hop-skip predicate;
// - the stream: with every value of pred, the UNPADDED resident K and V
//   (k_src, v_src) are copied to k_dst, v_dst, which in the ring are the
//   neighbour's slot mapped into this process by CUDA IPC
//   (dsml_tpu_torch/parallel/peer.py). The TPU kernel starts a remote DMA at
//   its first grid step and waits on it at its last; here every block first
//   issues its share of the copy as 16-byte stores (the copy split evenly
//   over all blocks), then computes, so the stores drain under the math.
//   Completion is the kernel's end on the stream, after which the transport
//   records the interprocess event the neighbour's stream waits on.
//
// What bounds it. At the cp = 2 GPT-2-small hop (q [96, 512, 64], a K/V half
// [96, 256, 64], bf16, causal with offsets) one call reads q, k and v once
// (12.6 MB), writes out and lse (6.5 MB) and the copy (6.3 MB): ~25.4 MB, or
// 7.6 µs at 3.35 TB/s, against 2.4 GFLOP of kept scores (2.4 µs at 989 TFLOP/s
// bf16). Bytes bound it. The design's answer is to read each K/V byte for the
// copy in the same pass that overlaps the math, so the stream adds only its
// own stores (a quarter of the bytes) to kernel 1's traffic. The math is
// kernel 1's body, routed by type: bf16 on the tensor cores
// (flash_fwd_tc.cuh: mma.sync from ldmatrix, a cp.async K/V ring, p in
// registers; 128 threads), f32 on FMAs (256 threads); see flash_fwd.cu.
// The copy's 16-byte stores are issued before the math, so they drain
// while the block's products run; the copy is split over blockDim.x
// threads of every block, whichever route's block size that is.
//
// Interface: plain C, loaded with ctypes. flash_stream_fwd returns a
// cudaError_t (0 on success): the launch is checked with cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include "flash_fwd_tile.cuh"

namespace {

using flash_tile::BM;
using flash_tile::block_smem;
using flash_tile::block_threads;
using bf16 = __nv_bfloat16;

// Every block copies units bid, bid + n_blocks, ... of the 16-byte units of
// K and V (2 · n16 in all) over its blockDim.x threads (128 or 256, by
// route), then, in block 0, the ragged tail bytes (fewer than 16 of each).
// The loads go through the read-only path; the stores are plain global
// stores, to local or peer-mapped memory alike.
__device__ __forceinline__ void stream_share(const uint4* __restrict__ k_src,
                                             const uint4* __restrict__ v_src,
                                             uint4* __restrict__ k_dst, uint4* __restrict__ v_dst,
                                             long long n16, int tail) {
  const long long n_blocks = (long long)gridDim.x * gridDim.y;
  const long long bid = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const long long stride = n_blocks * blockDim.x;
  for (long long i = bid * blockDim.x + threadIdx.x; i < 2 * n16; i += stride) {
    if (i < n16)
      k_dst[i] = __ldg(k_src + i);
    else
      v_dst[i - n16] = __ldg(v_src + (i - n16));
  }
  if (tail && bid == 0 && threadIdx.x < 2 * tail) {
    const int which = threadIdx.x / tail, b = threadIdx.x % tail;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(which ? v_src + n16 : k_src + n16);
    unsigned char* dst = reinterpret_cast<unsigned char*>(which ? v_dst + n16 : k_dst + n16);
    dst[b] = src[b];
  }
}

// The fused hop: the block's share of the copy, then kernel 1's block body
// (pred) or the hop-skip identity. One kernel template for each route, for
// its launch bounds.
template <typename T, int D>
__device__ __forceinline__ void run(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, T* __restrict__ out,
                                    float* __restrict__ lse, int s_q, int s_kv, int q_start,
                                    int k_start, int causal, float scale, int pred,
                                    const uint4* __restrict__ k_src, const uint4* __restrict__ v_src,
                                    uint4* __restrict__ k_dst, uint4* __restrict__ v_dst,
                                    long long n16, int tail) {
  extern __shared__ __align__(16) unsigned char smem[];
  stream_share(k_src, v_src, k_dst, v_dst, n16, tail);
  const int q0 = flash_tile::tile_q0();
  const int bh = blockIdx.y;
  if (pred) {
    flash_tile::block<T, D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale, q0,
                            bh, smem);
    return;
  }
  // the hop-skip identity: what the unfused ring's skipped pair contributes
  const size_t q_base = (size_t)bh * s_q * D;
  const int rows = min(BM, s_q - q0);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    flash_tile::store(&out[q_base + (size_t)q0 * D + i], 0.f);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    lse[(size_t)bh * s_q + q0 + r] = flash_tile::NEG_INF;
}

template <typename T, int D, std::enable_if_t<std::is_same_v<T, float>, int> = 0>
__global__ void __launch_bounds__(flash_tile::NT)
flash_stream_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ out, float* __restrict__ lse, int s_q, int s_kv,
                        int q_start, int k_start, int causal, float scale, int pred,
                        const uint4* __restrict__ k_src, const uint4* __restrict__ v_src,
                        uint4* __restrict__ k_dst, uint4* __restrict__ v_dst, long long n16,
                        int tail) {
  run<T, D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale, pred, k_src, v_src,
            k_dst, v_dst, n16, tail);
}

template <typename T, int D, std::enable_if_t<std::is_same_v<T, bf16>, int> = 0>
__global__ void __launch_bounds__(flash_fwd_tc::NT, flash_fwd_tc::min_blocks<D>())
flash_stream_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ out, float* __restrict__ lse, int s_q, int s_kv,
                        int q_start, int k_start, int causal, float scale, int pred,
                        const uint4* __restrict__ k_src, const uint4* __restrict__ v_src,
                        uint4* __restrict__ k_dst, uint4* __restrict__ v_dst, long long n16,
                        int tail) {
  run<T, D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale, pred, k_src, v_src,
            k_dst, v_dst, n16, tail);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int s_q, int s_kv, int q_start, int k_start, int causal, float scale, int pred,
                   const void* k_src, const void* v_src, void* k_dst, void* v_dst,
                   long long nbytes, cudaStream_t stream) {
  // the one kernel template whose route is T's
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int, int, int, float, int,
                 const uint4*, const uint4*, uint4*, uint4*, long long, int) =
      flash_stream_fwd_kernel<T, D>;
  constexpr size_t smem = block_smem<T, D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + BM - 1) / BM, bh);
  kernel<<<grid, block_threads<T>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s_q, s_kv, q_start, k_start, causal, scale, pred,
      static_cast<const uint4*>(k_src), static_cast<const uint4*>(v_src),
      static_cast<uint4*>(k_dst), static_cast<uint4*>(v_dst), nbytes / 16, (int)(nbytes % 16));
  return cudaGetLastError();
}

}  // namespace

// q [bh, s_q, d], k and v [bh, s_kv, d] (the compute operands, head_dim
// padded to d), out [bh, s_q, d], all contiguous and of one type (f32, or
// bf16 when is_bf16, then 16-byte aligned); lse [bh, s_q] f32. d is 64 or 128; scale is d^-½ of
// the caller's true head_dim. k_src and v_src hold the unpadded resident K
// and V, nbytes each, copied to k_dst and v_dst; all four 16-byte aligned.
extern "C" int flash_stream_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                                int bh, int s_q, int s_kv, int d, int q_start, int k_start,
                                int causal, int is_bf16, float scale, int pred, const void* k_src,
                                const void* v_src, void* k_dst, void* v_dst, long long nbytes,
                                void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch<bf16, 64>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, pred, k_src, v_src, k_dst, v_dst, nbytes, st)
                   : launch<float, 64>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, pred, k_src, v_src, k_dst, v_dst, nbytes, st);
  if (d == 128)
    return is_bf16 ? launch<bf16, 128>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, pred, k_src, v_src, k_dst, v_dst, nbytes, st)
                   : launch<float, 128>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, pred, k_src, v_src, k_dst, v_dst, nbytes, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_stream_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
