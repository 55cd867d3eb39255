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
// What bounds it. Each kept score costs 4·d operations in the two products
// and a handful of f32 instructions around them (scale, mask, max, exp2,
// sum). At GPT-2's prefill shape (bf16 [96, 512, 64], causal) the call
// moves 25.4 MB (7.6 µs at 3.35 TB/s) for 3.2 GFLOP of kept scores (3.3 µs
// at 989 TFLOP/s); at the train shape ([96, 1024, 64]) 50.7 MB (15.1 µs)
// for 12.9 GFLOP (13.0 µs). Bytes bound the first, and the two rates nearly
// tie at the second: a kernel near the bound must run its products on the
// tensor cores and read each q, k and v byte from device memory once per
// block that needs it.
//
// Design. The TPU walks kv blocks in order along a grid axis and carries the
// accumulators in VMEM scratch between grid steps. Hopper runs blocks in
// parallel and in no order, so here one thread block owns one (batch·head,
// 64-row q tile) and walks the kv tiles in a loop inside the block, keeping
// m, l and the output accumulator in registers. Causal tile skipping becomes
// the loop bound: a kv tile whose first column lies after the q tile's last
// row is never loaded. Ragged edges of s_q and s_kv are masked in the
// kernel, so no padded copy is made. Blocks are issued heaviest-first (the
// last q tiles see the most kv tiles under a causal mask). The block body is
// routed by type (flash_fwd_tile.cuh):
//   - bf16: the tensor-core body of flash_fwd_tc.cuh, 4 warps of 16 q rows.
//     The q tile's A fragments stay in registers, K/V tiles stream through
//     a 2-stage cp.async ring, s = q kᵀ and acc += p v run on mma.sync
//     m16n8k16 from ldmatrix, and p goes from the C fragments of s to the A
//     fragments of p v without touching shared memory. The register budget
//     is fixed by __launch_bounds__(128, min_blocks<D>()): 3 blocks (12
//     warps) an SM at d = 64. What keeps it below the tensor cores' rate is
//     most likely each warp's chain per tile rather than a throughput: a
//     barrier, 32 mma, the softmax on the CUDA cores (quad shuffles, one
//     exp2 per score) with no mma of that warp in flight, 32 more mma.
//     Using each K/V fragment for two 16-row blocks (half the ldmatrix per
//     mma) or a fourth block per SM did not make it faster on the card, so
//     the simpler layout stays.
//   - f32: the FMA body of flash_fwd_tile.cuh (f32 tiles in shared memory,
//     256 threads), bound by shared-memory reads and FMA issue. A
//     tensor-core product would round f32 to TF32 and break f32 parity.
//
// Interface: plain C, loaded with ctypes. flash_fwd returns a cudaError_t
// (0 on success): the launch is checked with cudaGetLastError().

#include <type_traits>

#include "flash_fwd_tile.cuh"

namespace {

using flash_tile::BM;
using flash_tile::block_smem;
using flash_tile::block_threads;
using bf16 = __nv_bfloat16;

// The block body is flash_fwd_tile.cuh's, shared with kernel 4
// (flash_stream.cu) so both give the same bits on the same inputs. One
// kernel template for each route, for its launch bounds.
template <typename T, int D>
__device__ __forceinline__ void run(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, T* __restrict__ out,
                                    float* __restrict__ lse, int s_q, int s_kv, int q_start,
                                    int k_start, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  flash_tile::block<T, D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale,
                          flash_tile::tile_q0(), blockIdx.y, smem);
}

template <typename T, int D, std::enable_if_t<std::is_same_v<T, float>, int> = 0>
__global__ void __launch_bounds__(flash_tile::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int s_q, int s_kv,
                 int q_start, int k_start, int causal, float scale) {
  run<T, D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale);
}

template <typename T, int D, std::enable_if_t<std::is_same_v<T, bf16>, int> = 0>
__global__ void __launch_bounds__(flash_fwd_tc::NT, flash_fwd_tc::min_blocks<D>())
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int s_q, int s_kv,
                 int q_start, int k_start, int causal, float scale) {
  run<T, D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int bh, int s_q, int s_kv, int q_start, int k_start, int causal,
                   float scale, cudaStream_t stream) {
  // the one kernel template whose route is T's
  void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int, int, int, float) =
      flash_fwd_kernel<T, D>;
  constexpr size_t smem = block_smem<T, D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + BM - 1) / BM, bh);
  kernel<<<grid, block_threads<T>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s_q, s_kv, q_start, k_start, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q [bh, s_q, d], k and v [bh, s_kv, d], out [bh, s_q, d], all contiguous and
// of one type (f32, or bf16 when is_bf16, then 16-byte aligned); lse [bh,
// s_q] f32. d is 64 or 128; scale is d^-½ of the caller's true head_dim (the
// wrapper zero-pads other widths up to 64 or 128).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                         int bh, int s_q, int s_kv, int d, int q_start, int k_start,
                         int causal, int is_bf16, float scale, void* stream) {
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return is_bf16 ? launch<bf16, 64>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, st)
                   : launch<float, 64>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  if (d == 128)
    return is_bf16 ? launch<bf16, 128>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, st)
                   : launch<float, 128>(q, k, v, out, lse_f, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
