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

#include "flash_fwd_tile.cuh"

namespace {

using flash_tile::BM;
using flash_tile::NT;
using flash_tile::smem_bytes;

// The block body is flash_fwd_tile.cuh's, shared with kernel 4
// (flash_stream.cu) so both give the same bits on the same inputs.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int s_q, int s_kv,
                 int q_start, int k_start, int causal, float scale) {
  extern __shared__ float smem[];
  flash_tile::tile<T, D>(q, k, v, out, lse, s_q, s_kv, q_start, k_start, causal, scale,
                         flash_tile::tile_q0(), blockIdx.y, smem);
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
// scale is d^-½ of the caller's true head_dim (the wrapper zero-pads other widths
// up to 64 or 128).
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
