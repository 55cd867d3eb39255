// Dequant-fused matmul of block-quantized weights for Hopper (sm_90a).
//
// Replaces dsml_tpu/ops/quantization.py::_qmm_kernel (the Pallas TPU kernel
// behind quantized_matmul). Same function, in f32:
//
//   out[m, n] = Σ_blocks (x[m, kblk] · codes[kblk, n]) · qs[blk, n]
//
// x is [m, d] f32 or bf16 (converted on load, never copied to f32); the
// codes are int8 [d_p, n_p] or int4 packed in uint8 [d_p/2, n_p], where
// byte row r of k-block b holds row b·kb + r in its high nibble and row
// b·kb + kb/2 + r in its low nibble, each offset by +8 (the row halves of
// a block pack along the CONTRACTION axis; the KV codec packs channel
// halves instead); qs is f32 [nb, n_p], one scale per (k-block, channel).
// Each k-block's dot is summed in f32 and its scale folded in AFTER the
// dot (acc = acc + part · s, two roundings, as the TPU kernel and the
// plain version do), never by dequantizing the tile first: on codes whose
// scales are 1 and small-integer x the result is exact.
//
// What bounds it. At the decode tick (m = 16 slots) every code byte is
// read once for 2·16 operations: the bound is bytes, the packed weight
// over 3.35 TB/s (0.26 µs for GPT-2-small's int4 wqkv). At a 256-row
// prefill chunk it is 2·256·d·n operations over the bf16 tensor-core rate.
// This first kernel reaches neither: its products are f32 FMAs over tiles
// in shared memory (no tensor cores), so the chunk is bounded by
// shared-memory reads and FMA issue, and the decode shape by the latency
// of its k-steps.
//
// Design. The TPU grid walks (m tile, 128-channel tile, k block) with the
// k blocks in order and the accumulator in VMEM scratch. Here one block of
// 128 threads owns 16 rows × 32 channels and walks every k-block in a loop
// inside the block, with the accumulators in registers: 32 lanes take one
// channel each, 4 row groups take 4 rows each. Channel tiles are 32 wide,
// not 128, so that the decode shape fills more of the 132 SMs (24 blocks
// for n = 768, 72 for wqkv's 2304, 96 for 3072) without split-K atomics,
// whose order would change the sums from run to run. A k-step stages 32
// code rows (int8: 32 rows of 32 bytes; int4: 16 byte rows, unpacked to
// the 16 high-nibble and 16 low-nibble rows) and the 16 × 32 x values
// they meet, converted to f32 in shared memory; the next step's global
// loads are issued into registers before the current step's FMAs, so
// their latency overlaps the arithmetic. Rows past m and k past d (the
// codes' zero pad rows) read as 0 in the kernel, and only columns < n are
// written, so x and out are neither padded nor copied.
//
// Interface: plain C, loaded with ctypes. qmm returns a cudaError_t (0 on
// success): the launch is checked with cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 16;   // rows per block
constexpr int BN = 32;   // channels per block
constexpr int BK = 32;   // code rows staged per k-step
constexpr int NT = 128;  // threads: 32 channel lanes × 4 row groups
constexpr int RPT = BM / (NT / BN);  // rows per thread: 4

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// One k-step's global loads, held in registers until the tiles are free:
// the code words (int8: two 4-byte words; int4: one) and 4 x values.
struct Stage {
  uint32_t w[2];
  float x[4];
};

template <typename T, bool INT4>
__device__ __forceinline__ void fetch(Stage& st, const T* __restrict__ x, const uint8_t* __restrict__ qw,
                                      int step, int steps_per_block, int m0, int n0, int m, int d,
                                      int n_p, int kb) {
  const int tid = threadIdx.x;
  const int b = step / steps_per_block;
  if (INT4) {
    const int half = kb / 2;
    const int r0 = (step % steps_per_block) * (BK / 2);  // first byte row of the step in the block
    const int i = tid / (BN / 4), c4 = tid % (BN / 4);     // 16 byte rows × 8 words
    st.w[0] = 0x88888888u;                                  // code 0 in every nibble
    if (r0 + i < half)
      st.w[0] = *reinterpret_cast<const uint32_t*>(qw + (size_t)(b * half + r0 + i) * n_p + n0 + 4 * c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + NT * j, r = idx / BK, c = idx % BK;  // 16 rows × 32 staged k
      const int kr = (c < BK / 2) ? r0 + c : r0 + c - BK / 2;   // byte row within the block
      const int k = b * kb + (c < BK / 2 ? 0 : half) + kr;
      const bool ok = m0 + r < m && kr < half && k < d;
      st.x[j] = ok ? to_f32(x[(size_t)(m0 + r) * d + k]) : 0.f;
    }
  } else {
    const int r0 = (step % steps_per_block) * BK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + NT * j, i = idx / (BN / 4), c4 = idx % (BN / 4);  // 32 rows × 8 words
      st.w[j] = 0u;
      if (r0 + i < kb)
        st.w[j] = *reinterpret_cast<const uint32_t*>(qw + (size_t)(b * kb + r0 + i) * n_p + n0 + 4 * c4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + NT * j, r = idx / BK, c = idx % BK;
      const int k = b * kb + r0 + c;
      const bool ok = m0 + r < m && r0 + c < kb && k < d;
      st.x[j] = ok ? to_f32(x[(size_t)(m0 + r) * d + k]) : 0.f;
    }
  }
}

template <bool INT4>
__device__ __forceinline__ void stage(const Stage& st, float (*ws)[BN], float (*xs)[BK + 1]) {
  const int tid = threadIdx.x;
  if (INT4) {
    const int i = tid / (BN / 4), c4 = tid % (BN / 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t byte = (st.w[0] >> (8 * e)) & 0xFFu;
      ws[i][4 * c4 + e] = (float)((int)(byte >> 4) - 8);
      ws[BK / 2 + i][4 * c4 + e] = (float)((int)(byte & 0xFu) - 8);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = tid + NT * j, i = idx / (BN / 4), c4 = idx % (BN / 4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ws[i][4 * c4 + e] = (float)(int8_t)((st.w[j] >> (8 * e)) & 0xFFu);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int idx = tid + NT * j;
    xs[idx / BK][idx % BK] = st.x[j];
  }
}

template <typename T, bool INT4>
__global__ void __launch_bounds__(NT) qmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ qw,
                                                 const float* __restrict__ qs, float* __restrict__ out,
                                                 int m, int d, int n, int n_p, int kb, int nb) {
  __shared__ float ws[BK][BN];      // codes of the step, as f32
  __shared__ float xs[BM][BK + 1];  // x of the step, as f32
  const int lane = threadIdx.x % BN, grp = threadIdx.x / BN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int steps_per_block = INT4 ? (kb / 2 + BK / 2 - 1) / (BK / 2) : (kb + BK - 1) / BK;
  const int steps = nb * steps_per_block;

  float acc[RPT], part[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = part[r] = 0.f;

  Stage st;
  fetch<T, INT4>(st, x, qw, 0, steps_per_block, m0, n0, m, d, n_p, kb);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // every thread is done with the previous step's tiles
    stage<INT4>(st, ws, xs);
    __syncthreads();
    if (s + 1 < steps) fetch<T, INT4>(st, x, qw, s + 1, steps_per_block, m0, n0, m, d, n_p, kb);
#pragma unroll
    for (int i = 0; i < BK; ++i) {
      const float w = ws[i][lane];
#pragma unroll
      for (int r = 0; r < RPT; ++r) part[r] = fmaf(xs[grp * RPT + r][i], w, part[r]);
    }
    if ((s + 1) % steps_per_block == 0) {  // the k-block is done: fold its scale
      const float scale = qs[(size_t)(s / steps_per_block) * n_p + n0 + lane];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(part[r], scale));
        part[r] = 0.f;
      }
    }
  }
  const int col = n0 + lane;
  if (col >= n) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = m0 + grp * RPT + r;
    if (row < m) out[(size_t)row * n + col] = acc[r];
  }
}

template <typename T, bool INT4>
cudaError_t launch(const void* x, const void* qw, const void* qs, void* out, int m, int d, int n,
                   int n_p, int kb, int nb, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  qmm_kernel<T, INT4><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), static_cast<const uint8_t*>(qw),
                                               static_cast<const float*>(qs), static_cast<float*>(out),
                                               m, d, n, n_p, kb, nb);
  return cudaGetLastError();
}

}  // namespace

// out [m, n] f32 = x [m, d] (f32, or bf16 when x_bf16) @ dequant(qw, qs).
// qw: int8 [nb·kb, n_p], or (int4) uint8 [nb·kb/2, n_p]; qs: f32 [nb, n_p].
// kb % 8 == 0, n_p % 128 == 0, qw 4-byte aligned. Returns a cudaError_t.
extern "C" int qmm(const void* x, const void* qw, const void* qs, void* out, int m, int d, int n,
                   int n_p, int kb, int nb, int x_bf16, int int4, void* stream) {
  if (kb % 8 || n_p % BN || n > n_p || d > nb * kb) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return int4 ? launch<__nv_bfloat16, true>(x, qw, qs, out, m, d, n, n_p, kb, nb, s)
                : launch<__nv_bfloat16, false>(x, qw, qs, out, m, d, n, n_p, kb, nb, s);
  return int4 ? launch<float, true>(x, qw, qs, out, m, d, n, n_p, kb, nb, s)
              : launch<float, false>(x, qw, qs, out, m, d, n, n_p, kb, nb, s);
}

extern "C" const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
