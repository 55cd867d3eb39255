// Blockwise stochastic int8 quantizer for Hopper (sm_90a).
//
// Replaces the inner kernel of dsml_tpu/ops/quantization.py::_quantize_pallas
// (the Pallas TPU kernel behind quantize_int8 on the accelerator). Same
// function over 512-element blocks of the flattened input, zero-padded:
//
//   scale = max(absmax / 127, 1e-12)      (a true division)
//   q     = clip(floor(x / scale + u), -127, 127)
//
// with u in [0, 1) from the top 24 bits of 32 random bits: u = (bits >> 8)
// · 2^-24, so floor(y + u) rounds y up with probability frac(y) and the
// rounding is unbiased. The TPU draws the bits from its on-core generator
// seeded with seed + program_id, which has no twin here; the bits are a
// counter hash of (seed, global element index g) instead:
//
//   bits = mix32(mix32(mix32(seed) ^ (lo(g) + 1) · 0x9E3779B9) ^ hi(g))
//
// (mix32 = murmur3's finaliser, uint32 arithmetic), the expression that
// ops/quantization.py::_noise_bits computes in int64 tensors. Both
// divisions are IEEE divisions and the add is __fadd_rn, so with no
// fast-math flags the kernel and its plain version agree bit for bit.
//
// What bounds it. Each element is read once in its own type (bf16 or f32)
// and written once as int8, plus one f32 scale per block: at the train
// step's [8, 1024, 768] bf16 block input that is 18.9 MB, 5.6 µs at
// 3.35 TB/s. The arithmetic (a reduction, two divisions, ~20 integer
// operations of the hash per element) is far below the card's rates, so
// the bound is bytes.
//
// Design. The TPU runs one program per 8-row strip of blocks. Here one
// block of 128 threads owns one 512-element block row: each thread loads 4
// elements (consecutive threads on consecutive addresses), converts them
// to f32 in registers (no f32 copy of the input), the absmax reduces by
// warp shuffles and a 4-entry shared array, and each thread writes its 4
// codes; thread 0 writes the scale. The seed is read from device memory
// by pointer, so a seed computed on the card (compressed remat derives it
// from the activation's bits) never makes the host wait.
//
// Interface: plain C, loaded with ctypes. quantize_int8 returns a
// cudaError_t (0 on success): the launch is checked with cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 512;          // elements per scale block
constexpr int NT = 128;             // threads per block row
constexpr int PER = BLOCK / NT;     // elements per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <typename T>
__global__ void __launch_bounds__(NT) quantize_int8_kernel(const T* __restrict__ x, const int* __restrict__ seed,
                                                           int8_t* __restrict__ q, float* __restrict__ scales,
                                                           long long size) {
  __shared__ float warp_max[NT / 32];
  const long long base = (long long)blockIdx.x * BLOCK;
  float v[PER];
  float amax = 0.f;
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const long long g = base + threadIdx.x + r * NT;
    v[r] = g < size ? to_f32(x[g]) : 0.f;
    amax = fmaxf(amax, fabsf(v[r]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float scale = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
  const uint32_t key = mix32((uint32_t)seed[0]);
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const long long g = base + threadIdx.x + r * NT;
    const uint32_t lo = (uint32_t)g, hi = (uint32_t)(g >> 32);
    const uint32_t bits = mix32(mix32(key ^ ((lo + 1u) * 0x9E3779B9u)) ^ hi);
    const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
    const float y = floorf(__fadd_rn(__fdiv_rn(v[r], scale), u));
    q[g] = (int8_t)fminf(fmaxf(y, -127.f), 127.f);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

}  // namespace

// q int8 [rows, 512] and scales f32 [rows, 1] of the `size` elements at x
// (f32, or bf16 when x_bf16), rows = ceil(size / 512) (at least 1); seed
// points to one int32 on the device. Returns a cudaError_t.
extern "C" int quantize_int8(const void* x, const void* seed, void* q, void* scales, long long size,
                             int x_bf16, void* stream) {
  const long long rows = size > 0 ? (size + BLOCK - 1) / BLOCK : 1;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    quantize_int8_kernel<__nv_bfloat16><<<(unsigned)rows, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(seed), static_cast<int8_t*>(q),
        static_cast<float*>(scales), size);
  else
    quantize_int8_kernel<float><<<(unsigned)rows, NT, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(seed), static_cast<int8_t*>(q),
        static_cast<float*>(scales), size);
  return (int)cudaGetLastError();
}

extern "C" const char* quantize_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
