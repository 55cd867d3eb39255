// Tensor-core building blocks of the bf16 flash kernels (sm_90a), shared by
// the forward's block body (flash_fwd_tc.cuh) and the backward
// (flash_bwd_tc.cu): cp.async copies into padded shared tiles, ldmatrix
// fragment loads and mma.sync.m16n8k16 (bf16 in, f32 sums).
//
// Fragment layouts of m16n8k16 (lane l, g = l / 4, t4 = l % 4):
//   A 16×16 (row-major): a0 (row g, cols 2t4, 2t4 + 1), a1 (row g + 8, the
//     same cols), a2 (row g, cols 2t4 + 8, 2t4 + 9), a3 (row g + 8, those);
//   B 16×8 (col-major): b0 (rows 2t4, 2t4 + 1, col g), b1 (rows + 8);
//   C 16×8 f32: c0, c1 (row g, cols 2t4, 2t4 + 1), c2, c3 (row g + 8).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mma_bf16 {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;  // rows of every shared tile
constexpr int NT = 128;   // threads of a block: 4 warps, 16 of a tile's rows each
constexpr int PAD = 8;    // bf16 of padding per shared row

// A tile of ROWS rows of D bf16, each row padded by PAD: rows then start
// 144 or 272 bytes apart, so the 8 row addresses of an 8×8 ldmatrix fall
// on 8 distinct groups of 4 banks (no bank conflicts).
template <int D>
__host__ __device__ constexpr int tile_elems() { return ROWS * (D + PAD); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; when !valid nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// four 8×8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Per-lane ldmatrix offsets into a tile of row stride LD, for warp w:
// the A fragment (rows 16w .. 16w + 15) of a [row][k] tile; the B
// fragments of two 8-column n-blocks from an [n][k] tile (ldsm_x4) and
// from a [k][n] tile (ldsm_x4_t).
template <int LD>
__device__ __forceinline__ int a_offset(int warp, int lane) {
  return (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int b_offset(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ int bt_offset(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
}

// c += a b on the tensor cores: a 16×16 (row), b 16×8 (col), c 16×8 f32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The m16n8 accumulators c[2j] and c[2j+1] (16 rows × 16 columns) as the
// m16k16 A fragment of the next product, in bf16.
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// rows r0 .. r0 + 63 of a [n, D] bf16 tensor into a [64][D + PAD] shared
// tile by cp.async, issued by the block's NT threads; rows past n are
// zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0, int n) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < ROWS * CPR / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool valid = r0 + r < n;
    cp_async16(dst + r * (D + PAD) + c, src + (size_t)(valid ? r0 + r : 0) * D + c, valid);
  }
}

}  // namespace mma_bf16
