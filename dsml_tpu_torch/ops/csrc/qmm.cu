// Dequant-fused matmul of block-quantized weights for Hopper (sm_90a).
//
// Replaces dsml_tpu/ops/quantization.py::_qmm_kernel (the Pallas TPU kernel
// behind quantized_matmul). Same function, in f32:
//
//   out[m, n] = Σ_blocks (x[m, kblk] · codes[kblk, n]) · qs[blk, n]
//
// x is [m, d] f32 or bf16 (read in its own type); the codes
// are int8 [d_p, n_p] or int4 packed in uint8 [d_p/2, n_p], where byte row
// r of k-block b holds row b·kb + r in its high nibble and row b·kb + kb/2
// + r in its low nibble, each offset by +8 (the row halves of a block pack
// along the CONTRACTION axis; the KV codec packs channel halves instead);
// qs is f32 [nb, n_p], one scale per (k-block, channel). Each k-block's
// partial dot is summed in f32 and its scale folded in AFTER the dot (acc =
// acc + part · s, two roundings), never by dequantizing the weight first:
// on codes whose scales are 1 and small-integer x the result is exact.
//
// This replaces the port's first kernel, whose products were f32 FMAs
// from shared memory: a 16 × 32 block walked all of K in 32-row steps, each
// behind two barriers and a dependent global load (24–96 serial steps), on
// 24–96 blocks for 132 SMs: 24–27 µs a d = 768 decode projection, 33–124
// µs at a 256-row chunk.
//
// What bounds it on this card. At the decode tick (m = 16 slots) every code
// byte is read once for 2·16 operations: bytes bound it, 0.3 µs for
// GPT-2-small's int4 wqkv at 3.35 TB/s, far below a launch. What a launch
// can win is latency, and each block is a few dependent chains on one warp
// a scheduler: setting up, issuing the loads, the mmas, a cluster barrier
// and a merge across the cluster. At a 256-row prefill chunk the bound is the
// bytes of the f32 output and the codes (~1 µs) against 2·256·d·n
// operations at the bf16 tensor-core rate (~1 µs); below mma.sync's own
// rate, the pipeline's fill and the merge keep it well above that bound.
//
// Design. bf16 x runs on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
// sums; mma_bf16.cuh). Products of a bf16 x and an integer code are exact
// in f32 (int8 and int4 codes are exact in bf16), so only the order of the
// sum differs from the plain version. K is cut into units of 32 k, two
// mma steps (int8: 32 code rows; int4: 16, the high and the low nibbles of
// the same bytes).
// Codes go global → shared memory as raw bytes (cp.async, 16 bytes a
// copy, coalesced) and are unpacked to bf16 B fragments in registers,
// never to f32 or device memory:
//  - int4: a lane takes the bytes of code rows (2t, 2t+1) and (2t+8, 2t+9)
//    of a unit (int8: of each 16-row step), one prmt puts two bytes in the
//    halves of a word, a mask and
//    an or make bf16(128 + v) of both nibbles (bits 0x4300 | v), and one
//    bf16x2 subtract of 136 gives v − 8 exactly. The high nibbles feed one
//    mma (x's run at b·kb + r0), the low nibbles a second (x's run at b·kb +
//    kb/2 + r0): the mma's k index runs over the unit's rows, for x and
//    codes alike;
//  - int8: a word's bytes xor 0x80 are c + 128; a prmt puts one into the
//    mantissa of 2^23 (exact), minus 2^23 + 128 in f32, then to bf16x2.
// A lane reads 4 contiguous code bytes of a row (byte e feeds n-tile e at n
// position g), so lane (g, t) owns channels 8t .. 8t + 7 of its warp's 32.
// x is staged unit by unit ([rows][high run, low run] for int4, zero-filled
// past m, past d and past a k-block's end, so a kb with kb % 16 == 8 reads
// nothing of the next block) and read by ldmatrix. Each k-block's scale
// row is staged with the unit after which the warps fold it.
//
// Blocks: 128 channels × 16 rows (the decode regime, m <= 16: one mma M
// tile, rows past m zero) or × 64 rows (the chunk regime: a B fragment
// feeds 4 mmas), 4 warps of 32 channels each. Units stream through a
// 4-stage cp.async ring (decode: 4 units a stage, one warp loading each;
// chunk: 2, two warps each), and a split's x is read once. K splits over
// the blocks of a thread-block cluster (grid.z = splits <= 8, chosen by
// ops/quantization.py::_qmm_plan where the tiles alone leave SMs idle: n =
// 768 still runs 48 blocks at decode). Each block leaves its f32 sums in
// its shared memory; after a cluster barrier it adds its share of the tile
// from every block's shared memory (distributed shared memory) in split
// order and writes it. No atomics: two calls give identical bits. (The
// last-arriving-block merge through device memory that paged_attn.cu uses
// costs a fence, an atomic and a reload on the critical path.)
//
// f32 x keeps an FMA body (a tensor-core product would round f32 to TF32):
// 16 rows × 32 channels a block over all of K; f32 x is not on the main
// path. Rows past m and k past d read as 0 and only columns < n are
// written, so out is not padded; bf16 x must have d % 4 == 0 and 8-byte
// aligned rows (the wrapper pads a copy otherwise).
//
// Interface: plain C, loaded with ctypes. qmm returns a cudaError_t (0 on
// success): the launch is checked with cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using mma_bf16::bf16;

constexpr int NT = 128;  // threads per block, both bodies

// ---------------------------------------------------------------------------
// the arguments of one launch
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  const uint8_t* qw;
  const float* qs;
  float* out;
  int m, d, n, n_p, kb, nb;
  int rows_pb;  // code rows of a k-block: kb (int8) or kb / 2 (int4)
  int upb;      // units of a k-block
  int splits;   // K splits: the blocks of one cluster (grid.z)
  int x16;      // x rows and every unit's x runs are 16-byte aligned: x moves 8 elements a copy
};

// ---------------------------------------------------------------------------
// the tensor-core body (bf16 x)
// ---------------------------------------------------------------------------

constexpr int BN = 128;           // channels of a block tile
constexpr int WN = BN / 4;        // channels of a warp: the 4 warps split the tile's channels
constexpr int NT8 = WN / 8;       // n8 tiles of a warp = code bytes a lane reads of a row
static_assert(NT8 == 4, "a lane's 8 channels are stored as two float4s");
constexpr int CODE_LD = BN + 16;  // bytes of a staged code row (no bank conflicts)
constexpr int MAX_SPLITS = 8;     // K splits, at most: a portable cluster
constexpr int RED_LD = BN + 4;    // f32 of a row of the block's sums in shared memory

// decode (16 rows): 4 units a stage, each loaded by one warp; chunk (64
// rows): 2 units a stage, each loaded by two warps; 4 stages in both
template <int BM>
struct Cfg {
  static constexpr int MT = BM / 16;  // m16 tiles of a warp
  static constexpr int CH = BM == 16 ? 4 : 2;
  static constexpr int NS = 4;
  static constexpr int WPU = 4 / CH;  // warps loading a unit
};

// A unit of K: 32 k, two 16-deep mma steps. int4: 16 code rows, whose
// high nibbles are the unit's first 16 k (x's run at b·kb + r0) and low
// nibbles its last 16 (x's run at b·kb + kb/2 + r0); int8: 32 code rows.
template <bool INT4>
struct Unit {
  static constexpr int UR = INT4 ? 16 : 32;  // code rows of a unit
  static constexpr int KU = 32;              // k of a unit
  static constexpr int XLD = KU + 8;         // bf16 of a staged x row (ldmatrix without conflicts)
};

template <bool INT4, int BM>
struct Smem {
  using C = Cfg<BM>;
  static constexpr int codes = C::CH * Unit<INT4>::UR * CODE_LD;  // bytes of a stage's codes
  static constexpr int scales = C::CH * BN * 4;                // the units' scale rows
  static constexpr int xs = C::CH * BM * Unit<INT4>::XLD * 2;  // the units' x
  static constexpr int stage = codes + scales + xs;
  static constexpr int ring = C::NS * stage;
  static constexpr int red = BM * RED_LD * 4;  // the block's sums, after the loop
  static constexpr int bytes = ring > red ? ring : red;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(mma_bf16::smem_u32(dst)), "l"(src),
               "r"(valid ? 8 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Part q (of WPU) of staging unit (b, r0) into stage position p, by one
// warp: the unit's code rows × 128 channels, its k-block's scale row
// (part 0, only for a unit after which the warps fold the scales), and the
// BM × KU x values it meets, in 16-byte copies (x in W-element ones: 8,
// or 4 where a run is not 16-byte aligned), zero-filled where invalid.
template <int W, bool INT4, int BM>
__device__ __forceinline__ void load_x(const Args& a, bf16* xs, int m0, int k0, int r0, int q, int lane) {
  using U = Unit<INT4>;
  constexpr int CPR = U::KU / W, N = BM * CPR / Cfg<BM>::WPU;  // copies of a row, of the part
  static_assert(N % 32 == 0, "whole copies for every lane");
  const bf16* x = static_cast<const bf16*>(a.x);
#pragma unroll
  for (int j = 0; j < N / 32; ++j) {
    const int c = q * N + j * 32 + lane, r = c / CPR, kk = W * (c % CPR);
    const int i = INT4 ? kk % 16 : kk;                          // the code row of the unit
    const int k = k0 + (INT4 ? kk / 16 * a.rows_pb : 0) + i;  // int4: kk / 16 the nibble run
    const bool ok = m0 + r < a.m && r0 + i < a.rows_pb && k < a.d;
    const bf16* src = ok ? x + (size_t)(m0 + r) * a.d + k : x;
    if constexpr (W == 8)
      mma_bf16::cp_async16(xs + r * U::XLD + kk, src, ok);
    else
      cp_async8(xs + r * U::XLD + kk, src, ok);
  }
}

template <bool INT4, int BM>
__device__ __forceinline__ void load_unit(const Args& a, uint8_t* stage, int p, int q, int b, int r0, int m0,
                                          int n0, bool fold, int lane) {
  using S = Smem<INT4, BM>;
  constexpr int N = Unit<INT4>::UR * BN / 16 / Cfg<BM>::WPU;  // 16-byte copies of the part's codes
  const uint8_t* code = a.qw + (size_t)(b * a.rows_pb + r0) * a.n_p + n0;
  uint8_t* codes = stage + p * Unit<INT4>::UR * CODE_LD;
#pragma unroll
  for (int j = 0; j < N / 32; ++j) {
    const int c = q * N + j * 32 + lane, row = c / 8, col = 16 * (c % 8);
    const bool ok = r0 + row < a.rows_pb;
    mma_bf16::cp_async16(codes + row * CODE_LD + col, ok ? code + (size_t)row * a.n_p + col : a.qw, ok);
  }
  if (fold && q == 0)
    mma_bf16::cp_async16(stage + S::codes + p * BN * 4 + 16 * lane, a.qs + (size_t)b * a.n_p + n0 + 4 * lane,
                         true);
  bf16* xs = reinterpret_cast<bf16*>(stage + S::codes + S::scales) + p * BM * Unit<INT4>::XLD;
  if (a.x16)
    load_x<8, INT4, BM>(a, xs, m0, b * a.kb + r0, r0, q, lane);
  else
    load_x<4, INT4, BM>(a, xs, m0, b * a.kb + r0, r0, q, lane);
}

// Two int4 code bytes (byte e of words lo and hi, the lower k row in lo)
// as the bf16x2 B registers of their high nibbles ([0]) and low nibbles
// ([1]).
__device__ __forceinline__ void unpack_int4(uint32_t (&b)[2], uint32_t lo, uint32_t hi, int e) {
  const uint32_t t = __byte_perm(lo, hi, e | ((4 + e) << 8));  // byte e of lo in byte 0, of hi in byte 2
  uint32_t hn = ((t >> 4) & 0x000F000Fu) | 0x43004300u;       // bf16(128 + v), v the high nibbles
  uint32_t ln = (t & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  __nv_bfloat162 vh = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&hn), off);
  __nv_bfloat162 vl = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&ln), off);
  b[0] = *reinterpret_cast<uint32_t*>(&vh);
  b[1] = *reinterpret_cast<uint32_t*>(&vl);
}

// Two int8 code bytes (byte e of words lo and hi, each already xor 0x80:
// c + 128) as one bf16x2 B register: a prmt puts the byte in the mantissa
// of 2^23 (bits 0x4B0000XX), minus 2^23 + 128 gives c, exact in f32 and
// bf16.
__device__ __forceinline__ uint32_t unpack_int8(uint32_t lo, uint32_t hi, int e) {
  const float f0 = __uint_as_float(__byte_perm(lo, 0x4B000000u, e | 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(hi, 0x4B000000u, e | 0x7440)) - 8388736.f;
  return mma_bf16::pack_bf16(f0, f1);
}

// c += a b (mma_bf16::mma without volatile: a register-only product the
// compiler may schedule among the unpacking and the next unit's loads)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One staged unit through the warp's mmas into part: the warp's BM rows ×
// 32 channels from channel wc of the tile, 2 mma steps of 16 k.
template <bool INT4, int BM>
__device__ __forceinline__ void mma_unit(float (&part)[Cfg<BM>::MT][NT8][4], const uint8_t* codes,
                                         const bf16* xs, int wc, int lane) {
  using C = Cfg<BM>;
  using U = Unit<INT4>;
  const int g = lane / 4, t = lane % 4;
  uint32_t a[C::MT][2][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mma_bf16::ldsm_x4(a[mt][h], xs + (mt * 16 + (lane & 15)) * U::XLD + h * 16 + (lane >> 4) * 8);
  // byte e of a word is channel wc + NT8 · g + e: n-tile e at n position g;
  // the mma's k rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1) of each step
  // are code rows 2t, 2t + 1, 2t + 8, 2t + 9 (int4: of both steps, high and
  // low nibbles; int8: of step h, from row 16h)
  uint32_t b0[NT8][2], b1[NT8][2];
#pragma unroll
  for (int h = 0; h < (INT4 ? 1 : 2); ++h) {
    const uint8_t* col = codes + (16 * h) * CODE_LD + wc + NT8 * g;
    const uint32_t flip = INT4 ? 0u : 0x80808080u;  // int8: c + 128 in every byte
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(col + (2 * t) * CODE_LD) ^ flip;
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(col + (2 * t + 1) * CODE_LD) ^ flip;
    const uint32_t w8 = *reinterpret_cast<const uint32_t*>(col + (2 * t + 8) * CODE_LD) ^ flip;
    const uint32_t w9 = *reinterpret_cast<const uint32_t*>(col + (2 * t + 9) * CODE_LD) ^ flip;
#pragma unroll
    for (int e = 0; e < NT8; ++e) {
      if constexpr (INT4) {
        unpack_int4(b0[e], w0, w1, e);
        unpack_int4(b1[e], w8, w9, e);
      } else {
        b0[e][h] = unpack_int8(w0, w1, e);
        b1[e][h] = unpack_int8(w8, w9, e);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < NT8; ++e)
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) mma(part[mt][e], a[mt][h], b0[e][h], b1[e][h]);
}

// Float4 i of the block's BM × 128 sums in shared memory, summed over the
// splits' blocks of the cluster in split order, into out: rows < m and
// channels < n. The loads come first and unconditionally, so that an
// unrolled loop keeps several float4s' loads in flight.
template <int BM>
__device__ __forceinline__ void merge_out(const Args& a, cg::cluster_group& cluster, float* red, int m0, int n0,
                                          int i) {
  const int off = 4 * i / BN * RED_LD + 4 * i % BN;
  float4 o[MAX_SPLITS];
#pragma unroll
  for (int s = 0; s < MAX_SPLITS; ++s)
    if (s < a.splits) o[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, s) + off);
  float4 v = o[0];
#pragma unroll
  for (int s = 1; s < MAX_SPLITS; ++s)
    if (s < a.splits) {
      v.x = __fadd_rn(v.x, o[s].x), v.y = __fadd_rn(v.y, o[s].y);
      v.z = __fadd_rn(v.z, o[s].z), v.w = __fadd_rn(v.w, o[s].w);
    }
  const int row = m0 + 4 * i / BN, col = n0 + 4 * i % BN;
  if (row >= a.m || col >= a.n) return;
  float* out = a.out + (size_t)row * a.n + col;
  if (a.n % 4 == 0) {
    *reinterpret_cast<float4*>(out) = v;
  } else {
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (col + q < a.n) out[q] = vals[q];
  }
}

template <bool INT4, int BM>
__device__ void tc_body(const Args& a) {
  using C = Cfg<BM>;
  using S = Smem<INT4, BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int wc = warp * WN;  // the warp's first channel in the tile
  const int units = a.nb * a.upb;
  const int u_begin = split * units / a.splits;
  const int n_units = (split + 1) * units / a.splits - u_begin;
  const int n_chunks = (n_units + C::CH - 1) / C::CH;

  float part[C::MT][NT8][4], acc[C::MT][NT8][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int e = 0; e < NT8; ++e)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[mt][e][q] = acc[mt][e][q] = 0.f;

  // Warp w loads part w % WPU of unit w / WPU of each chunk: its k-block lb,
  // first code row lr0 (the split's units in order, CH on per chunk).
  const int lp = warp / C::WPU, lq = warp % C::WPU;
  constexpr int UR = Unit<INT4>::UR;
  int lb = (u_begin + lp) / a.upb, lr0 = (u_begin + lp) % a.upb * UR, loaded = 0;
  auto load_chunk = [&]() {
    const int i = loaded + lp;  // the warp's unit in the split
    if (i < n_units) {
      load_unit<INT4, BM>(a, smem + (loaded / C::CH % C::NS) * S::stage, lp, lq, lb, lr0, m0, n0,
                          lr0 + UR >= a.rows_pb || i + 1 == n_units, lane);
      for (lr0 += C::CH * UR; lr0 >= a.upb * UR; lr0 -= a.upb * UR) ++lb;
    }
    loaded += C::CH;
  };
#pragma unroll 1
  for (int c = 0; c < C::NS - 1; ++c) {
    load_chunk();
    mma_bf16::cp_async_commit();
  }
  int cr0 = u_begin % a.upb * UR;  // the first code row of the unit computed next
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    load_chunk();
    mma_bf16::cp_async_commit();
    cp_async_wait<C::NS - 1>();  // chunk c is in
    __syncthreads();
    const uint8_t* stage = smem + (c % C::NS) * S::stage;
#pragma unroll
    for (int p = 0; p < C::CH; ++p) {
      const int i = c * C::CH + p;
      if (i >= n_units) break;
      const bool fold = cr0 + UR >= a.rows_pb || i + 1 == n_units;
      cr0 = cr0 + UR >= a.rows_pb ? 0 : cr0 + UR;
      mma_unit<INT4, BM>(part, stage + p * UR * CODE_LD,
                         reinterpret_cast<const bf16*>(stage + S::codes + S::scales) + p * BM * Unit<INT4>::XLD,
                         wc, lane);
      if (fold) {  // the k-block's dot is done: fold its scales
        const float* sc = reinterpret_cast<const float*>(stage + S::codes) + p * BN + wc + 2 * NT8 * t;
#pragma unroll
        for (int e = 0; e < NT8; ++e) {
          const float s0 = sc[e], s1 = sc[NT8 + e];
#pragma unroll
          for (int mt = 0; mt < C::MT; ++mt) {
            acc[mt][e][0] = __fadd_rn(acc[mt][e][0], __fmul_rn(part[mt][e][0], s0));
            acc[mt][e][1] = __fadd_rn(acc[mt][e][1], __fmul_rn(part[mt][e][1], s1));
            acc[mt][e][2] = __fadd_rn(acc[mt][e][2], __fmul_rn(part[mt][e][2], s0));
            acc[mt][e][3] = __fadd_rn(acc[mt][e][3], __fmul_rn(part[mt][e][3], s1));
#pragma unroll
            for (int q = 0; q < 4; ++q) part[mt][e][q] = 0.f;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the stage before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

  // The block's sums into shared memory, [BM][RED_LD]: lane (g, t) holds
  // channels 8t .. 8t + 7 of the warp's 32 (c0/c2 of n-tiles 0..3, then
  // c1/c3), rows g and g + 8, stored as float4s free of bank conflicts.
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {  // rows g, g + 8
      float* r = red + (mt * 16 + g + 8 * hr) * RED_LD + wc + 2 * NT8 * t;
      *reinterpret_cast<float4*>(r) = make_float4(acc[mt][0][2 * hr], acc[mt][1][2 * hr], acc[mt][2][2 * hr],
                                                  acc[mt][3][2 * hr]);
      *reinterpret_cast<float4*>(r + NT8) = make_float4(acc[mt][0][2 * hr + 1], acc[mt][1][2 * hr + 1],
                                                        acc[mt][2][2 * hr + 1], acc[mt][3][2 * hr + 1]);
    }
  // The splits of a tile are the blocks of one cluster: each block merges a
  // share of the tile from every block's shared memory, in split order (no
  // atomics: two calls give identical bits).
  constexpr int V4 = BM * BN / 4;  // float4 of the tile
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int end = (split + 1) * V4 / a.splits;
#pragma unroll 4
  for (int i = split * V4 / a.splits + threadIdx.x; i < end; i += NT) merge_out<BM>(a, cluster, red, m0, n0, i);
  if (a.splits > 1) cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// the FMA body (f32 x): 16 rows × 32 channels a block over all of K
// ---------------------------------------------------------------------------

constexpr int FM = 16;  // rows per block
constexpr int FN = 32;  // channels per block
constexpr int FK = 32;  // code rows staged per k-step
constexpr int RPT = FM / (NT / FN);  // rows per thread: 4

// One k-step into the shared tiles: codes as f32 [FK][FN] (int4: the 16
// byte rows' high nibbles, then their low nibbles) and x [FM][FK].
template <bool INT4>
__device__ __forceinline__ void fma_stage(const Args& a, int step, int spb, int m0, int n0, float (*ws)[FN],
                                          float (*xs)[FK + 1]) {
  const int tid = threadIdx.x;
  const int b = step / spb;
  const float* x = static_cast<const float*>(a.x);
  const int rpb = INT4 ? FK / 2 : FK;  // code rows a step reads
  const int r0 = (step % spb) * rpb;
  for (int idx = tid; idx < rpb * FN; idx += NT) {
    const int i = idx / FN, c = idx % FN;
    const bool ok = r0 + i < a.rows_pb;
    const uint32_t byte = ok ? a.qw[(size_t)(b * a.rows_pb + r0 + i) * a.n_p + n0 + c] : (INT4 ? 0x88u : 0u);
    if (INT4) {
      ws[i][c] = (float)((int)(byte >> 4) - 8);
      ws[FK / 2 + i][c] = (float)((int)(byte & 0xFu) - 8);
    } else {
      ws[i][c] = (float)(int8_t)byte;
    }
  }
  for (int idx = tid; idx < FM * FK; idx += NT) {
    const int r = idx / FK, c = idx % FK;
    const int h = INT4 ? c / (FK / 2) : 0, i = INT4 ? c % (FK / 2) : c;
    const int k = b * a.kb + h * a.rows_pb + r0 + i;
    const bool ok = m0 + r < a.m && r0 + i < a.rows_pb && k < a.d;
    xs[r][c] = ok ? x[(size_t)(m0 + r) * a.d + k] : 0.f;
  }
}

template <bool INT4>
__device__ void fma_body(const Args& a) {
  __shared__ float ws[FK][FN];
  __shared__ float xs[FM][FK + 1];
  const int lane = threadIdx.x % FN, grp = threadIdx.x / FN;
  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  const int rpb = INT4 ? FK / 2 : FK;
  const int spb = (a.rows_pb + rpb - 1) / rpb;
  const int steps = a.nb * spb;
  float acc[RPT], part[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = part[r] = 0.f;
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // every thread is done with the previous step's tiles
    fma_stage<INT4>(a, s, spb, m0, n0, ws, xs);
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < FK; ++i) {
      const float w = ws[i][lane];
#pragma unroll
      for (int r = 0; r < RPT; ++r) part[r] = fmaf(xs[grp * RPT + r][i], w, part[r]);
    }
    if ((s + 1) % spb == 0) {  // the k-block is done: fold its scale
      const float scale = a.qs[(size_t)(s / spb) * a.n_p + n0 + lane];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(part[r], scale));
        part[r] = 0.f;
      }
    }
  }
  const int col = n0 + lane;
  if (col >= a.n) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = m0 + grp * RPT + r;
    if (row < a.m) a.out[(size_t)row * a.n + col] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// the kernel, routed by x's type, and its launch
// ---------------------------------------------------------------------------

template <typename T, bool INT4, int BM>
__global__ void __launch_bounds__(NT) qmm_kernel(Args a) {
  if constexpr (std::is_same_v<T, float>)
    fma_body<INT4>(a);
  else
    tc_body<INT4, BM>(a);
}

template <bool INT4, int BM>
cudaError_t launch_tc(const Args& a, cudaStream_t st) {
  constexpr int smem = Smem<INT4, BM>::bytes;
  auto kern = qmm_kernel<bf16, INT4, BM>;
  // the shared-memory limit is the function's on the current device: set it
  // once a device (a failure is returned, and the next launch tries again)
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(smem_set.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n + BN - 1) / BN, (a.m + BM - 1) / BM, a.splits);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = a.splits;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool INT4>
cudaError_t launch_fma(const Args& a, cudaStream_t st) {
  const dim3 grid((a.n + FN - 1) / FN, (a.m + FM - 1) / FM);
  qmm_kernel<float, INT4, FM><<<grid, NT, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// out [m, n] f32 = x [m, d] (f32, or bf16 when x_bf16) @ dequant(qw, qs).
// qw: int8 [nb·kb, n_p], or (int4) uint8 [nb·kb/2, n_p]; qs: f32 [nb, n_p];
// kb % 8 == 0, n_p % 128 == 0, qw and qs 16-byte aligned. bf16 x (d % 4 ==
// 0, 8-byte aligned) runs the decode regime for m <= 16 and the chunk regime
// above, with `splits` K splits, the blocks of a cluster (1 <= splits <= 8,
// at most the units of the weight); f32 x takes splits = 1. Returns
// a cudaError_t.
extern "C" int qmm(const void* x, const void* qw, const void* qs, void* out, int m, int d, int n, int n_p,
                   int kb, int nb, int x_bf16, int int4, int splits, void* stream) {
  if (kb % 8 || n_p % BN || n > n_p || d > nb * kb || m < 1 || splits < 1 || splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(qw) % 16 || reinterpret_cast<uintptr_t>(qs) % 16)
    return (int)cudaErrorMisalignedAddress;
  Args a;
  a.x = x;
  a.qw = static_cast<const uint8_t*>(qw);
  a.qs = static_cast<const float*>(qs);
  a.out = static_cast<float*>(out);
  a.m = m, a.d = d, a.n = n, a.n_p = n_p, a.kb = kb, a.nb = nb;
  a.rows_pb = int4 ? kb / 2 : kb;
  const int ur = int4 ? Unit<true>::UR : Unit<false>::UR;
  a.upb = (a.rows_pb + ur - 1) / ur;
  a.splits = splits;
  a.x16 = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && a.rows_pb % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return int4 ? launch_fma<true>(a, s) : launch_fma<false>(a, s);
  }
  if (d % 4 || reinterpret_cast<uintptr_t>(x) % 8) return (int)cudaErrorMisalignedAddress;
  if (splits > nb * a.upb) return (int)cudaErrorInvalidValue;
  if (m <= 16) return int4 ? launch_tc<true, 16>(a, s) : launch_tc<false, 16>(a, s);
  return int4 ? launch_tc<true, 64>(a, s) : launch_tc<false, 64>(a, s);
}

extern "C" const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
