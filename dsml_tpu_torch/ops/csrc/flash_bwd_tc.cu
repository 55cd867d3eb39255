// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16 inputs:
// two kernels, dq and dk/dv.
//
// Replaces dsml_tpu/ops/flash.py::_dq_kernel (:481) and ::_dkv_kernel
// (:526), the Pallas TPU kernels behind the custom VJP of flash_attention /
// flash_attention_lse, for bf16 q, k, v and do (f32 inputs keep the FMA
// kernels of flash_bwd.cu: a tensor-core product of f32 values rounds them
// to TF32, about three decimal digits). Same function as there. With
// s = q kᵀ · d^-½ masked to -1e30 (global positions: q_start + row >=
// k_start + col under the causal mask, and the ragged kv edge col < s_kv),
// p = exp(s - lse) from the lse the forward saved (f32 [bh, s_q]),
// dp = do vᵀ, ds = p · (dp - delta + g_lse) where delta = rowsum(do · out)
// (computed by the caller, as the TPU code does outside Pallas) and g_lse
// is the cotangent of the lse output:
//   dq = d^-½ · Σ_kv ds k                      (flash_bwd_dq_tc_kernel)
//   dv = Σ_q pᵀ do,  dk = d^-½ · Σ_q dsᵀ q     (flash_bwd_dkv_tc_kernel)
//
// What bounds it. At GPT-2-small's training shape (bf16 [96, 1024, 64],
// causal) the dq kernel does 3 products of 2·d operations per kept score
// and the dk/dv kernel 4: 19 and 26 GFLOP against 64 and 77 MB of inputs
// and outputs, about 300 operations per byte, just above the H100's bf16
// ridge (~295): the least time is set by the tensor cores' rate.
//
// Design. Every product runs on mma.sync.m16n8k16 (bf16 in, f32 sums),
// 64-row tiles, 4 warps per block, each warp owning 16 of the block's 64
// rows. The TPU carries each accumulator across a sequential grid axis;
// here one block owns it and walks the other axis in a loop, with the sum
// in f32 registers: one block per (batch·head, 64 q rows) for dq, walking
// the kv tiles up to the causal diagonal, heaviest q tiles first; one per
// (batch·head, 64 kv rows) for dk/dv, walking the q tiles from the first
// one that reaches it. No atomics: the sums run in one order, so the
// result is the same run to run. Keeping the TPU's two-kernel split
// recomputes p in both kernels.
//   - Operands come from shared memory through ldmatrix (.trans for the
//     second products, whose B operand is a [k][n] tile). Rows are padded
//     by 8 bf16 (stride 144 or 272 bytes), so the 8 row addresses of an
//     8×8 matrix fall on 8 distinct groups of 4 banks: no bank conflicts.
//   - p and ds never touch shared memory: the f32 accumulator fragment of
//     s becomes p, then ds, in registers, and its m16n8 C-fragment pairs,
//     rounded to bf16, are the m16k16 A fragment of the next product. The
//     dk/dv kernel computes sᵀ = k qᵀ and dpᵀ = v doᵀ directly, so pᵀ and
//     dsᵀ are already A operands of dv += pᵀ do and dk += dsᵀ q. Its row
//     statistics (lse, delta - g_lse) are per column there, so they stream
//     through shared memory with the q tile.
//   - The block loads the tiles it keeps (q and do for dq; k and v for
//     dk/dv) once, and streams the tiles it walks through a 2-stage
//     cp.async ring: tile t+1 is in flight while tile t's products run,
//     with one barrier per tile. Ragged tails use the zero-fill form
//     (src-size 0), so no padded copy is made; rows must start 16-byte
//     aligned (the wrapper checks data_ptr()).
//   - p = exp2(s · d^-½ · log2 e - lse · log2 e), one FMA and one exp2.
//   - Registers: a dk/dv thread holds dk and dv (32 f32 each at d = 64,
//     64 at d = 128), so the block takes each q tile in two 32-column
//     halves (QC) and sᵀ and dpᵀ take 16 each; k and v are read from
//     shared memory for each product. Both kernels build at d = 64 within
//     168 registers with no spills, so an SM runs 3 blocks (12 warps);
//     holding a whole 64-column tile took 218 registers, and 2 blocks.
//
// Interface: plain C, loaded with ctypes. Each launcher returns a
// cudaError_t (0 on success), checked with cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // rows a block owns: q rows (dq) or kv rows (dk/dv)
constexpr int BN = 64;        // rows of each streamed tile
constexpr int NT = 128;       // 4 warps, each owning 16 of the block's BM rows
constexpr int PAD = 8;        // bf16 of padding per shared row
constexpr int QC = 32;        // q columns per pass over sᵀ and dpᵀ in the dk/dv kernel
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int tile_elems() { return BN * (D + PAD); }

// Blocks an SM runs at once, given to ptxas as the register budget: 3 at
// d = 64 (168 registers a thread, with no spills), 2 at d = 128, where
// shared memory holds no more.
template <int D>
__host__ __device__ constexpr int min_blocks() { return D == 64 ? 3 : 2; }

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
// tile by cp.async; rows past n are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0, int n) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int j = 0; j < BN * CPR / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool valid = r0 + r < n;
    cp_async16(dst + r * (D + PAD) + c, src + (size_t)(valid ? r0 + r : 0) * D + c, valid);
  }
}

// lse, delta and g_lse of q rows q0 .. q0 + 63 into st[0..63], st[64..127]
// and st[128..191] by cp.async; rows past s_q read 0, and so does a null glse
__device__ __forceinline__ void load_stats(float* st, const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           const float* __restrict__ glse, size_t base, int q0,
                                           int s_q) {
  const int r = threadIdx.x % BM;
  const bool valid = q0 + r < s_q;
  const size_t at = base + (valid ? q0 + r : 0);
  if (threadIdx.x < BM) {
    cp_async4(st + r, lse + at, valid);
    if (glse) cp_async4(st + 2 * BM + r, glse + at, valid);
    else st[2 * BM + r] = 0.f;
  } else {
    cp_async4(st + BM + r, delta + at, valid);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 6 * (size_t)tile_elems<D>();  // q, do; 2 stages of (k, v)
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * 6 * (size_t)tile_elems<D>() + sizeof(float) * 2 * 3 * BM;  // + 2 stages of stats
}

// One block per (batch·head = blockIdx.y, 64 q rows). Warp w owns q rows
// 16w .. 16w + 15; a thread's accumulator rows are g and g + 8 of those.
template <int D>
__global__ void __launch_bounds__(NT, min_blocks<D>())
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ glse, bf16* __restrict__ dq, int s_q, int s_kv,
                       int q_start, int k_start, int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int TILE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + TILE;
  bf16* skv = sdo + TILE;  // stage i: k at skv + 2i·TILE, v after it

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heaviest (last) q tiles first
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t q_base = (size_t)bh * s_q * D, kv_base = (size_t)bh * s_kv * D;

  int n_tiles = (s_kv + BN - 1) / BN;
  if (causal) {
    // kv tiles whose first column lies after this q tile's last row add nothing
    const int reach = q_start + min(q0 + BM, s_q) - 1 - k_start;
    n_tiles = reach < 0 ? 0 : min(n_tiles, reach / BN + 1);
  }

  load_tile<D>(sq, q + q_base, q0, s_q);
  load_tile<D>(sdo, dout + q_base, q0, s_q);
  if (n_tiles > 0) {
    load_tile<D>(skv, k + kv_base, 0, s_kv);
    load_tile<D>(skv + TILE, v + kv_base, 0, s_kv);
  }
  cp_async_commit();

  // this thread's rows: lse · log2 e and delta - g_lse; rows past s_q read 0
  const float sl2 = scale * LOG2E;
  int row[2];
  float lse2[2], dg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const bool in = row[h] < s_q;
    const size_t at = (size_t)bh * s_q + row[h];
    lse2[h] = in ? lse[at] * LOG2E : 0.f;
    dg[h] = in ? delta[at] - (glse ? glse[at] : 0.f) : 0.f;
  }

  // per-lane ldmatrix offsets: A from a [row][k] tile, B from an [n][k]
  // tile, B (.trans) from a [k][n] tile
  const int a_off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_0();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t + 1 < n_tiles) {
      bf16* nxt = skv + ((t + 1) & 1) * 2 * TILE;
      load_tile<D>(nxt, k + kv_base, (t + 1) * BN, s_kv);
      load_tile<D>(nxt + TILE, v + kv_base, (t + 1) * BN, s_kv);
    }
    cp_async_commit();
    const bf16* sk = skv + (t & 1) * 2 * TILE;
    const bf16* sv = sk + TILE;
    const int kv0 = t * BN;

    // s = q kᵀ and dp = do vᵀ: 16 × 64 per warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, sq + a_off + kk * 16);
      ldsm_x4(ao, sdo + a_off + kk * 16);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, sk + np * 16 * LD + b_off + kk * 16);
        mma(s[2 * np], aq, b[0], b[1]);
        mma(s[2 * np + 1], aq, b[2], b[3]);
        ldsm_x4(b, sv + np * 16 * LD + b_off + kk * 16);
        mma(dp[2 * np], ao, b[0], b[1]);
        mma(dp[2 * np + 1], ao, b[2], b[3]);
      }
    }

    // p = exp(s·scale - lse) with the masks, then ds = p (dp - delta + g_lse), in place
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = kv0 + n * 8 + 2 * t4 + (e & 1);
        const bool keep = col < s_kv && (!causal || q_start + row[h] >= k_start + col);
        const float p = row[h] < s_q ? exp2f(keep ? fmaf(s[n][e], sl2, -lse2[h]) : NEG_INF) : 0.f;
        s[n][e] = p * (dp[n][e] - dg[h]);
      }

    // dq += ds k: ds from the registers, k through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t a[4];
      to_a_frag(a, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t b[4];
        ldsm_x4_t(b, sk + j * 16 * LD + bt_off + dn * 16);
        mma(acc[2 * dn], a, b[0], b[1]);
        mma(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait_0();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= s_q) continue;
    bf16* dst = dq + q_base + (size_t)row[h] * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// One block per (batch·head = blockIdx.y, 64 kv rows). Warp w owns kv rows
// 16w .. 16w + 15; a thread's accumulator rows are g and g + 8 of those.
template <int D>
__global__ void __launch_bounds__(NT, min_blocks<D>())
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ glse, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int s_q, int s_kv, int q_start, int k_start,
                        int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int TILE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + TILE;
  bf16* sqd = sv + TILE;                                 // stage i: q at sqd + 2i·TILE, do after it
  float* stats = reinterpret_cast<float*>(sqd + 4 * TILE);  // stage i at stats + 3i·BM

  const int kv0 = blockIdx.x * BN;  // the first kv tiles see the most q tiles under a causal mask
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const size_t q_base = (size_t)bh * s_q * D, kv_base = (size_t)bh * s_kv * D;
  const size_t st_base = (size_t)bh * s_q;

  const int n_tiles = (s_q + BM - 1) / BM;
  int t0 = 0;
  if (causal) {
    // q tiles whose last row lies before this kv tile's first column see none of it
    const int x = k_start + kv0 - q_start;
    t0 = x > 0 ? x / BM : 0;
  }

  load_tile<D>(sk, k + kv_base, kv0, s_kv);
  load_tile<D>(sv, v + kv_base, kv0, s_kv);
  if (t0 < n_tiles) {
    bf16* first = sqd + (t0 & 1) * 2 * TILE;
    load_tile<D>(first, q + q_base, t0 * BM, s_q);
    load_tile<D>(first + TILE, dout + q_base, t0 * BM, s_q);
    load_stats(stats + (t0 & 1) * 3 * BM, lse, delta, glse, st_base, t0 * BM, s_q);
  }
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  int krow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) krow[h] = kv0 + warp * 16 + g + 8 * h;

  const int a_off = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int bt_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = t0; t < n_tiles; ++t) {
    cp_async_wait_0();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1's stage
    if (t + 1 < n_tiles) {
      bf16* nxt = sqd + ((t + 1) & 1) * 2 * TILE;
      load_tile<D>(nxt, q + q_base, (t + 1) * BM, s_q);
      load_tile<D>(nxt + TILE, dout + q_base, (t + 1) * BM, s_q);
      load_stats(stats + ((t + 1) & 1) * 3 * BM, lse, delta, glse, st_base, (t + 1) * BM, s_q);
    }
    cp_async_commit();
    const bf16* sq = sqd + (t & 1) * 2 * TILE;
    const bf16* sdo = sq + TILE;
    const float* st = stats + (t & 1) * 3 * BM;
    const int q0 = t * BM;

#pragma unroll
    for (int c = 0; c < BM; c += QC) {
      // sᵀ = k qᵀ and dpᵀ = v doᵀ over q columns c .. c + QC - 1: 16 × QC per warp
      float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, sk + a_off + kk * 16);
        ldsm_x4(av, sv + a_off + kk * 16);
#pragma unroll
        for (int np = 0; np < QC / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, sq + (c + np * 16) * LD + b_off + kk * 16);
          mma(s[2 * np], ak, b[0], b[1]);
          mma(s[2 * np + 1], ak, b[2], b[3]);
          ldsm_x4(b, sdo + (c + np * 16) * LD + b_off + kk * 16);
          mma(dp[2 * np], av, b[0], b[1]);
          mma(dp[2 * np + 1], av, b[2], b[3]);
        }
      }

      // pᵀ and dsᵀ in place; the row statistics belong to the columns here
#pragma unroll
      for (int n = 0; n < QC / 8; ++n) {
        const int qc = c + n * 8 + 2 * t4;  // column in the tile of this thread's pair
        const float2 l2 = *reinterpret_cast<const float2*>(st + qc);
        const float2 dl = *reinterpret_cast<const float2*>(st + BM + qc);
        const float2 gl = *reinterpret_cast<const float2*>(st + 2 * BM + qc);
        const float lse2[2] = {l2.x * LOG2E, l2.y * LOG2E};
        const float dg[2] = {dl.x - gl.x, dl.y - gl.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = e & 1;
          const int qpos = q0 + qc + j;
          const bool keep = krow[h] < s_kv && (!causal || q_start + qpos >= k_start + krow[h]);
          const float p = qpos < s_q ? exp2f(keep ? fmaf(s[n][e], sl2, -lse2[j]) : NEG_INF) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dg[j]);
        }
      }

      // dv += pᵀ do and dk += dsᵀ q: do and q through ldmatrix.trans
#pragma unroll
      for (int j = 0; j < QC / 16; ++j) {
        uint32_t ap[4], ads[4];
        to_a_frag(ap, s[2 * j], s[2 * j + 1]);
        to_a_frag(ads, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t b[4];
          ldsm_x4_t(b, sdo + (c + j * 16) * LD + bt_off + dn * 16);
          mma(dv_acc[2 * dn], ap, b[0], b[1]);
          mma(dv_acc[2 * dn + 1], ap, b[2], b[3]);
          ldsm_x4_t(b, sq + (c + j * 16) * LD + bt_off + dn * 16);
          mma(dk_acc[2 * dn], ads, b[0], b[1]);
          mma(dk_acc[2 * dn + 1], ads, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait_0();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= s_kv) continue;
    const size_t at = kv_base + (size_t)krow[h] * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8) =
          __floats2bfloat162_rn(dk_acc[n][2 * h] * scale, dk_acc[n][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8) =
          __floats2bfloat162_rn(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* glse, void* dq, int bh,
                      int s_q, int s_kv, int q_start, int k_start, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_q + BM - 1) / BM, bh);
  flash_bwd_dq_tc_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, glse, static_cast<bf16*>(dq), s_q, s_kv,
      q_start, k_start, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const float* glse, void* dk,
                       void* dv, int bh, int s_q, int s_kv, int q_start, int k_start, int causal,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s_kv + BN - 1) / BN, bh);
  flash_bwd_dkv_tc_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, glse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s_q, s_kv, q_start, k_start, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q, dout and dq [bh, s_q, d]; k, v, dk and dv [bh, s_kv, d], all bf16,
// contiguous and 16-byte aligned; lse, delta and glse [bh, s_q] f32, glse
// may be null (a zero cotangent). d is 64 or 128; scale is d^-½ as the
// caller rounds it.
extern "C" int flash_bwd_tc_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* glse, void* dq,
                               int bh, int s_q, int s_kv, int d, int q_start, int k_start,
                               int causal, float scale, void* stream) {
  const float *l = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta),
              *g = static_cast<const float*>(glse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, l, dl, g, dq, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, l, dl, g, dq, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_tc_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* glse, void* dk,
                                void* dv, int bh, int s_q, int s_kv, int d, int q_start,
                                int k_start, int causal, float scale, void* stream) {
  const float *l = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta),
              *g = static_cast<const float*>(glse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, l, dl, g, dk, dv, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, l, dl, g, dk, dv, bh, s_q, s_kv, q_start, k_start, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_bwd_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
