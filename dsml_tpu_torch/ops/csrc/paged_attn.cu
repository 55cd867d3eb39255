// Paged attention for Hopper (sm_90a): attention of query rows straight off
// a KV page pool through a page table, with no dense [b, h, S, hd] view.
//
// Replaces two Pallas TPU kernels of dsml_tpu/ops/paged_attention.py:
//   - paged_attn_kernel           <- _kernel (+ _fold_page), the single-buffer
//                                    grid walk (paged_attention(pipeline=False));
//   - paged_attn_pipelined_kernel <- _pipelined_kernel, the 2-deep async page
//                                    prefetch (the default on the card).
// Both compute, per (slot b, kv head h) and the G = rep·C query rows of that
// head's group: s = (q·k in f32)·hd^-½, times the key's scale for quantized
// pools; masked to -1e30 where key_pos > query_pos; a softmax whose max is
// floored at -1e20; p times the value's scale for quantized pools before
// p·v; out = acc / max(l, 1e-30), rounded once to q's type. Pools hold f32
// or bf16 rows (fp pages, in q's type), int8 rows, or int4 rows packed two
// per byte (byte j: channel j in the high nibble, channel j + hd/2 in the
// low one, each offset by +8), with one f32 scale per row for int8/int4. A
// row whose positions are all -1 (a dead slot) reads nothing and returns
// zeros.
//
// What bounds them. A decode tick (C = 1) reads every live page of every
// slot once and does 4·hd operations per key: about one operation per byte,
// so the least time is set by device-memory bytes (~1.5 µs for GPT-2-small's
// 16 slots). A 256-row prefill chunk does 256× the operations on the same
// bytes and is bound by operations. At both shapes the work is small, so
// what the card pays for is latency: a serial chain of loads and barriers
// per block, and blocks that leave the SMs idle.
//
// Design. Split-K over the key axis (flash-decoding). Each (slot, kv head,
// row tile)'s keys are cut into splits of KS = 128 keys; split s covers keys
// [128 s, 128 s + 128) up to the tile's largest position, so the plan is a
// function of the shape and the positions only. The grid is (splits of the
// table, kv heads × row tiles, slots): one block per split, and a block whose
// split lies past its rows' largest position returns at once (split 0 of a
// tile with no live key writes its zeros). A block leaves its split's (m, l,
// acc) in f32 scratch; the last block of a (slot, head, tile) to arrive, by
// an integer counter it resets, merges the partials in split order (rescale
// by exp(m_i - m), sum, divide by max(l, 1e-30)) and writes the output in q's
// type. A tile with one live split writes its output directly. No float
// atomics: two calls on the same inputs give the same bits.
//   - Register regime (f32 queries, and bf16 with G <= 16: decode, the
//     verify window, GQA). Row tiles of 1 row (G = 1) or 4. 4 warps; warp w
//     folds units w and w + 4 (16 keys each) of the split. Within a warp a
//     key is held by L lanes, each holding a 16-byte load's channels (at
//     most 32/R of them, so q and acc take 2·R·CH <= 64 registers); q sits
//     in registers, int4 nibbles and int8 codes are unpacked there, q·k
//     reduces over the L lanes with shuffles; V's rows load with K's where
//     they take at most 16 registers. A unit is folded with one max per
//     row and no block barrier; the warps' partials merge in shared memory
//     once per split.
//   - Tensor-core regime (bf16 queries, G > 16: prefill chunks). Row tiles
//     of 64 (4 warps × 16 rows, q as m16n8k16 A fragments). Keys go through
//     in tiles of 64, unpacked to bf16 in shared memory (exact: the codes
//     are integers of magnitude <= 127), once per 64 rows. s = q kᵀ on
//     mma.sync in f32 sums, times hd^-½ and then the key scale; an online
//     softmax across the split's tiles; p times the value scale, split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi), and p·v as two mma.syncs
//     into one f32 sum (the plain version sums f32 p against f32 v).
// The single-buffer kernel loads each unit's rows with plain loads and
// skips units past the tile's largest position; the pipelined kernel stops
// at the live depth and copies the units into a ring of shared stages by
// cp.async (a 2-stage ring per warp in the register regime, a 2-stage ring
// of 64-key raw tiles in the tensor-core regime) while the previous one
// folds. Both pass the same bytes through the same fold and the same merge
// in the same order, so their outputs are bit-identical; every product
// outside the mma.syncs is an explicit fmaf or __fmul_rn, so the compiler
// contracts nothing differently in the two kernels.
//
// Interface: plain C, loaded with ctypes. paged_attn returns a cudaError_t
// (0 on success): the launch is checked with cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

using mma_bf16::bf16;

constexpr int NT = 128;          // threads of every block
constexpr int NW = NT / 32;      // warps
constexpr int KT = 16;           // keys per unit
constexpr int KS = 128;          // keys per split
constexpr int UPW = KS / KT / NW;  // units per warp in the register regime
constexpr int RMAX = 4;          // rows of the register regime's widest tile
constexpr int TC_ROWS = 64;      // rows of a tensor-core tile
constexpr int TC_KEYS = 64;      // keys per tensor-core step
constexpr float NEG_INF = -1e30f;
constexpr float MAX_FLOOR = -1e20f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(NT == 2 * TC_KEYS && KS % (KT * NW) == 0 && KS % TC_KEYS == 0, "tiles");

enum Codec { FP = 0, INT8 = 1, INT4 = 2 };

// One pool row: stored elements and bytes (a multiple of 16).
template <typename P, int HD, int CODEC>
struct Row {
  static constexpr int W = CODEC == INT4 ? HD / 2 : HD;
  static constexpr int RB = W * (int)sizeof(P);
};

// A partial's record: acc [HD], m, l, padded to 16 bytes.
template <int HD>
__host__ __device__ constexpr int rec_floats() { return HD + 4; }

// Blocks an SM runs at once, given to ptxas as the register budget.
template <int R, int HD>
__host__ __device__ constexpr int min_blocks() { return R == TC_ROWS || (R == RMAX && HD == 128) ? 2 : 3; }

// The register regime's lane layout for R rows.
template <typename P, int HD, int CODEC, int R>
struct Fma {
  static constexpr int CH16 = CODEC == INT4 ? 32 : 16 / (int)sizeof(P);  // channels of 16 bytes
  static constexpr int CH = CH16 < 32 / R ? CH16 : 32 / R;  // channels a lane holds
  static constexpr int CB = CODEC == INT4 ? CH / 2 : CH * (int)sizeof(P);  // bytes it reads of a row
  static constexpr int L = HD / CH;            // lanes per key
  static constexpr int KPW = 32 / L;           // keys per warp pass
  static constexpr int PASSES = KT / KPW;      // passes per unit
  // V's rows are loaded with K's when a unit's take at most 16 registers
  static constexpr bool V_EARLY = PASSES * CB / 4 <= 16;
  static constexpr int RB = Row<P, HD, CODEC>::RB;
  static constexpr int USTAGE = 2 * KT * RB + 2 * KT * 4;  // one unit: k, v rows, k, v scales
  static constexpr size_t MERGE = sizeof(float) * NW * RMAX * (HD + 2);
  static constexpr size_t smem(int pipelined) { return (pipelined ? (size_t)NW * 2 * USTAGE : 0) + MERGE; }
  static_assert(KPW >= 1 && KPW <= KT && CB % 4 == 0, "lane layout");
};

// The tensor-core regime's carve: [2 raw stages (pipelined)][q][k][v tiles][k, v scales].
template <typename P, int HD, int CODEC>
struct Tc {
  static constexpr int LD = HD + mma_bf16::PAD;
  static constexpr int TILE = TC_ROWS * LD;  // bf16 elements of one tile
  static constexpr int RB = Row<P, HD, CODEC>::RB;
  static constexpr int STAGE = 2 * TC_KEYS * RB + 2 * TC_KEYS * 4;
  static constexpr size_t TILES = sizeof(bf16) * 3 * (size_t)TILE + sizeof(float) * 2 * TC_KEYS;
  static constexpr size_t smem(int pipelined) { return (pipelined ? 2 * (size_t)STAGE : 0) + TILES; }
};

struct Args {
  const void* q;           // [b, hkv, G, hd], Q
  const int* pos;          // [b, C]
  const unsigned char* k;  // pools, raw rows
  const unsigned char* v;
  const float* ks;         // [P, hkv, page] (quantized pools)
  const float* vs;
  const int* table;        // [b, n_pt]
  void* out;               // [b, hkv, G, hd], Q
  int* count;              // [b, hkv, n_tiles] arrival counters, zero between launches
  float* part;             // [b, hkv, n_tiles, n_splits, R, rec] partials
  int G, C, hkv, page, n_pt, n_tiles, n_splits;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(bf16* o, float x) { *o = __float2bfloat16_rn(x); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Pool row of key `key` of slot b, kv head h.
__device__ __forceinline__ size_t key_row(const Args& a, int b, int h, int key) {
  const int t = key / a.page;
  const int phys = a.table[(size_t)b * a.n_pt + t];
  return ((size_t)phys * a.hkv + h) * a.page + (key - t * a.page);
}

// A row's position, at most the table's last key (a larger one admits the
// same keys); -1 past the G rows.
__device__ __forceinline__ int row_pos(const Args& a, int b, int row) {
  return row < a.G ? min(a.pos[(size_t)b * a.C + row % a.C], a.n_pt * a.page - 1) : -1;
}

// The largest position of rows row0 .. row0 + R - 1, computed by each warp alone.
template <int R>
__device__ __forceinline__ int tile_max_pos(const Args& a, int b, int row0, int lane) {
  int mx = -1;
  for (int r = lane; r < R; r += 32) mx = max(mx, row_pos(a, b, row0 + r));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(FULL, mx, o));
  return mx;
}

// The split plan of a tile: live splits are those that start at or below its
// largest position (none when every row is dead).
__device__ __forceinline__ int live_splits(int max_pos, int n_keys) {
  return max_pos < 0 ? 0 : min(max_pos, n_keys - 1) / KS + 1;
}

// Zeros for the tile's rows (a tile with no live key).
template <typename Q, int HD, int R>
__device__ void write_zeros(const Args& a, int b, int h, int row0) {
  Q* out = static_cast<Q*>(a.out);
  for (int i = threadIdx.x; i < R * HD; i += NT) {
    const int row = row0 + i / HD;
    if (row < a.G) store(out + (((size_t)b * a.hkv + h) * a.G + row) * HD + i % HD, 0.f);
  }
}

// Whether this block is the last of its tile's n_live to arrive; the last
// resets the counter for the next launch.
__device__ __forceinline__ bool arrive_last(int* count, int n_live) {
  __shared__ int last;
  __threadfence();  // this block's partials, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(count, 1) == n_live - 1;
    if (last) atomicExch(count, 0);
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The merge of a tile's n_live partials, in split order, into the output:
// a row's HD / 4 threads read a float4 of each record each, so a warp's
// loads of one record are contiguous, and a thread's rows (one in each
// pass of NT / (HD / 4) rows) load at once.
template <typename Q, int HD, int R>
__device__ void combine(const Args& a, const float* base, int n_live, int b, int h, int row0) {
  constexpr int REC = rec_floats<HD>();
  constexpr int TPR = HD / 4;                    // threads per row
  constexpr int RPP = NT / TPR;                  // rows per pass
  constexpr int PASSES = (R + RPP - 1) / RPP;
  const int c = (threadIdx.x % TPR) * 4, r0 = threadIdx.x / TPR;
  bool live[PASSES];
  float m[PASSES], l[PASSES], acc[PASSES][4];
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int r = r0 + p * RPP;
    live[p] = r < R && row0 + r < a.G;
    m[p] = MAX_FLOOR;
    l[p] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;
  }
#pragma unroll 4
  for (int i = 0; i < n_live; ++i)
#pragma unroll
    for (int p = 0; p < PASSES; ++p)
      if (live[p]) m[p] = fmaxf(m[p], __ldcg(base + (size_t)(i * R + r0 + p * RPP) * REC + HD));
#pragma unroll 2
  for (int i = 0; i < n_live; ++i)
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      if (!live[p]) continue;
      const float* rec = base + (size_t)(i * R + r0 + p * RPP) * REC;
      const float f = expf(__ldcg(rec + HD) - m[p]);
      l[p] = fmaf(__ldcg(rec + HD + 1), f, l[p]);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(rec + c));
      acc[p][0] = fmaf(x.x, f, acc[p][0]);
      acc[p][1] = fmaf(x.y, f, acc[p][1]);
      acc[p][2] = fmaf(x.z, f, acc[p][2]);
      acc[p][3] = fmaf(x.w, f, acc[p][3]);
    }
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    if (!live[p]) continue;
    const float l_fin = fmaxf(l[p], 1e-30f);
    Q* o = static_cast<Q*>(a.out) + (((size_t)b * a.hkv + h) * a.G + row0 + r0 + p * RPP) * HD + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) store(o + j, acc[p][j] / l_fin);
  }
}

// ---- the register regime -------------------------------------------------------

template <int CB>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[CB / 4], const unsigned char* p) {
  if constexpr (CB == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (CB == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// A lane's CB raw bytes of a row -> its CH channels in f32 (int4: the CB
// high nibbles, then the CB low nibbles).
template <typename P, int CODEC, int CH, int CB>
__device__ __forceinline__ void unpack(float (&x)[CH], const uint32_t (&w)[CB / 4]) {
#pragma unroll
  for (int i = 0; i < CB; ++i) {
    const uint32_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
    if constexpr (CODEC == INT4) {
      x[i] = static_cast<float>(static_cast<int>(byte >> 4) - 8);
      x[CB + i] = static_cast<float>(static_cast<int>(byte & 0xFu) - 8);
    } else if constexpr (CODEC == INT8) {
      x[i] = static_cast<float>(static_cast<int8_t>(byte));
    }
  }
  if constexpr (CODEC == FP && sizeof(P) == 2) {
#pragma unroll
    for (int j = 0; j < CB / 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  } else if constexpr (CODEC == FP) {
#pragma unroll
    for (int j = 0; j < CB / 4; ++j) x[j] = __uint_as_float(w[j]);
  }
}

// Channel of a lane's element e.
template <int HD, int CODEC, int CH, int CB>
__device__ __forceinline__ int lane_channel(int sub, int e) {
  if constexpr (CODEC == INT4) return e < CB ? sub * CB + e : HD / 2 + sub * CB + (e - CB);
  return sub * CH + e;
}

// A unit's rows straight from the pool (the single-buffer kernel): keys at
// or past live_end read as zero bytes and a zero scale.
template <typename P, int HD, int CODEC, int R>
struct GlobalUnit {
  using F = Fma<P, HD, CODEC, R>;
  Args a;
  int b, h, key0, live_end;
  __device__ void rows(int kk, int sub, uint32_t (&kw)[F::CB / 4], uint32_t (&vw)[F::CB / 4],
                       float& ksc, float& vsc, bool want_k, bool want_v) const {
#pragma unroll
    for (int i = 0; i < F::CB / 4; ++i) kw[i] = vw[i] = 0u;
    ksc = vsc = 0.f;
    if (key0 + kk >= live_end) return;
    const size_t row = key_row(a, b, h, key0 + kk);
    if (want_k) {
      load_bytes<F::CB>(kw, a.k + row * F::RB + sub * F::CB);
      if (CODEC != FP) ksc = a.ks[row];
    }
    if (want_v) {
      load_bytes<F::CB>(vw, a.v + row * F::RB + sub * F::CB);
      if (CODEC != FP) vsc = a.vs[row];
    }
  }
};

// A unit's rows from a shared stage (the pipelined kernel), zero-filled past live_end.
template <typename P, int HD, int CODEC, int R>
struct StagedUnit {
  using F = Fma<P, HD, CODEC, R>;
  const unsigned char* st;
  __device__ void rows(int kk, int sub, uint32_t (&kw)[F::CB / 4], uint32_t (&vw)[F::CB / 4],
                       float& ksc, float& vsc, bool want_k, bool want_v) const {
    const float* sc = reinterpret_cast<const float*>(st + 2 * KT * F::RB);
#pragma unroll
    for (int i = 0; i < F::CB / 4; ++i) kw[i] = vw[i] = 0u;
    ksc = vsc = 0.f;
    if (want_k) {
      load_bytes<F::CB>(kw, st + kk * F::RB + sub * F::CB);
      if (CODEC != FP) ksc = sc[kk];
    }
    if (want_v) {
      load_bytes<F::CB>(vw, st + KT * F::RB + kk * F::RB + sub * F::CB);
      if (CODEC != FP) vsc = sc[KT + kk];
    }
  }
};

// Copy a unit's raw rows and scales into a warp's stage by cp.async.
template <typename P, int HD, int CODEC, int R>
__device__ __forceinline__ void stage_unit(unsigned char* st, const Args& a, int b, int h, int key0,
                                           int live_end, int lane) {
  using F = Fma<P, HD, CODEC, R>;
  constexpr int PPR = F::RB / 16;  // 16-byte pieces per row
  for (int i = lane; i < KT * PPR; i += 32) {
    const int kk = i / PPR, off = (i % PPR) * 16;
    const bool valid = key0 + kk < live_end;
    const size_t row = valid ? key_row(a, b, h, key0 + kk) : 0;
    mma_bf16::cp_async16(st + kk * F::RB + off, a.k + row * F::RB + off, valid);
    mma_bf16::cp_async16(st + (KT + kk) * F::RB + off, a.v + row * F::RB + off, valid);
  }
  if (CODEC != FP) {
    const int kk = lane % KT;
    const bool valid = key0 + kk < live_end;
    const size_t row = valid ? key_row(a, b, h, key0 + kk) : 0;
    float* sc = reinterpret_cast<float*>(st + 2 * KT * F::RB);
    if (lane < KT) mma_bf16::cp_async4(sc + kk, a.ks + row, valid);
    else mma_bf16::cp_async4(sc + KT + kk, a.vs + row, valid);
  }
}

// THE register-regime fold: one unit of 16 keys (key positions key0 ..
// key0 + 15) into the warp's running (m, l, acc). l and acc are this lane
// group's shares (its keys), m is the warp's. Both kernels call it on the
// same units in the same order.
template <typename P, int HD, int CODEC, int R, class Src>
__device__ __forceinline__ void fold_unit(const Src& src, int key0, float scale,
                                          const float (&qv)[R][Fma<P, HD, CODEC, R>::CH],
                                          const int (&pos)[R], float (&m)[R], float (&l)[R],
                                          float (&acc)[R][Fma<P, HD, CODEC, R>::CH], int lane) {
  using F = Fma<P, HD, CODEC, R>;
  constexpr int CH = F::CH, CB = F::CB;
  const int sub = lane % F::L, grp = lane / F::L;
  constexpr int NV = F::V_EARLY ? F::PASSES : 1;
  float x[F::PASSES][R];
  uint32_t vwe[NV][CB / 4];
  float vse[NV];
#pragma unroll
  for (int p = 0; p < F::PASSES; ++p) {
    const int kk = p * F::KPW + grp;
    uint32_t kw[CB / 4];
    float ksc;
    src.rows(kk, sub, kw, vwe[F::V_EARLY ? p : 0], ksc, vse[F::V_EARLY ? p : 0], true, F::V_EARLY);
    float kx[CH];
    unpack<P, CODEC, CH, CB>(kx, kw);
    float d[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r] = 0.f;
#pragma unroll
      for (int e = 0; e < CH; ++e) d[r] = fmaf(qv[r][e], kx[e], d[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int o = 1; o < F::L; o <<= 1) d[r] += __shfl_xor_sync(FULL, d[r], o);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float y = __fmul_rn(d[r], scale);
      if (CODEC != FP) y = __fmul_rn(y, ksc);  // key scale after the product
      x[p][r] = key0 + kk <= pos[r] ? y : NEG_INF;
    }
  }
  float corr[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mx = x[0][r];
#pragma unroll
    for (int p = 1; p < F::PASSES; ++p) mx = fmaxf(mx, x[p][r]);
#pragma unroll
    for (int o = F::L; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[r][e] = __fmul_rn(acc[r][e], corr[r]);
  }
  float sum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sum[r] = 0.f;
#pragma unroll
  for (int p = 0; p < F::PASSES; ++p) {
    const int kk = p * F::KPW + grp;
    uint32_t kw[CB / 4];
    float ksc;
    if (!F::V_EARLY) src.rows(kk, sub, kw, vwe[0], ksc, vse[0], false, true);
    const float vsc = vse[F::V_EARLY ? p : 0];
    float vx[CH];
    unpack<P, CODEC, CH, CB>(vx, vwe[F::V_EARLY ? p : 0]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float pr = expf(x[p][r] - m[r]);
      sum[r] += pr;
      if (CODEC != FP) pr = __fmul_rn(pr, vsc);  // value scale into p, before p·v
#pragma unroll
      for (int e = 0; e < CH; ++e) acc[r][e] = fmaf(pr, vx[e], acc[r][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) l[r] = fmaf(l[r], corr[r], sum[r]);
}

template <typename Q, typename P, int HD, int CODEC, int R, bool PIPELINED>
__device__ __forceinline__ void fma_block(const Args& a, unsigned char* smem) {
  using F = Fma<P, HD, CODEC, R>;
  constexpr int CH = F::CH, REC = rec_floats<HD>();
  const int s = blockIdx.x, h = blockIdx.y / a.n_tiles, tile = blockIdx.y % a.n_tiles;
  const int b = blockIdx.z, row0 = tile * R;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_keys = a.n_pt * a.page;
  const int max_pos = tile_max_pos<R>(a, b, row0, lane);
  const int n_live = live_splits(max_pos, n_keys);
  if (s >= n_live) {
    if (s == 0) write_zeros<Q, HD, R>(a, b, h, row0);
    return;
  }
  const int live_end = min(max_pos + 1, n_keys);

  const int sub = lane % F::L;
  const Q* q = static_cast<const Q*>(a.q) + ((size_t)b * a.hkv + h) * a.G * HD;
  float qv[R][CH];
  int pos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    pos[r] = row_pos(a, b, row);
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      const int c = lane_channel<HD, CODEC, CH, F::CB>(sub, e);
      qv[r][e] = row < a.G ? to_f32(q[(size_t)row * HD + c]) : 0.f;
    }
  }
  float m[R], l[R], acc[R][CH];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = MAX_FLOOR;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < CH; ++e) acc[r][e] = 0.f;
  }

  // warp w folds units w, w + NW, ... of the split
  auto unit_key0 = [&](int i) { return s * KS + (warp + NW * i) * KT; };
  if constexpr (PIPELINED) {
    unsigned char* ring = smem + (size_t)warp * 2 * F::USTAGE;
    int n_u = 0;  // live units: the loop stops at the live depth
#pragma unroll
    for (int i = 0; i < UPW; ++i) n_u += unit_key0(i) < live_end;
    for (int i = 0; i < n_u && i < 2; ++i) {
      stage_unit<P, HD, CODEC, R>(ring + i * F::USTAGE, a, b, h, unit_key0(i), live_end, lane);
      mma_bf16::cp_async_commit();
    }
    for (int i = 0; i < n_u; ++i) {
      if (i + 1 < n_u) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncwarp();
      const StagedUnit<P, HD, CODEC, R> src{ring + (i & 1) * F::USTAGE};
      fold_unit<P, HD, CODEC, R>(src, unit_key0(i), a.scale, qv, pos, m, l, acc, lane);
      __syncwarp();
      if (i + 2 < n_u) {
        stage_unit<P, HD, CODEC, R>(ring + (i & 1) * F::USTAGE, a, b, h, unit_key0(i + 2), live_end, lane);
        mma_bf16::cp_async_commit();
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < UPW; ++i) {
      if (unit_key0(i) > max_pos) continue;  // no row of this tile reaches the unit
      const GlobalUnit<P, HD, CODEC, R> src{a, b, h, unit_key0(i), live_end};
      fold_unit<P, HD, CODEC, R>(src, unit_key0(i), a.scale, qv, pos, m, l, acc, lane);
    }
  }

  // the lane groups' shares summed over the warp, in a fixed butterfly
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int o = F::L; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(FULL, l[r], o);
#pragma unroll
      for (int e = 0; e < CH; ++e) acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], o);
    }
  // the warps' (m, l, acc) merged in shared memory, in warp order
  float* mg = reinterpret_cast<float*>(smem + (PIPELINED ? (size_t)NW * 2 * F::USTAGE : 0));
  if (lane < F::L) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* w = mg + (warp * RMAX + r) * (HD + 2);
#pragma unroll
      for (int e = 0; e < CH; ++e) w[lane_channel<HD, CODEC, CH, F::CB>(sub, e)] = acc[r][e];
      if (lane == 0) w[HD] = m[r], w[HD + 1] = l[r];
    }
  }
  __syncthreads();
  float* part = a.part + (((size_t)b * a.hkv + h) * a.n_tiles + tile) * a.n_splits * R * REC;
  Q* out = static_cast<Q*>(a.out);
  for (int i = threadIdx.x; i < R * HD; i += NT) {
    const int r = i / HD, c = i % HD, row = row0 + r;
    float mb = MAX_FLOOR;
#pragma unroll
    for (int w = 0; w < NW; ++w) mb = fmaxf(mb, mg[(w * RMAX + r) * (HD + 2) + HD]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* wr = mg + (w * RMAX + r) * (HD + 2);
      const float f = expf(wr[HD] - mb);
      lb = fmaf(wr[HD + 1], f, lb);
      ab = fmaf(wr[c], f, ab);
    }
    if (row >= a.G) continue;
    if (n_live == 1) {
      store(out + (((size_t)b * a.hkv + h) * a.G + row) * HD + c, ab / fmaxf(lb, 1e-30f));
    } else {
      float* rec = part + (size_t)(s * R + r) * REC;
      rec[c] = ab;
      if (c == 0) rec[HD] = mb, rec[HD + 1] = lb;
    }
  }
  if (n_live == 1) return;
  if (arrive_last(a.count + ((size_t)b * a.hkv + h) * a.n_tiles + tile, n_live))
    combine<Q, HD, R>(a, part, n_live, b, h, row0);
}

// ---- the tensor-core regime -----------------------------------------------------

// 16 raw bytes at byte `off` of key kk's row -> bf16 channels of the tile.
template <typename P, int HD, int CODEC>
__device__ __forceinline__ void put_piece(bf16* tile, int kk, int off, const uint4& raw) {
  using T = Tc<P, HD, CODEC>;
  bf16* dst = tile + kk * T::LD;
  if constexpr (CODEC == FP) {
    *reinterpret_cast<uint4*>(dst + off / 2) = raw;
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t b0 = (w[j / 2] >> (16 * (j % 2))) & 0xFFu;
      const uint32_t b1 = (w[j / 2] >> (16 * (j % 2) + 8)) & 0xFFu;
      if constexpr (CODEC == INT8) {
        hi[j] = mma_bf16::pack_bf16(static_cast<float>(static_cast<int8_t>(b0)),
                                    static_cast<float>(static_cast<int8_t>(b1)));
      } else {
        hi[j] = mma_bf16::pack_bf16(static_cast<float>(static_cast<int>(b0 >> 4) - 8),
                                    static_cast<float>(static_cast<int>(b1 >> 4) - 8));
        lo[j] = mma_bf16::pack_bf16(static_cast<float>(static_cast<int>(b0 & 0xFu) - 8),
                                    static_cast<float>(static_cast<int>(b1 & 0xFu) - 8));
      }
    }
    uint4* d = reinterpret_cast<uint4*>(dst + off);
    d[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    d[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    if constexpr (CODEC == INT4) {
      uint4* dl = reinterpret_cast<uint4*>(dst + HD / 2 + off);
      dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    }
  }
}

// p (two m16n8 accumulators) as the A fragments of p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), in to_a_frag's order.
__device__ __forceinline__ void split_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bf16 h0 = __float2bfloat16_rn(x[2 * j]), h1 = __float2bfloat16_rn(x[2 * j + 1]);
    hi[j] = static_cast<uint32_t>(__bfloat16_as_ushort(h0)) |
            (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
    lo[j] = mma_bf16::pack_bf16(__fsub_rn(x[2 * j], __bfloat162float(h0)),
                                __fsub_rn(x[2 * j + 1], __bfloat162float(h1)));
  }
}

template <typename P, int HD, int CODEC, bool PIPELINED>
__device__ __forceinline__ void tc_block(const Args& a, unsigned char* smem) {
  using namespace mma_bf16;
  using T = Tc<P, HD, CODEC>;
  constexpr int LD = T::LD, REC = rec_floats<HD>(), RB = T::RB, PPR = RB / 16;
  const int s = blockIdx.x, h = blockIdx.y / a.n_tiles, tile = blockIdx.y % a.n_tiles;
  const int b = blockIdx.z, row0 = tile * TC_ROWS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, tid = threadIdx.x;
  const int g = lane / 4, t4 = lane % 4;
  const int n_keys = a.n_pt * a.page;
  const int max_pos = tile_max_pos<TC_ROWS>(a, b, row0, lane);
  const int n_live = live_splits(max_pos, n_keys);
  if (s >= n_live) {
    if (s == 0) write_zeros<bf16, HD, TC_ROWS>(a, b, h, row0);
    return;
  }
  const int live_end = min(max_pos + 1, n_keys);
  const int key_lo = s * KS, key_hi = min(key_lo + KS, live_end);
  const int n_t = (key_hi - key_lo + TC_KEYS - 1) / TC_KEYS;

  unsigned char* raw = smem;  // 2 stages (pipelined)
  bf16* sq = reinterpret_cast<bf16*>(smem + (PIPELINED ? 2 * (size_t)T::STAGE : 0));
  bf16* sk = sq + T::TILE;
  bf16* sv = sk + T::TILE;
  float* sks = reinterpret_cast<float*>(sv + T::TILE);
  float* svs = sks + TC_KEYS;

  // q tile -> A fragments in registers
  const bf16* q = static_cast<const bf16*>(a.q) + ((size_t)b * a.hkv + h) * a.G * HD;
  load_tile<HD>(sq, q, row0, a.G);
  cp_async_commit();
  cp_async_wait_0();
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], sq + a_offset<LD>(warp, lane) + kk * 16);
  const int b_off = b_offset<LD>(lane), bt_off = bt_offset<LD>(lane);
  const int rw = warp * 16 + g;  // this thread's rows in the tile: rw and rw + 8
  const int pos[2] = {row_pos(a, b, row0 + rw), row_pos(a, b, row0 + rw + 8)};

  // raw 64-key tile t of the split: into a stage by cp.async (pipelined)
  auto stage = [&](int t) {
    unsigned char* st = raw + (t & 1) * T::STAGE;
    const int kb = key_lo + t * TC_KEYS;
    for (int i = tid; i < TC_KEYS * PPR; i += NT) {
      const int kk = i / PPR, off = (i % PPR) * 16;
      const bool valid = kb + kk < key_hi;
      const size_t row = valid ? key_row(a, b, h, kb + kk) : 0;
      cp_async16(st + kk * RB + off, a.k + row * RB + off, valid);
      cp_async16(st + (TC_KEYS + kk) * RB + off, a.v + row * RB + off, valid);
    }
    if (CODEC != FP) {
      const int kk = tid % TC_KEYS;
      const bool valid = kb + kk < key_hi;
      const size_t row = valid ? key_row(a, b, h, kb + kk) : 0;
      float* sc = reinterpret_cast<float*>(st + 2 * TC_KEYS * RB);
      if (tid < TC_KEYS) cp_async4(sc + kk, a.ks + row, valid);
      else cp_async4(sc + TC_KEYS + kk, a.vs + row, valid);
    }
    cp_async_commit();
  };
  // tile t's K/V into the bf16 tiles and its scales: from a stage
  // (pipelined) or straight from the pool with plain loads
  auto unpack_tile = [&](int t) {
    const int kb = key_lo + t * TC_KEYS;
    const unsigned char* st = raw + (t & 1) * T::STAGE;
    for (int i = tid; i < TC_KEYS * PPR; i += NT) {
      const int kk = i / PPR, off = (i % PPR) * 16;
      uint4 rk = make_uint4(0u, 0u, 0u, 0u), rv = rk;
      if constexpr (PIPELINED) {
        rk = *reinterpret_cast<const uint4*>(st + kk * RB + off);
        rv = *reinterpret_cast<const uint4*>(st + (TC_KEYS + kk) * RB + off);
      } else if (kb + kk < key_hi) {
        const size_t row = key_row(a, b, h, kb + kk);
        rk = *reinterpret_cast<const uint4*>(a.k + row * RB + off);
        rv = *reinterpret_cast<const uint4*>(a.v + row * RB + off);
      }
      put_piece<P, HD, CODEC>(sk, kk, off, rk);
      put_piece<P, HD, CODEC>(sv, kk, off, rv);
    }
    if (CODEC != FP) {
      const int kk = tid % TC_KEYS;
      float x = 0.f;
      if constexpr (PIPELINED) {
        x = reinterpret_cast<const float*>(st + 2 * TC_KEYS * RB)[tid];
      } else if (kb + kk < key_hi) {
        const size_t row = key_row(a, b, h, kb + kk);
        x = tid < TC_KEYS ? a.ks[row] : a.vs[row];
      }
      (tid < TC_KEYS ? sks : svs)[kk] = x;
    }
  };

  float m[2] = {MAX_FLOOR, MAX_FLOOR}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if constexpr (PIPELINED) {
    for (int t = 0; t < n_t && t < 2; ++t) stage(t);
  }
  for (int t = 0; t < n_t; ++t) {
    if constexpr (PIPELINED) {
      if (t + 1 < n_t) cp_async_wait<1>();
      else cp_async_wait<0>();
    }
    __syncthreads();  // the stage is in; every warp is done with the last tile
    unpack_tile(t);
    __syncthreads();
    if constexpr (PIPELINED) {
      if (t + 2 < n_t) stage(t + 2);
    }
    const int kb = key_lo + t * TC_KEYS;

    // s = q kᵀ: 16 × 64 per warp, f32 sums
    float sc[TC_KEYS / 8][4];
#pragma unroll
    for (int n = 0; n < TC_KEYS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int np = 0; np < TC_KEYS / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4(bb, sk + np * 16 * LD + b_off + kk * 16);
        mma(sc[2 * np], qf[kk], bb[0], bb[1]);
        mma(sc[2 * np + 1], qf[kk], bb[2], bb[3]);
      }
    // times hd^-½, then the key scale; the mask
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < TC_KEYS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t4 + (e & 1);
        float y = __fmul_rn(sc[n][e], a.scale);
        if (CODEC != FP) y = __fmul_rn(y, sks[col]);
        y = kb + col <= pos[e >> 1] ? y : NEG_INF;
        sc[n][e] = y;
        mx[e >> 1] = fmaxf(mx[e >> 1], y);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = fmaxf(mx[hh], __shfl_xor_sync(FULL, mx[hh], 1));
      x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
      const float m_new = fmaxf(m[hh], x);
      corr[hh] = expf(m[hh] - m_new);
      m[hh] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < TC_KEYS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(sc[n][e] - m[e >> 1]);
        sum[e >> 1] += p;
        if (CODEC != FP) p = __fmul_rn(p, svs[n * 8 + 2 * t4 + (e & 1)]);  // value scale into p
        sc[n][e] = p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(l[hh], corr[hh], sum[hh]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fmul_rn(acc[n][e], corr[e >> 1]);

    // acc += p v as p_hi v + p_lo v, v through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < TC_KEYS / 16; ++j) {
      uint32_t ph[4], pl[4];
      split_frag(ph, pl, sc[2 * j], sc[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        uint32_t bb[4];
        ldsm_x4_t(bb, sv + j * 16 * LD + bt_off + dn * 16);
        mma(acc[2 * dn], ph, bb[0], bb[1]);
        mma(acc[2 * dn + 1], ph, bb[2], bb[3]);
        mma(acc[2 * dn], pl, bb[0], bb[1]);
        mma(acc[2 * dn + 1], pl, bb[2], bb[3]);
      }
    }
  }

  // each lane's share of l summed over its quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(FULL, l[hh], 1);
    l[hh] += __shfl_xor_sync(FULL, l[hh], 2);
  }
  float* part = a.part + (((size_t)b * a.hkv + h) * a.n_tiles + tile) * a.n_splits * TC_ROWS * REC;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rw + 8 * hh, row = row0 + r;
    if (row >= a.G) continue;
    if (n_live == 1) {
      const float l_fin = fmaxf(l[hh], 1e-30f);
      bf16* o = static_cast<bf16*>(a.out) + (((size_t)b * a.hkv + h) * a.G + row) * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * hh] / l_fin, acc[n][2 * hh + 1] / l_fin);
    } else {
      float* rec = part + (size_t)(s * TC_ROWS + r) * REC;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<float2*>(rec + n * 8 + 2 * t4) = make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
      if (t4 == 0) rec[HD] = m[hh], rec[HD + 1] = l[hh];
    }
  }
  if (n_live == 1) return;
  if (arrive_last(a.count + ((size_t)b * a.hkv + h) * a.n_tiles + tile, n_live))
    combine<bf16, HD, TC_ROWS>(a, part, n_live, b, h, row0);
}

// ---- the two kernels -------------------------------------------------------------

template <typename Q, typename P, int HD, int CODEC, int R, bool PIPELINED>
__device__ __forceinline__ void block(const Args& a, unsigned char* smem) {
  if constexpr (R == TC_ROWS) tc_block<P, HD, CODEC, PIPELINED>(a, smem);
  else fma_block<Q, P, HD, CODEC, R, PIPELINED>(a, smem);
}

// Kernel 5: plain loads, every unit of the split up to the tile's largest position.
template <typename Q, typename P, int HD, int CODEC, int R>
__global__ void __launch_bounds__(NT, min_blocks<R, HD>()) paged_attn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  block<Q, P, HD, CODEC, R, false>(a, smem);
}

// Kernel 6: the same units through a 2-stage cp.async ring, stopping at the live depth.
template <typename Q, typename P, int HD, int CODEC, int R>
__global__ void __launch_bounds__(NT, min_blocks<R, HD>()) paged_attn_pipelined_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  block<Q, P, HD, CODEC, R, true>(a, smem);
}

template <typename P, int HD, int CODEC>
size_t smem_regime(int tensor_cores, int pipelined) {
  return tensor_cores ? Tc<P, HD, CODEC>::smem(pipelined) : Fma<P, HD, CODEC, 1>::smem(pipelined);
}

// Rows of a row tile: 64 on the tensor cores (bf16 q, G > 16), else 1 or 4.
int tile_rows(int q_bf16, int G) { return q_bf16 && G > 16 ? TC_ROWS : (G == 1 ? 1 : RMAX); }

// The scratch of one call: an arrival counter per (slot, kv head, row
// tile), and a partial record per (slot, kv head, row tile, split, row).
size_t scratch_bytes(int b, int hkv, int G, int hd, int n_keys, int q_bf16, int counters) {
  const int R = tile_rows(q_bf16, G), n_tiles = (G + R - 1) / R, n_splits = (n_keys + KS - 1) / KS;
  if (counters) return sizeof(int) * (size_t)b * hkv * n_tiles;
  return sizeof(float) * (size_t)b * hkv * n_tiles * n_splits * R * (hd + 4);
}

template <typename Q, typename P, int HD, int CODEC, int R>
cudaError_t go(Args a, int b, int pipelined, cudaStream_t st) {
  const size_t smem = smem_regime<P, HD, CODEC>(R == TC_ROWS, pipelined);
  auto kern = pipelined ? paged_attn_pipelined_kernel<Q, P, HD, CODEC, R>
                        : paged_attn_kernel<Q, P, HD, CODEC, R>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.n_splits, a.hkv * a.n_tiles, b), NT, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename Q, typename P, int HD, int CODEC>
cudaError_t launch(Args a, int b, int pipelined, cudaStream_t st) {
  if constexpr (std::is_same_v<Q, bf16>) {
    if (a.G > 16) return go<Q, P, HD, CODEC, TC_ROWS>(a, b, pipelined, st);
  }
  return a.G == 1 ? go<Q, P, HD, CODEC, 1>(a, b, pipelined, st)
                  : go<Q, P, HD, CODEC, RMAX>(a, b, pipelined, st);
}

template <typename Q, int HD>
cudaError_t dispatch_pool(int pool_kind, Args a, int b, int pipelined, cudaStream_t st) {
  switch (pool_kind) {
    case 0:  // fp pages, stored in q's type
      return launch<Q, Q, HD, FP>(a, b, pipelined, st);
    case 1:
      return launch<Q, int8_t, HD, INT8>(a, b, pipelined, st);
    case 2:
      return launch<Q, uint8_t, HD, INT4>(a, b, pipelined, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [b, hkv, G, hd] (f32, or bf16 when q_bf16), contiguous; pos [b, C] int32
// (row g of a group has position pos[b, g % C]); pools k/v [P, hkv, page,
// hd] in q's type (pool_kind 0), int8 (1) or [P, hkv, page, hd/2] uint8 (2),
// contiguous and 16-byte aligned; ks/vs [P, hkv, page, 1] f32 for pool_kind
// 1 and 2 (ignored for 0); table [b, n_pt] int32; out [b, hkv, G, hd] in q's
// type; count int32 counters (count_bytes of them) that are zero, as every
// launch leaves them, and part f32 scratch of part_bytes, each at least
// paged_attn_scratch_bytes(..., 1) and (..., 0).
// hd is 64 or 128; scale is hd^-½ as the caller rounds it.
extern "C" int paged_attn(const void* q, const void* pos, const void* k, const void* v,
                          const void* ks, const void* vs, const void* table, void* out,
                          void* count, long long count_bytes, void* part, long long part_bytes, int b, int hkv, int G, int C, int hd, int page,
                          int n_pt, int q_bf16, int pool_kind, int pipelined, float scale,
                          void* stream) {
  if ((hd != 64 && hd != 128) || G < 1 || C < 1 || page < 1 || n_pt < 1) return (int)cudaErrorInvalidValue;
  const int n_keys = n_pt * page;
  if ((size_t)count_bytes < scratch_bytes(b, hkv, G, hd, n_keys, q_bf16, 1) ||
      (size_t)part_bytes < scratch_bytes(b, hkv, G, hd, n_keys, q_bf16, 0))
    return (int)cudaErrorInvalidValue;
  const int R = tile_rows(q_bf16, G);
  Args a;
  a.q = q;
  a.pos = static_cast<const int*>(pos);
  a.k = static_cast<const unsigned char*>(k);
  a.v = static_cast<const unsigned char*>(v);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.table = static_cast<const int*>(table);
  a.out = out;
  a.G = G, a.C = C, a.hkv = hkv, a.page = page, a.n_pt = n_pt;
  a.n_tiles = (G + R - 1) / R;
  a.n_splits = (n_keys + KS - 1) / KS;
  a.scale = scale;
  a.count = static_cast<int*>(count);
  a.part = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return q_bf16 ? dispatch_pool<bf16, 64>(pool_kind, a, b, pipelined, st)
                  : dispatch_pool<float, 64>(pool_kind, a, b, pipelined, st);
  return q_bf16 ? dispatch_pool<bf16, 128>(pool_kind, a, b, pipelined, st)
                : dispatch_pool<float, 128>(pool_kind, a, b, pipelined, st);
}

// Bytes of the counters (counters = 1) or of the partials (0) one call needs.
extern "C" long long paged_attn_scratch_bytes(int b, int hkv, int G, int hd, int n_keys, int q_bf16,
                                              int counters) {
  return (long long)scratch_bytes(b, hkv, G, hd, n_keys, q_bf16, counters);
}

// Dynamic shared memory of one launch, in bytes: the register regime's
// (tensor_cores 0) or the tensor-core regime's (1, bf16 q); fp_bytes is the
// fp pool's element size (4 or 2), ignored for int8/int4 pools.
extern "C" long long paged_attn_smem_bytes(int hd, int pool_kind, int fp_bytes, int pipelined,
                                           int tensor_cores) {
  if (hd != 64 && hd != 128) return -1;
  const bool wide = hd == 128;
  switch (pool_kind) {
    case 0:
      if (fp_bytes == 4)
        return tensor_cores ? -1
                            : (wide ? smem_regime<float, 128, FP>(0, pipelined)
                                    : smem_regime<float, 64, FP>(0, pipelined));
      return wide ? smem_regime<bf16, 128, FP>(tensor_cores, pipelined)
                  : smem_regime<bf16, 64, FP>(tensor_cores, pipelined);
    case 1:
      return wide ? smem_regime<int8_t, 128, INT8>(tensor_cores, pipelined)
                  : smem_regime<int8_t, 64, INT8>(tensor_cores, pipelined);
    case 2:
      return wide ? smem_regime<uint8_t, 128, INT4>(tensor_cores, pipelined)
                  : smem_regime<uint8_t, 64, INT4>(tensor_cores, pipelined);
    default:
      return -1;
  }
}

extern "C" const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
