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
// pools; masked to -1e30 where key_pos > query_pos; an online softmax whose
// running max starts at -1e20; p times the value's scale for quantized pools
// before p·v; out = acc / max(l, 1e-30) in f32. Pools hold f32 or bf16 rows
// (fp pages), int8 rows, or int4 rows packed two per byte (byte j: channel j
// in the high nibble, channel j + hd/2 in the low one, each offset by +8),
// with one f32 scale per row for int8/int4. A row whose positions are all -1
// (a dead slot) reads nothing and returns zeros.
//
// What bounds them. A decode tick (C = 1) reads every live page of every
// slot once and does 4·hd operations per key: about one operation per byte,
// so the least time is set by device-memory bytes. A 256-row prefill chunk
// does 256× the operations on the same bytes and is bound by operations.
// These first kernels reach neither bound: their products are f32 FMAs over
// tiles in shared memory, one 16-key unit at a time with two block-wide
// barriers per unit, so they are bound by barrier and shared-memory latency.
//
// Design. The TPU walks table entries along a sequential grid axis and keeps
// (acc, m, l) in VMEM scratch. Here one thread block owns one (slot, kv head,
// tile of 16 query rows) and walks the table entries in a loop, keeping
// (acc, m, l) in registers; the ragged row edge (G from 1 to rep·chunk) is
// masked in the kernel, so the wrapper pads nothing. A page streams through
// in units of at most 16 rows, so shared memory is fixed by the kernel's own
// tiles and any page size launches. A unit whose first key lies past the
// largest position of the block's rows is skipped (the TPU's pl.when). The
// single-buffer kernel loads each unit's raw bytes with plain 16-byte loads;
// the pipelined kernel stops at the live depth and keeps a 2-stage ring of
// raw unit buffers filled by cp.async (16-byte copies for rows, 4-byte for
// scales; commit_group / wait_group 1), so unit u+1's copy is in flight while
// unit u folds: this takes the place of make_async_copy and its DMA
// semaphores, and each block reads its own table entries (no scalar
// prefetch). Both kernels pass the same raw bytes through the one fold_unit
// below in the same order, so their outputs are bit-identical.
//
// Interface: plain C, loaded with ctypes. paged_attn returns a cudaError_t
// (0 on success): the launch is checked with cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 16;        // query rows per block
constexpr int KT = 16;        // key rows per fold unit
constexpr int NT = 128;       // threads: 8 row groups × 16 key lanes
constexpr int RG = NT / KT;   // row groups; a thread's rows are rg and rg + RG
constexpr int RPT = BM / RG;  // rows per thread
constexpr int LDP = KT + 1;   // padded row stride of the probability tile
constexpr float NEG_INF = -1e30f;
constexpr float MAX_FLOOR = -1e20f;

enum Codec { FP = 0, INT8 = 1, INT4 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// max and sum over the 16 lanes that hold one query row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = KT / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = KT / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_0() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Shape of one pool row and of the shared-memory carve, per (pool type, hd, codec).
template <typename P, int HD, int CODEC>
struct Geo {
  static constexpr int W = CODEC == INT4 ? HD / 2 : HD;  // stored elements per row
  static constexpr int RB = W * (int)sizeof(P);          // bytes per row (a multiple of 16)
  static constexpr int LD = HD + 1;                      // padded f32 row stride
  // one raw stage: k rows, v rows, k scales, v scales
  static constexpr size_t STAGE = 2 * (size_t)KT * RB + 2 * (size_t)KT * sizeof(float);
  // f32 tiles: q, k, v, p, scales; then the int positions
  static constexpr size_t TILES =
      sizeof(float) * ((size_t)BM * LD + 2 * (size_t)KT * LD + (size_t)BM * LDP + 2 * KT) +
      sizeof(int) * BM;
  static constexpr size_t smem(int stages) { return stages * STAGE + TILES; }
};

template <typename P, int HD, int CODEC>
struct Smem {
  unsigned char* raw;  // raw stages, at the 16-byte-aligned base
  float *sq, *sk, *sv, *sp, *sks, *svs;
  int* spos;
  __device__ Smem(unsigned char* base, int stages) {
    using G = Geo<P, HD, CODEC>;
    raw = base;
    sq = reinterpret_cast<float*>(base + stages * G::STAGE);
    sk = sq + BM * G::LD;
    sv = sk + KT * G::LD;
    sp = sv + KT * G::LD;
    sks = sp + BM * LDP;
    svs = sks + KT;
    spos = reinterpret_cast<int*>(svs + KT);
  }
};

// Device pointers of one fold unit: rows key_row .. key_row + n_keys - 1 of
// physical page `phys`, kv head h.
template <typename P, int HD, int CODEC>
struct Unit {
  const unsigned char *k, *v;
  const float *ks, *vs;
  int n_keys;
};

template <typename P, int HD, int CODEC>
__device__ __forceinline__ Unit<P, HD, CODEC> unit_at(const P* kpool, const P* vpool,
                                                      const float* kspool, const float* vspool,
                                                      int phys, int h, int hkv, int page,
                                                      int sub) {
  using G = Geo<P, HD, CODEC>;
  const size_t row = ((size_t)phys * hkv + h) * page + (size_t)sub * KT;
  Unit<P, HD, CODEC> u;
  u.k = reinterpret_cast<const unsigned char*>(kpool) + row * G::RB;
  u.v = reinterpret_cast<const unsigned char*>(vpool) + row * G::RB;
  u.ks = CODEC == FP ? nullptr : kspool + row;
  u.vs = CODEC == FP ? nullptr : vspool + row;
  u.n_keys = min(KT, page - sub * KT);
  return u;
}

// Copy a unit's raw bytes into a stage: plain 16-byte loads, or cp.async.
template <typename P, int HD, int CODEC, bool ASYNC>
__device__ __forceinline__ void stage_unit(unsigned char* stage, const Unit<P, HD, CODEC>& u, int tid) {
  using G = Geo<P, HD, CODEC>;
  const int chunks = u.n_keys * G::RB / 16;
  unsigned char* dk = stage;
  unsigned char* dv = stage + KT * G::RB;
  for (int i = tid; i < chunks; i += NT) {
    if constexpr (ASYNC) {
      cp_async16(dk + 16 * i, u.k + 16 * i);
      cp_async16(dv + 16 * i, u.v + 16 * i);
    } else {
      reinterpret_cast<uint4*>(dk)[i] = reinterpret_cast<const uint4*>(u.k)[i];
      reinterpret_cast<uint4*>(dv)[i] = reinterpret_cast<const uint4*>(u.v)[i];
    }
  }
  if (CODEC != FP && tid < u.n_keys) {
    float* ds = reinterpret_cast<float*>(stage + 2 * KT * G::RB);
    if constexpr (ASYNC) {
      cp_async4(ds + tid, u.ks + tid);
      cp_async4(ds + KT + tid, u.vs + tid);
    } else {
      ds[tid] = u.ks[tid];
      ds[KT + tid] = u.vs[tid];
    }
  }
}

// Raw rows of a stage → an f32 tile [KT][LD]; rows past n_keys are zero.
template <typename P, int HD, int CODEC>
__device__ __forceinline__ void unpack_rows(const unsigned char* raw, float* dst, int n_keys, int tid) {
  using G = Geo<P, HD, CODEC>;
  for (int i = tid; i < KT * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    float x = 0.f;
    if (r < n_keys) {
      if constexpr (CODEC == INT4) {
        const uint8_t byte = raw[r * G::RB + (c < HD / 2 ? c : c - HD / 2)];
        x = static_cast<float>((c < HD / 2 ? byte >> 4 : byte & 0xF) - 8);
      } else {
        x = to_f32(reinterpret_cast<const P*>(raw)[r * HD + c]);
      }
    }
    dst[r * G::LD + c] = x;
  }
}

// THE fold: one unit of keys (key positions key0 .. key0 + n_keys - 1, raw
// bytes in `stage`) into the running (acc, m, l) of this thread's rows. Both
// kernels call it on the same units in the same order.
template <typename P, int HD, int CODEC>
__device__ __forceinline__ void fold_unit(const unsigned char* stage, const Smem<P, HD, CODEC>& sm,
                                          int key0, int n_keys, float scale, const int (&qpos)[RPT],
                                          float (&m)[RPT], float (&l)[RPT],
                                          float (&acc)[RPT][HD / 16], int tid) {
  using G = Geo<P, HD, CODEC>;
  constexpr int DC = HD / 16;
  __syncthreads();  // the stage has landed; the last unit's readers of sk, sv, sp are done
  unpack_rows<P, HD, CODEC>(stage, sm.sk, n_keys, tid);
  unpack_rows<P, HD, CODEC>(stage + KT * G::RB, sm.sv, n_keys, tid);
  if (CODEC != FP && tid < KT) {
    const float* rs = reinterpret_cast<const float*>(stage + 2 * KT * G::RB);
    sm.sks[tid] = tid < n_keys ? rs[tid] : 0.f;
    sm.svs[tid] = tid < n_keys ? rs[KT + tid] : 0.f;
  }
  __syncthreads();

  const int c = tid % KT, rg = tid / KT;
  float s[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) s[i] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float kd = sm.sk[c * G::LD + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[i] = fmaf(sm.sq[(rg + RG * i) * G::LD + d], kd, s[i]);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float x = s[i] * scale;
    if (CODEC != FP) x = x * sm.sks[c];  // key scale after the product
    x = (c < n_keys && key0 + c <= qpos[i]) ? x : NEG_INF;
    const float m_new = fmaxf(m[i], row_max(x));
    const float corr = expf(m[i] - m_new);
    float p = expf(x - m_new);
    l[i] = fmaf(l[i], corr, row_sum(p));
    if (CODEC != FP) p = p * sm.svs[c];  // value scale into p, before p·v
    sm.sp[(rg + RG * i) * LDP + c] = p;
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = acc[i][j] * corr;
  }
  __syncthreads();
  for (int k = 0; k < n_keys; ++k) {
    float vb[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) vb[j] = sm.sv[k * G::LD + c + 16 * j];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float pa = sm.sp[(rg + RG * i) * LDP + k];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pa, vb[j], acc[i][j]);
    }
  }
}

// Block set-up shared by both kernels: the q tile and positions into shared
// memory, the block's largest position, this thread's rows' positions.
template <typename Q, typename P, int HD, int CODEC>
__device__ __forceinline__ int load_queries(const Q* q, const int* pos, const Smem<P, HD, CODEC>& sm,
                                            int b, int h, int hkv, int G, int row0, int tid,
                                            int (&qpos)[RPT]) {
  using Ge = Geo<P, HD, CODEC>;
  const size_t qbase = ((size_t)b * hkv + h) * G * HD;
  for (int i = tid; i < BM * HD; i += NT) {
    const int r = i / HD, c = i % HD;
    sm.sq[r * Ge::LD + c] = row0 + r < G ? to_f32(q[qbase + (size_t)(row0 + r) * HD + c]) : 0.f;
  }
  if (tid < BM) sm.spos[tid] = row0 + tid < G ? pos[(size_t)b * G + row0 + tid] : -1;
  __syncthreads();
  int max_pos = -1;
  for (int r = 0; r < BM; ++r) max_pos = max(max_pos, sm.spos[r]);
  const int rg = tid / KT;
#pragma unroll
  for (int i = 0; i < RPT; ++i) qpos[i] = sm.spos[rg + RG * i];
  return max_pos;
}

template <typename P, int HD, int CODEC>
__device__ __forceinline__ void store_out(float* out, const float (&l)[RPT],
                                          const float (&acc)[RPT][HD / 16], int b, int h, int hkv,
                                          int G, int row0, int tid) {
  const int c = tid % KT, rg = tid / KT;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = row0 + rg + RG * i;
    if (row >= G) continue;
    const float l_fin = fmaxf(l[i], 1e-30f);
    float* o = out + (((size_t)b * hkv + h) * G + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) o[c + 16 * j] = acc[i][j] / l_fin;
  }
}

#define PAGED_ARGS                                                                           \
  const Q *__restrict__ q, const int *__restrict__ pos, const P *__restrict__ kpool,         \
      const P *__restrict__ vpool, const float *__restrict__ kspool,                         \
      const float *__restrict__ vspool, const int *__restrict__ table, float *__restrict__ out, \
      int G, int hkv, int page, int n_pt, float scale

// Kernel 5: the single-buffer walk over every table entry, skipping units
// past the block's largest position.
template <typename Q, typename P, int HD, int CODEC>
__global__ void __launch_bounds__(NT) paged_attn_kernel(PAGED_ARGS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<P, HD, CODEC> sm(smem, 1);
  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * BM;
  int qpos[RPT];
  const int max_pos = load_queries<Q, P, HD, CODEC>(q, pos, sm, b, h, hkv, G, row0, tid, qpos);
  float m[RPT], l[RPT], acc[RPT][HD / 16];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = MAX_FLOOR;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;
  }
  const int n_sub = (page + KT - 1) / KT;
  for (int t = 0; t < n_pt; ++t) {
    if (t * page > max_pos) continue;  // no row of this block reaches the entry
    const int phys = table[(size_t)b * n_pt + t];
    for (int sub = 0; sub < n_sub; ++sub) {
      const int key0 = t * page + sub * KT;
      if (key0 > max_pos) break;
      const auto u = unit_at<P, HD, CODEC>(kpool, vpool, kspool, vspool, phys, h, hkv, page, sub);
      stage_unit<P, HD, CODEC, false>(sm.raw, u, tid);
      fold_unit<P, HD, CODEC>(sm.raw, sm, key0, u.n_keys, scale, qpos, m, l, acc, tid);
    }
  }
  store_out<P, HD, CODEC>(out, l, acc, b, h, hkv, G, row0, tid);
}

// Kernel 6: the same units, the loop bound at the live depth, through a
// 2-stage ring of raw buffers filled by cp.async one unit ahead.
template <typename Q, typename P, int HD, int CODEC>
__global__ void __launch_bounds__(NT) paged_attn_pipelined_kernel(PAGED_ARGS) {
  using G_ = Geo<P, HD, CODEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<P, HD, CODEC> sm(smem, 2);
  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z, row0 = blockIdx.x * BM;
  int qpos[RPT];
  const int max_pos = load_queries<Q, P, HD, CODEC>(q, pos, sm, b, h, hkv, G, row0, tid, qpos);
  float m[RPT], l[RPT], acc[RPT][HD / 16];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = MAX_FLOOR;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;
  }
  const int n_sub = (page + KT - 1) / KT;
  // live units: every (entry, sub-tile) whose first key is <= max_pos
  int n_units = 0;
  if (max_pos >= 0) {
    const int t_last = max_pos / page;
    n_units = t_last >= n_pt ? n_pt * n_sub
                             : t_last * n_sub + min(n_sub, (max_pos - t_last * page) / KT + 1);
  }
  auto unit = [&](int u) {
    const int t = u / n_sub, sub = u % n_sub;
    return unit_at<P, HD, CODEC>(kpool, vpool, kspool, vspool, table[(size_t)b * n_pt + t], h,
                                 hkv, page, sub);
  };
  if (n_units > 0) {
    stage_unit<P, HD, CODEC, true>(sm.raw, unit(0), tid);
    cp_async_commit();
  }
  for (int u = 0; u < n_units; ++u) {
    if (u + 1 < n_units) {  // the next unit's copy flies while this one folds
      stage_unit<P, HD, CODEC, true>(sm.raw + ((u + 1) & 1) * G_::STAGE, unit(u + 1), tid);
      cp_async_commit();
      cp_async_wait_1();
    } else {
      cp_async_wait_0();
    }
    const int t = u / n_sub, sub = u % n_sub;
    fold_unit<P, HD, CODEC>(sm.raw + (u & 1) * G_::STAGE, sm, t * page + sub * KT,
                            min(KT, page - sub * KT), scale, qpos, m, l, acc, tid);
  }
  store_out<P, HD, CODEC>(out, l, acc, b, h, hkv, G, row0, tid);
}

template <typename Q, typename P, int HD, int CODEC>
cudaError_t launch(const void* q, const void* pos, const void* k, const void* v, const void* ks,
                   const void* vs, const void* table, void* out, int b, int hkv, int G, int page,
                   int n_pt, int pipelined, float scale, cudaStream_t st) {
  const size_t smem = Geo<P, HD, CODEC>::smem(pipelined ? 2 : 1);
  auto kern = pipelined ? paged_attn_pipelined_kernel<Q, P, HD, CODEC>
                        : paged_attn_kernel<Q, P, HD, CODEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((G + BM - 1) / BM, hkv, b);
  kern<<<grid, NT, smem, st>>>(static_cast<const Q*>(q), static_cast<const int*>(pos),
                               static_cast<const P*>(k), static_cast<const P*>(v),
                               static_cast<const float*>(ks), static_cast<const float*>(vs),
                               static_cast<const int*>(table), static_cast<float*>(out), G, hkv,
                               page, n_pt, scale);
  return cudaGetLastError();
}

template <typename Q, int HD>
cudaError_t dispatch_pool(int pool_kind, const void* q, const void* pos, const void* k,
                          const void* v, const void* ks, const void* vs, const void* table,
                          void* out, int b, int hkv, int G, int page, int n_pt, int pipelined,
                          float scale, cudaStream_t st) {
  switch (pool_kind) {
    case 0:  // fp pages, stored in q's type
      return launch<Q, Q, HD, FP>(q, pos, k, v, ks, vs, table, out, b, hkv, G, page, n_pt,
                                  pipelined, scale, st);
    case 1:
      return launch<Q, int8_t, HD, INT8>(q, pos, k, v, ks, vs, table, out, b, hkv, G, page,
                                         n_pt, pipelined, scale, st);
    case 2:
      return launch<Q, uint8_t, HD, INT4>(q, pos, k, v, ks, vs, table, out, b, hkv, G, page,
                                          n_pt, pipelined, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename P, int HD, int CODEC>
size_t smem_of(int pipelined) {
  return Geo<P, HD, CODEC>::smem(pipelined ? 2 : 1);
}

}  // namespace

// q [b, hkv, G, hd] (f32, or bf16 when q_bf16), contiguous; pos [b, G] int32;
// pools k/v [P, hkv, page, hd] in q's type (pool_kind 0), int8 (1) or
// [P, hkv, page, hd/2] uint8 (2), contiguous and 16-byte aligned; ks/vs
// [P, hkv, page, 1] f32 for pool_kind 1 and 2 (ignored for 0); table
// [b, n_pt] int32; out [b, hkv, G, hd] f32. hd is 64 or 128; scale is hd^-½
// as the caller rounds it.
extern "C" int paged_attn(const void* q, const void* pos, const void* k, const void* v,
                          const void* ks, const void* vs, const void* table, void* out, int b,
                          int hkv, int G, int hd, int page, int n_pt, int q_bf16, int pool_kind,
                          int pipelined, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return q_bf16 ? dispatch_pool<__nv_bfloat16, 64>(pool_kind, q, pos, k, v, ks, vs, table, out, b, hkv, G, page, n_pt, pipelined, scale, st)
                  : dispatch_pool<float, 64>(pool_kind, q, pos, k, v, ks, vs, table, out, b, hkv, G, page, n_pt, pipelined, scale, st);
  if (hd == 128)
    return q_bf16 ? dispatch_pool<__nv_bfloat16, 128>(pool_kind, q, pos, k, v, ks, vs, table, out, b, hkv, G, page, n_pt, pipelined, scale, st)
                  : dispatch_pool<float, 128>(pool_kind, q, pos, k, v, ks, vs, table, out, b, hkv, G, page, n_pt, pipelined, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one launch, in bytes; fp_bytes is the fp pool's
// element size (4 or 2), ignored for int8/int4 pools.
extern "C" long long paged_attn_smem_bytes(int hd, int pool_kind, int fp_bytes, int pipelined) {
  if (hd != 64 && hd != 128) return -1;
  const bool wide = hd == 128;
  switch (pool_kind) {
    case 0:
      if (fp_bytes == 4) return wide ? smem_of<float, 128, FP>(pipelined) : smem_of<float, 64, FP>(pipelined);
      return wide ? smem_of<__nv_bfloat16, 128, FP>(pipelined) : smem_of<__nv_bfloat16, 64, FP>(pipelined);
    case 1:
      return wide ? smem_of<int8_t, 128, INT8>(pipelined) : smem_of<int8_t, 64, INT8>(pipelined);
    case 2:
      return wide ? smem_of<uint8_t, 128, INT4>(pipelined) : smem_of<uint8_t, 64, INT4>(pipelined);
    default:
      return -1;
  }
}

extern "C" const char* paged_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
