// The port's native host runtime: its own copy of the C++ host layer.
//
// The host-side runtime pieces of the control plane (the reference's
// equivalent layer is Go: device memory map + stream state machine in
// DSML/gpu_device_service/gpu_device_server.go, byte-wise reduction in
// DSML/gpu_coordinator_service/gpu_coordinator_server.go:540-543,681-686,
// ring schedule in :379-419, IDX parsing in DSML/client/client.go:270-350):
//
//   * arena        — bounds-checked flat-address buffer registry with the
//                    framework's splice/logical-size semantics.
//   * stream       — chunked P2P reassembly + length validation state machine.
//   * ring planner — the 2(n-1)-step scatter-reduce/all-gather segment
//                    schedule (send/recv indices per rank per step).
//   * reduce       — elementwise f32 reductions (SUM/PROD/MIN/MAX/AVG)
//                    for the coordinator's host path.
//   * idx parser   — IDX (MNIST) header/payload decoding.
//   * prefetch     — background-thread batch gather into a slot ring (the
//                    double-buffered input pipeline; host copy overlaps the
//                    device step).
//   * crc32c       — the frame checksum of shard migration and the serving
//                    handoff codec.
//
// C ABI throughout; Python binds via ctypes (dsml_tpu_torch/runtime/native.py),
// which builds this file with g++ into build/native/ on first use.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// error codes (mirror the gRPC codes the Python layer maps them to)
// ---------------------------------------------------------------------------
enum DsStatus : int32_t {
  DS_OK = 0,
  DS_OUT_OF_RANGE = 1,
  DS_NOT_FOUND = 2,
  DS_INVALID = 3,
  DS_FAILED = 4,
  DS_IN_PROGRESS = 5,
};

// ---------------------------------------------------------------------------
// arena
// ---------------------------------------------------------------------------

struct DsBuffer {
  std::vector<uint8_t> data;
  uint64_t logical = 0;  // bytes of the most recent write
};

struct DsArena {
  uint64_t min_addr;
  uint64_t max_addr;
  std::map<uint64_t, DsBuffer> buffers;
  std::mutex mu;
};

void* ds_arena_new(uint64_t min_addr, uint64_t size) {
  auto* a = new DsArena();
  a->min_addr = min_addr;
  a->max_addr = min_addr + size;
  return a;
}

void ds_arena_free(void* arena) { delete static_cast<DsArena*>(arena); }

int32_t ds_arena_write(void* arena, uint64_t addr, const uint8_t* data, uint64_t len) {
  auto* a = static_cast<DsArena*>(arena);
  // `addr + len` could wrap uint64 for a corrupt wire address; compare the
  // remaining window instead
  if (addr < a->min_addr || addr > a->max_addr || len > a->max_addr - addr)
    return DS_OUT_OF_RANGE;
  std::lock_guard<std::mutex> lock(a->mu);
  DsBuffer& buf = a->buffers[addr];
  if (buf.data.size() > len) {
    // splice: shorter write lands in the prefix, tail survives
    std::memcpy(buf.data.data(), data, len);
  } else {
    buf.data.assign(data, data + len);
  }
  buf.logical = len;
  return DS_OK;
}

int64_t ds_arena_read(void* arena, uint64_t addr, uint8_t* out, uint64_t len) {
  // returns bytes copied, or -status on error; len==0 => full buffer size query
  auto* a = static_cast<DsArena*>(arena);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->buffers.find(addr);
  if (it == a->buffers.end()) return -DS_NOT_FOUND;
  const DsBuffer& buf = it->second;
  if (len == 0) return static_cast<int64_t>(buf.data.size());
  if (len > buf.data.size()) return -DS_OUT_OF_RANGE;
  std::memcpy(out, buf.data.data(), len);
  return static_cast<int64_t>(len);
}

int64_t ds_arena_logical_size(void* arena, uint64_t addr) {
  auto* a = static_cast<DsArena*>(arena);
  std::lock_guard<std::mutex> lock(a->mu);
  auto it = a->buffers.find(addr);
  if (it == a->buffers.end()) return -DS_NOT_FOUND;
  return static_cast<int64_t>(it->second.logical);
}

// ---------------------------------------------------------------------------
// stream reassembly
// ---------------------------------------------------------------------------

struct DsStream {
  std::vector<uint8_t> chunks;
  uint64_t expected = 0;
  uint64_t recv_addr = 0;
  bool armed = false;
  int32_t status = DS_IN_PROGRESS;
};

struct DsStreamEngine {
  std::map<uint64_t, DsStream> streams;
  std::mutex mu;
};

void* ds_streams_new() { return new DsStreamEngine(); }
void ds_streams_free(void* eng) { delete static_cast<DsStreamEngine*>(eng); }

static void ds_stream_try_complete(DsArena* arena, DsStream& st) {
  if (!st.armed) return;
  if (st.chunks.size() == st.expected && st.expected > 0) {
    int32_t rc = ds_arena_write(arena, st.recv_addr, st.chunks.data(), st.chunks.size());
    st.status = (rc == DS_OK) ? DS_OK : DS_FAILED;
    st.chunks.clear();
    st.chunks.shrink_to_fit();
  } else if (st.chunks.size() > st.expected) {
    st.status = DS_FAILED;
  }
}

int32_t ds_stream_arm(void* eng, void* arena, uint64_t stream_id, uint64_t recv_addr,
                      uint64_t expected) {
  auto* e = static_cast<DsStreamEngine*>(eng);
  auto* a = static_cast<DsArena*>(arena);
  if (recv_addr < a->min_addr || recv_addr > a->max_addr || expected > a->max_addr - recv_addr)
    return DS_OUT_OF_RANGE;
  std::lock_guard<std::mutex> lock(e->mu);
  DsStream& st = e->streams[stream_id];
  st.recv_addr = recv_addr;
  st.expected = expected;
  st.armed = true;
  ds_stream_try_complete(a, st);
  return DS_OK;
}

int32_t ds_stream_push(void* eng, void* arena, uint64_t stream_id, const uint8_t* chunk,
                       uint64_t len, int32_t final_chunk) {
  auto* e = static_cast<DsStreamEngine*>(eng);
  auto* a = static_cast<DsArena*>(arena);
  std::lock_guard<std::mutex> lock(e->mu);
  DsStream& st = e->streams[stream_id];
  st.chunks.insert(st.chunks.end(), chunk, chunk + len);
  ds_stream_try_complete(a, st);
  if (final_chunk && st.armed && st.status == DS_IN_PROGRESS) st.status = DS_FAILED;
  return st.status == DS_FAILED ? DS_FAILED : DS_OK;
}

int32_t ds_stream_status(void* eng, uint64_t stream_id) {
  auto* e = static_cast<DsStreamEngine*>(eng);
  std::lock_guard<std::mutex> lock(e->mu);
  auto it = e->streams.find(stream_id);
  if (it == e->streams.end()) return -DS_NOT_FOUND;
  return it->second.status;
}

// ---------------------------------------------------------------------------
// ring schedule planner (gpu_coordinator_server.go:393-419 semantics)
// ---------------------------------------------------------------------------

// Fills send_idx/recv_idx, each [2*(n-1)] entries for `rank`: first n-1
// scatter-reduce steps, then n-1 all-gather steps.
int32_t ds_ring_plan(int32_t n, int32_t rank, int32_t* send_idx, int32_t* recv_idx) {
  if (n < 2 || rank < 0 || rank >= n) return DS_INVALID;
  auto mod = [n](int32_t v) { return ((v % n) + n) % n; };
  for (int32_t step = 0; step < n - 1; ++step) {
    send_idx[step] = mod(rank - step);
    recv_idx[step] = mod(rank - step - 1);
  }
  for (int32_t step = 0; step < n - 1; ++step) {
    send_idx[n - 1 + step] = mod(rank - step + 1);
    recv_idx[n - 1 + step] = mod(rank - step);
  }
  return DS_OK;
}

// ---------------------------------------------------------------------------
// dtype-aware reduction (coordinator host fallback path)
// ---------------------------------------------------------------------------

enum DsOp : int32_t { DS_SUM = 0, DS_PROD = 1, DS_MIN = 2, DS_MAX = 3, DS_AVG = 4 };

// rows: n_rows contiguous f32 rows of n elems each; out: n elems
int32_t ds_reduce_f32(const float* rows, int64_t n_rows, int64_t n, int32_t op, float* out) {
  if (n_rows < 1) return DS_INVALID;
  std::memcpy(out, rows, n * sizeof(float));
  for (int64_t r = 1; r < n_rows; ++r) {
    const float* row = rows + r * n;
    switch (op) {
      case DS_SUM:
      case DS_AVG:
        for (int64_t i = 0; i < n; ++i) out[i] += row[i];
        break;
      case DS_PROD:
        for (int64_t i = 0; i < n; ++i) out[i] *= row[i];
        break;
      case DS_MIN:
        for (int64_t i = 0; i < n; ++i) out[i] = row[i] < out[i] ? row[i] : out[i];
        break;
      case DS_MAX:
        for (int64_t i = 0; i < n; ++i) out[i] = row[i] > out[i] ? row[i] : out[i];
        break;
      default:
        return DS_INVALID;
    }
  }
  if (op == DS_AVG) {
    const float inv = 1.0f / static_cast<float>(n_rows);
    for (int64_t i = 0; i < n; ++i) out[i] *= inv;
  }
  return DS_OK;
}

// ---------------------------------------------------------------------------
// IDX (MNIST) parsing
// ---------------------------------------------------------------------------

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Parses an (un-gzipped) IDX blob. dims_out must hold 3 entries:
// images -> [count, rows, cols]; labels -> [count, 0, 0].
// Returns the payload byte offset, or -status.
int64_t ds_idx_parse(const uint8_t* buf, uint64_t len, int32_t* dims_out) {
  if (len < 8) return -DS_INVALID;
  uint32_t magic = be32(buf);
  if (magic == 2051) {  // images
    if (len < 16) return -DS_INVALID;
    dims_out[0] = static_cast<int32_t>(be32(buf + 4));
    dims_out[1] = static_cast<int32_t>(be32(buf + 8));
    dims_out[2] = static_cast<int32_t>(be32(buf + 12));
    uint64_t need = 16ull + uint64_t(dims_out[0]) * dims_out[1] * dims_out[2];
    if (len < need) return -DS_INVALID;
    return 16;
  }
  if (magic == 2049) {  // labels
    dims_out[0] = static_cast<int32_t>(be32(buf + 4));
    dims_out[1] = 0;
    dims_out[2] = 0;
    if (len < 8ull + uint64_t(dims_out[0])) return -DS_INVALID;
    return 8;
  }
  return -DS_INVALID;
}

// ---------------------------------------------------------------------------
// prefetching batch loader
// ---------------------------------------------------------------------------
// Background producer thread gathers batch rows from a borrowed dataset
// blob into a ring of `depth` slots while the consumer (the training loop)
// is inside its device step — the host-side gather/copy overlaps device
// compute instead of serializing with it (the double-buffered input
// pipeline a real data loader provides; the reference's loader is a
// synchronous Go loop, client.go:270-350 + :579-653).

struct DsPrefetch {
  const uint8_t* data;    // borrowed — caller keeps the dataset alive
  uint64_t n_rows = 0, row_bytes = 0;
  const int32_t* idx;     // borrowed [n_batches * batch] row indices
  uint64_t n_batches = 0, batch = 0, depth = 0;
  std::vector<std::vector<uint8_t>> slots;
  uint64_t head = 0;      // next batch the producer fills
  uint64_t tail = 0;      // next batch the consumer takes
  std::atomic<bool> stop{false};
  int32_t error = DS_OK;
  std::mutex mu;
  std::condition_variable cv_prod, cv_cons;
  std::thread worker;
};

static void ds_prefetch_run(DsPrefetch* p) {
  for (;;) {
    std::unique_lock<std::mutex> lock(p->mu);
    p->cv_prod.wait(lock, [p] {
      return p->stop.load() || p->head - p->tail < p->depth;
    });
    if (p->stop.load() || p->head >= p->n_batches || p->error != DS_OK) return;
    uint64_t b = p->head;
    lock.unlock();  // gather outside the lock: the consumer may drain slots

    std::vector<uint8_t>& slot = p->slots[b % p->depth];
    int32_t err = DS_OK;
    for (uint64_t j = 0; j < p->batch; ++j) {
      int64_t row = p->idx[b * p->batch + j];
      if (row < 0 || uint64_t(row) >= p->n_rows) {
        err = DS_OUT_OF_RANGE;
        break;
      }
      std::memcpy(slot.data() + j * p->row_bytes,
                  p->data + uint64_t(row) * p->row_bytes, p->row_bytes);
    }

    lock.lock();
    if (err != DS_OK) {
      p->error = err;
      p->cv_cons.notify_all();
      return;
    }
    p->head = b + 1;
    bool done = p->head >= p->n_batches;
    p->cv_cons.notify_all();
    if (done) return;
  }
}

void* ds_prefetch_new(const uint8_t* data, uint64_t n_rows, uint64_t row_bytes,
                      const int32_t* idx, uint64_t n_batches, uint64_t batch,
                      uint64_t depth) {
  // depth is a small ring (2-4 in practice); a huge value — e.g. Python's
  // -1 wrapped through uint64 — would make the slot allocation throw
  // bad_alloc straight through the C ABI and abort the process
  if (depth == 0 || depth > 1024 || batch == 0 || row_bytes == 0) return nullptr;
  auto* p = new DsPrefetch();
  p->data = data;
  p->n_rows = n_rows;
  p->row_bytes = row_bytes;
  p->idx = idx;
  p->n_batches = n_batches;
  p->batch = batch;
  p->depth = depth;
  p->slots.assign(depth, std::vector<uint8_t>(batch * row_bytes));
  p->worker = std::thread(ds_prefetch_run, p);
  return p;
}

// Blocks until the next batch is ready and copies it into `out`
// ([batch * row_bytes] bytes). Returns the batch index, -1 once all
// batches were delivered, or -2 on a producer error (bad row index).
int64_t ds_prefetch_next(void* handle, uint8_t* out) {
  auto* p = static_cast<DsPrefetch*>(handle);
  std::unique_lock<std::mutex> lock(p->mu);
  p->cv_cons.wait(lock, [p] {
    return p->tail < p->head || p->error != DS_OK || p->tail >= p->n_batches;
  });
  // drain already-produced batches BEFORE surfacing a producer error, so
  // delivery up to the bad batch is deterministic regardless of how far
  // ahead the producer ran
  if (p->tail >= p->n_batches) return -1;
  if (p->tail >= p->head && p->error != DS_OK) return -2;
  uint64_t b = p->tail;
  std::memcpy(out, p->slots[b % p->depth].data(), p->batch * p->row_bytes);
  p->tail = b + 1;
  p->cv_prod.notify_one();
  return static_cast<int64_t>(b);
}

void ds_prefetch_free(void* handle) {
  auto* p = static_cast<DsPrefetch*>(handle);
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stop.store(true);
  }
  p->cv_prod.notify_all();
  p->cv_cons.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

// ---------------------------------------------------------------------------
// crc32c — Castagnoli CRC (poly 0x1EDC6F41, reflected 0x82F63B78), the
// frame checksum of the P2P shard-migration path (comm/migration.py)
// and of the serving handoff codec (serving/handoff.py).
// Table-driven byte-at-a-time: sequential-dependency CRCs cannot be
// vectorized in numpy, so the hot loop lives here; the Python fallback in
// utils/crc32c.py is bit-identical but ~100x slower.
// ---------------------------------------------------------------------------

static uint32_t g_crc32c_tbl[256];
static std::once_flag g_crc32c_once;

static void ds_crc32c_build_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1u) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    g_crc32c_tbl[i] = c;
  }
}

// Rolling API: pass the previous return value as `crc` to extend a running
// checksum across chunks (start with 0); one-shot callers pass crc=0.
uint32_t ds_crc32c(const uint8_t* data, uint64_t n, uint32_t crc) {
  std::call_once(g_crc32c_once, ds_crc32c_build_table);
  crc = ~crc;
  for (uint64_t i = 0; i < n; ++i)
    crc = g_crc32c_tbl[(crc ^ data[i]) & 0xffu] ^ (crc >> 8);
  return ~crc;
}

}  // extern "C"
