// C ABI KV-event shim: lets engines written in any language publish KV cache
// events into the framework's event plane without linking Python.
//
// Reference semantics (not code): lib/bindings/c/src/lib.rs:51-296 —
// `dynamo_llm_init` / `dynamo_kv_event_publish_stored/removed` form a C API
// that the patched vLLM calls via ctypes to publish KV events.  Here the shim
// is a lock-protected ring: the engine thread pushes binary event records,
// and the host-side Python publisher (dynamo_tpu_torch/native.py drain loop)
// forwards them onto the event plane.  This inverts the reference's design
// (which pushes straight to NATS from Rust) because our event plane client
// is asyncio Python; the ring keeps the C ABI dependency-free and the
// engine's publish call wait-free in the common case.
//
// Record layout (little-endian):
//   u8  type        (1 = stored, 2 = removed, 3 = cleared)
//   u64 event_id
//   u64 parent_hash (stored only; 0 = root)
//   u32 n
//   n × { u64 seq_hash, u64 tokens_hash }   (removed: tokens_hash = 0)

#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Shim {
  std::mutex mu;
  std::deque<std::vector<uint8_t>> queue;
  uint64_t worker_id = 0;
  uint64_t next_event_id = 0;
  uint64_t dropped = 0;
  size_t capacity = 65536;  // max queued events before drop-oldest
  bool initialized = false;
};

Shim& shim() {
  static Shim s;
  return s;
}

void push_record(std::vector<uint8_t>&& rec) {
  Shim& s = shim();
  std::lock_guard<std::mutex> lock(s.mu);
  if (s.queue.size() >= s.capacity) {
    s.queue.pop_front();
    ++s.dropped;
  }
  s.queue.push_back(std::move(rec));
}

void append_u64(std::vector<uint8_t>& buf, uint64_t v) {
  const size_t off = buf.size();
  buf.resize(off + 8);
  std::memcpy(buf.data() + off, &v, 8);
}

void append_u32(std::vector<uint8_t>& buf, uint32_t v) {
  const size_t off = buf.size();
  buf.resize(off + 4);
  std::memcpy(buf.data() + off, &v, 4);
}

}  // namespace

extern "C" {

// Returns 0 on success.  worker_id is stamped by the drain side (it knows
// the runtime identity); it is recorded here for diagnostics only.
int dyn_kv_init(uint64_t worker_id, uint64_t capacity) {
  Shim& s = shim();
  std::lock_guard<std::mutex> lock(s.mu);
  s.worker_id = worker_id;
  if (capacity > 0) s.capacity = static_cast<size_t>(capacity);
  s.initialized = true;
  return 0;
}

void dyn_kv_shutdown() {
  Shim& s = shim();
  std::lock_guard<std::mutex> lock(s.mu);
  s.queue.clear();
  s.initialized = false;
}

int dyn_kv_publish_stored(uint64_t parent_hash, const uint64_t* seq_hashes,
                          const uint64_t* tokens_hashes, uint32_t n) {
  Shim& s = shim();
  if (!s.initialized) return -1;
  std::vector<uint8_t> rec;
  rec.reserve(1 + 8 + 8 + 4 + 16ull * n);
  rec.push_back(1);
  uint64_t event_id;
  {
    std::lock_guard<std::mutex> lock(s.mu);
    event_id = ++s.next_event_id;
  }
  append_u64(rec, event_id);
  append_u64(rec, parent_hash);
  append_u32(rec, n);
  for (uint32_t i = 0; i < n; ++i) {
    append_u64(rec, seq_hashes[i]);
    append_u64(rec, tokens_hashes ? tokens_hashes[i] : 0);
  }
  push_record(std::move(rec));
  return 0;
}

int dyn_kv_publish_removed(const uint64_t* seq_hashes, uint32_t n) {
  Shim& s = shim();
  if (!s.initialized) return -1;
  std::vector<uint8_t> rec;
  rec.reserve(1 + 8 + 8 + 4 + 16ull * n);
  rec.push_back(2);
  uint64_t event_id;
  {
    std::lock_guard<std::mutex> lock(s.mu);
    event_id = ++s.next_event_id;
  }
  append_u64(rec, event_id);
  append_u64(rec, 0);
  append_u32(rec, n);
  for (uint32_t i = 0; i < n; ++i) {
    append_u64(rec, seq_hashes[i]);
    append_u64(rec, 0);
  }
  push_record(std::move(rec));
  return 0;
}

int dyn_kv_publish_cleared() {
  Shim& s = shim();
  if (!s.initialized) return -1;
  std::vector<uint8_t> rec;
  rec.push_back(3);
  uint64_t event_id;
  {
    std::lock_guard<std::mutex> lock(s.mu);
    event_id = ++s.next_event_id;
  }
  append_u64(rec, event_id);
  append_u64(rec, 0);
  append_u32(rec, 0);
  push_record(std::move(rec));
  return 0;
}

// Copies whole records into buf until the next record would not fit.
// Returns bytes written (0 = queue empty).
int64_t dyn_kv_drain(uint8_t* buf, uint64_t buf_len) {
  Shim& s = shim();
  std::lock_guard<std::mutex> lock(s.mu);
  uint64_t written = 0;
  while (!s.queue.empty()) {
    const std::vector<uint8_t>& rec = s.queue.front();
    if (written + rec.size() > buf_len) break;
    std::memcpy(buf + written, rec.data(), rec.size());
    written += rec.size();
    s.queue.pop_front();
  }
  return static_cast<int64_t>(written);
}

uint64_t dyn_kv_dropped() {
  Shim& s = shim();
  std::lock_guard<std::mutex> lock(s.mu);
  return s.dropped;
}

}  // extern "C"
