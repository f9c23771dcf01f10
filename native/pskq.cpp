// Native host-side packet queue for psk_soft_tpu.
//
// Native equivalent of the BulkIO input-port queue the reference relies
// on (cpp/psk_soft.cpp:349 getPacket(BLOCKING); overflow => queue flush
// reported via inputQueueFlushed, :353-357).  The demod engines are fed from
// this queue by a host thread while the device crunches the previous block,
// so ingest never stalls the device step.
//
// Semantics:
//  * bounded by bytes and packet count;
//  * push on a full queue FLUSHES it (drops everything queued) and marks the
//    next delivered packet with flushed=1 -- the consumer resets demod state,
//    exactly the reference's accepted-data-loss recovery;
//  * pop blocks with a timeout; EOS packets pass through;
//  * per-queue stats (pushed/popped/flushed/bytes) for observability.
//
// Build: make -C native   (g++ -O2 -shared -fPIC, no external deps)

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Packet {
  std::vector<float> data;  // interleaved IQ
  double t = 0.0;
  double xdelta = 1.0;
  int32_t mode = 1;
  int32_t eos = 0;
  int32_t sri_changed = 0;
  int32_t flushed = 0;
  std::string stream_id;
};

struct Stats {
  uint64_t pushed = 0;
  uint64_t popped = 0;
  uint64_t flushes = 0;
  uint64_t dropped_packets = 0;
  uint64_t bytes_in = 0;
  uint64_t bytes_out = 0;
};

class PacketQueue {
 public:
  PacketQueue(size_t capacity_bytes, size_t max_packets)
      : capacity_bytes_(capacity_bytes), max_packets_(max_packets) {}

  // Returns 1 if this push triggered a flush, else 0.
  int push(const float* data, size_t n_floats, double t, int eos,
           int sri_changed, double xdelta, int mode, const char* stream_id) {
    std::unique_lock<std::mutex> lk(mu_);
    const size_t bytes = n_floats * sizeof(float);
    int flushed = 0;
    if (!q_.empty() &&
        (bytes_queued_ + bytes > capacity_bytes_ || q_.size() >= max_packets_)) {
      // Overflow: drop everything queued (the reference's BulkIO queue does
      // the same and the component resets, cpp/psk_soft.cpp:353-357).
      stats_.dropped_packets += q_.size();
      q_.clear();
      bytes_queued_ = 0;
      stats_.flushes++;
      flushed = 1;
    }
    Packet p;
    p.data.assign(data, data + n_floats);
    p.t = t;
    p.eos = eos;
    p.sri_changed = sri_changed;
    p.xdelta = xdelta;
    p.mode = mode;
    p.stream_id = stream_id ? stream_id : "";
    p.flushed = flushed;
    bytes_queued_ += bytes;
    stats_.pushed++;
    stats_.bytes_in += bytes;
    q_.push_back(std::move(p));
    lk.unlock();
    cv_.notify_one();
    return flushed;
  }

  // Blocks up to timeout_ms; returns number of floats ready, or -1 on
  // timeout.  The packet stays at the head until popped with pop_into.
  int64_t peek(int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    if (timeout_ms < 0) {
      cv_.wait(lk, [&] { return !q_.empty() || closed_; });
    } else {
      cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                   [&] { return !q_.empty() || closed_; });
    }
    if (q_.empty()) return -1;
    return static_cast<int64_t>(q_.front().data.size());
  }

  // Copies the head packet out.  Returns the number of floats copied
  // (>= 0) on success, -1 if empty, -2 if the caller's buffer is too small
  // (the packet stays queued so the caller can re-peek and retry -- the
  // head may have changed between peek and pop under concurrent producers
  // or an overflow flush, and may be SMALLER than the peeked size, which
  // is why the actual count is returned rather than assumed).
  int64_t pop_into(float* out, size_t out_floats, double* t, int32_t* eos,
                   int32_t* sri_changed, double* xdelta, int32_t* mode,
                   int32_t* flushed, char* stream_id, size_t stream_id_cap) {
    std::unique_lock<std::mutex> lk(mu_);
    if (q_.empty()) return -1;
    Packet& p = q_.front();
    if (p.data.size() > out_floats) return -2;
    const size_t n = p.data.size();
    std::memcpy(out, p.data.data(), n * sizeof(float));
    if (t) *t = p.t;
    if (eos) *eos = p.eos;
    if (sri_changed) *sri_changed = p.sri_changed;
    if (xdelta) *xdelta = p.xdelta;
    if (mode) *mode = p.mode;
    if (flushed) *flushed = p.flushed;
    if (stream_id && stream_id_cap > 0) {
      std::snprintf(stream_id, stream_id_cap, "%s", p.stream_id.c_str());
    }
    bytes_queued_ -= p.data.size() * sizeof(float);
    stats_.popped++;
    stats_.bytes_out += n * sizeof(float);
    q_.pop_front();
    return static_cast<int64_t>(n);
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    cv_.notify_all();
  }

  void get_stats(uint64_t* out6) {
    std::lock_guard<std::mutex> lk(mu_);
    out6[0] = stats_.pushed;
    out6[1] = stats_.popped;
    out6[2] = stats_.flushes;
    out6[3] = stats_.dropped_packets;
    out6[4] = stats_.bytes_in;
    out6[5] = stats_.bytes_out;
  }

  size_t depth() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Packet> q_;
  size_t bytes_queued_ = 0;
  size_t capacity_bytes_;
  size_t max_packets_;
  bool closed_ = false;
  Stats stats_;
};

}  // namespace

extern "C" {

void* pskq_create(uint64_t capacity_bytes, uint64_t max_packets) {
  return new PacketQueue(capacity_bytes, max_packets);
}

void pskq_destroy(void* h) { delete static_cast<PacketQueue*>(h); }

int pskq_push(void* h, const float* data, uint64_t n_floats, double t,
              int32_t eos, int32_t sri_changed, double xdelta, int32_t mode,
              const char* stream_id) {
  return static_cast<PacketQueue*>(h)->push(data, n_floats, t, eos,
                                            sri_changed, xdelta, mode,
                                            stream_id);
}

int64_t pskq_peek(void* h, int64_t timeout_ms) {
  return static_cast<PacketQueue*>(h)->peek(timeout_ms);
}

int64_t pskq_pop_into(void* h, float* out, uint64_t out_floats, double* t,
                      int32_t* eos, int32_t* sri_changed, double* xdelta,
                      int32_t* mode, int32_t* flushed, char* stream_id,
                      uint64_t stream_id_cap) {
  return static_cast<PacketQueue*>(h)->pop_into(out, out_floats, t, eos,
                                                sri_changed, xdelta, mode,
                                                flushed, stream_id,
                                                stream_id_cap);
}

void pskq_close(void* h) { static_cast<PacketQueue*>(h)->close(); }

void pskq_stats(void* h, uint64_t* out6) {
  static_cast<PacketQueue*>(h)->get_stats(out6);
}

uint64_t pskq_depth(void* h) {
  return static_cast<PacketQueue*>(h)->depth();
}

}  // extern "C"
