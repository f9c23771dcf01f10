// Native channel-bank ring for psk_soft_tpu.
//
// Array-native equivalent of the channelizer->component fan-out the reference
// deploys one CPU process per channel for (each rh.psk_soft instance owns one
// BulkIO stream).  Here thousands of channels feed ONE device step, so the
// host-side job is deframing: sample-interleaved frames (s0c0 s0c1 ...
// s0c[C-1] s1c0 ..., complex64 each) arrive from a socket/file/SDR and must
// become channel-major contiguous blocks (C, n) for the device DMA.  Doing
// that per channel in Python costs C slice-copies per chunk; this ring does
// one strided pass in C++ while the producer thread runs concurrently with
// the engine's device step.
//
// Semantics (mirror native/pskq.cpp, cpp/psk_soft.cpp:353-357):
//  * fixed channel count, bounded per-channel capacity;
//  * a push that would overflow FLUSHES the ring (drops everything) and
//    marks the next pop flushed=1 -- accepted-data-loss recovery; the
//    consumer resets demod state;
//  * pops block with a timeout until a full block is available;
//  * frame-aligned pushes keep every channel at the same depth (lockstep
//    bank), so one head/count pair serves all channels.
//
// Build: make -C native   (g++ -O2 -shared -fPIC, no external deps)

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

class ChannelBank {
 public:
  ChannelBank(int32_t channels, int64_t capacity_samples)
      : C_(channels), cap_(capacity_samples),
        ring_(static_cast<size_t>(channels) * capacity_samples * 2) {}

  // Push n_frames sample-interleaved complex64 frames (2*C_*n floats).
  // Returns 1 if this push triggered an overflow flush, 0 otherwise.
  int push_interleaved(const float* iq, int64_t n_frames) {
    std::unique_lock<std::mutex> lk(mu_);
    int flushed = 0;
    if (count_ + n_frames > cap_) {
      stats_dropped_ += count_;
      head_ = 0;
      count_ = 0;
      stats_flushes_++;
      flush_pending_ = true;
      flushed = 1;
      if (n_frames > cap_) {
        // Larger than the whole ring: keep the most recent cap_ frames
        // (the older ones are already lost by the flush semantics).
        iq += (n_frames - cap_) * C_ * 2;
        stats_dropped_ += n_frames - cap_;
        n_frames = cap_;
      }
    }
    // Deinterleave into per-channel rings.  Channel c's ring occupies
    // ring_[c*cap_*2 .. (c+1)*cap_*2); positions are (head_+count_+i)%cap_.
    // Cache-blocked transpose: a naive per-channel pass re-reads the whole
    // source once per channel (8*C-byte stride), which thrashes at large C;
    // (BI x BC) tiles keep both source rows and destination runs resident.
    const int64_t start = (head_ + count_) % cap_;
    const int64_t first = std::min(n_frames, cap_ - start);  // until wrap
    deinterleave(iq, 0, first, start);
    deinterleave(iq + first * C_ * 2, first, n_frames, 0);
    // (second call covers the wrapped region; frames [first, n_frames) land
    // at ring positions [0, n_frames-first))
    count_ += n_frames;
    stats_frames_in_ += n_frames;
    lk.unlock();
    cv_.notify_one();
    return flushed;
  }

  // Wait until at least min_needed samples per channel are queued (or EOS /
  // timeout).  Returns the available count, or -1 on timeout with nothing.
  int64_t available(int64_t min_needed, int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    auto ready = [&] { return count_ >= min_needed || closed_; };
    if (timeout_ms < 0) {
      cv_.wait(lk, ready);
    } else {
      cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready);
    }
    if (count_ < min_needed && !closed_) return -1;
    return count_;
  }

  // Copy n samples per channel, channel-major (C, n) complex64, into out
  // (2*C*n floats) and advance.  out_flushed reports (and clears) the
  // overflow marker.  Returns n, or -1 if fewer than n samples are queued.
  int64_t pop_block(float* out, int64_t n, int32_t* out_flushed) {
    std::unique_lock<std::mutex> lk(mu_);
    if (count_ < n) return -1;
    const int64_t first = std::min(n, cap_ - head_);
    for (int32_t c = 0; c < C_; ++c) {
      const float* ring_c = ring_.data() + static_cast<size_t>(c) * cap_ * 2;
      float* dst = out + static_cast<size_t>(c) * n * 2;
      std::memcpy(dst, ring_c + head_ * 2, first * 2 * sizeof(float));
      std::memcpy(dst + first * 2, ring_c, (n - first) * 2 * sizeof(float));
    }
    head_ = (head_ + n) % cap_;
    count_ -= n;
    stats_samples_out_ += n;
    if (out_flushed) *out_flushed = flush_pending_ ? 1 : 0;
    flush_pending_ = false;
    return n;
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    cv_.notify_all();
  }

  int64_t depth() {
    std::lock_guard<std::mutex> lk(mu_);
    return count_;
  }

  void get_stats(uint64_t* out4) {
    std::lock_guard<std::mutex> lk(mu_);
    out4[0] = stats_frames_in_;
    out4[1] = stats_samples_out_;
    out4[2] = stats_flushes_;
    out4[3] = stats_dropped_;
  }

 private:
  // Copy frames [i_lo, i_hi) of the interleaved source (iq points at frame
  // i_lo) to ring positions dst0 + (i - i_lo), per channel.  Complex64
  // elements move as single 8-byte loads/stores (memcpy folds to one mov).
  void deinterleave(const float* iq, int64_t i_lo, int64_t i_hi,
                    int64_t dst0) {
    constexpr int64_t BI = 64;   // frames per tile
    constexpr int64_t BC = 16;   // channels per tile
    const int64_t n = i_hi - i_lo;
    for (int64_t i0 = 0; i0 < n; i0 += BI) {
      const int64_t i1 = std::min(i0 + BI, n);
      for (int32_t c0 = 0; c0 < C_; c0 += BC) {
        const int32_t c1 = std::min<int64_t>(c0 + BC, C_);
        for (int32_t c = c0; c < c1; ++c) {
          float* ring_c = ring_.data() + static_cast<size_t>(c) * cap_ * 2;
          const float* src = iq + (i0 * C_ + c) * 2;
          float* dst = ring_c + (dst0 + i0) * 2;
          for (int64_t i = i0; i < i1; ++i) {
            std::memcpy(dst, src, 2 * sizeof(float));
            src += 2 * C_;
            dst += 2;
          }
        }
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  const int32_t C_;
  const int64_t cap_;
  std::vector<float> ring_;  // channel-major: C_ rings of cap_ complex
  int64_t head_ = 0;         // read index, in samples
  int64_t count_ = 0;        // queued samples per channel
  bool closed_ = false;
  bool flush_pending_ = false;
  uint64_t stats_frames_in_ = 0;
  uint64_t stats_samples_out_ = 0;
  uint64_t stats_flushes_ = 0;
  uint64_t stats_dropped_ = 0;
};

// Plane bank: same flush/lockstep semantics, but the ring holds TIME-MAJOR
// re/im planes -- the fused kernel's exact input layout (demod_kernel
// demod_full_tm takes (T, C) planes).  Interleaved frames are already
// time-major across channels, so deframing is a stride-2 re/im split (no
// transpose at all), and popping is two contiguous memcpys.  This removes
// the per-block host transposes the channel-major bank forces on the
// engine (engine.py x.real.T copies).  T = float (complex64 wire) or
// int16_t (i16 I/Q wire, half the bytes end to end -- pairs with the
// kernel's int16 ingest mode).
template <typename T>
class PlaneBank {
 public:
  PlaneBank(int32_t channels, int64_t capacity_samples)
      : C_(channels), cap_(capacity_samples),
        re_(static_cast<size_t>(channels) * capacity_samples),
        im_(static_cast<size_t>(channels) * capacity_samples) {}

  // Push n_frames interleaved frames (2*C_*n elements: s0c0_re s0c0_im
  // s0c1_re ...).  Returns 1 if this push triggered an overflow flush.
  int push_interleaved(const T* iq, int64_t n_frames) {
    std::unique_lock<std::mutex> lk(mu_);
    int flushed = 0;
    if (count_ + n_frames > cap_) {
      stats_dropped_ += count_;
      head_ = 0;
      count_ = 0;
      stats_flushes_++;
      flush_pending_ = true;
      flushed = 1;
      if (n_frames > cap_) {
        iq += (n_frames - cap_) * C_ * 2;
        stats_dropped_ += n_frames - cap_;
        n_frames = cap_;
      }
    }
    const int64_t start = (head_ + count_) % cap_;
    const int64_t first = std::min(n_frames, cap_ - start);
    split(iq, first, start);
    split(iq + first * C_ * 2, n_frames - first, 0);
    count_ += n_frames;
    stats_frames_in_ += n_frames;
    lk.unlock();
    cv_.notify_one();
    return flushed;
  }

  int64_t available(int64_t min_needed, int64_t timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    auto ready = [&] { return count_ >= min_needed || closed_; };
    if (timeout_ms < 0) {
      cv_.wait(lk, ready);
    } else {
      cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready);
    }
    if (count_ < min_needed && !closed_) return -1;
    return count_;
  }

  // Copy n time-major rows into out_re/out_im ((n, C) each) and advance.
  int64_t pop_planes(T* out_re, T* out_im, int64_t n, int32_t* out_flushed) {
    std::unique_lock<std::mutex> lk(mu_);
    if (count_ < n) return -1;
    const int64_t first = std::min(n, cap_ - head_);
    const size_t row = static_cast<size_t>(C_);
    std::memcpy(out_re, re_.data() + head_ * row, first * row * sizeof(T));
    std::memcpy(out_im, im_.data() + head_ * row, first * row * sizeof(T));
    std::memcpy(out_re + first * row, re_.data(),
                (n - first) * row * sizeof(T));
    std::memcpy(out_im + first * row, im_.data(),
                (n - first) * row * sizeof(T));
    head_ = (head_ + n) % cap_;
    count_ -= n;
    stats_samples_out_ += n;
    if (out_flushed) *out_flushed = flush_pending_ ? 1 : 0;
    flush_pending_ = false;
    return n;
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    cv_.notify_all();
  }

  int64_t depth() {
    std::lock_guard<std::mutex> lk(mu_);
    return count_;
  }

  void get_stats(uint64_t* out4) {
    std::lock_guard<std::mutex> lk(mu_);
    out4[0] = stats_frames_in_;
    out4[1] = stats_samples_out_;
    out4[2] = stats_flushes_;
    out4[3] = stats_dropped_;
  }

 private:
  // Stride-2 split of n frames starting at ring row dst0: both the source
  // frame and the destination rows are contiguous runs of C_ elements.
  void split(const T* iq, int64_t n, int64_t dst0) {
    for (int64_t i = 0; i < n; ++i) {
      T* dr = re_.data() + (dst0 + i) * C_;
      T* di = im_.data() + (dst0 + i) * C_;
      const T* src = iq + i * C_ * 2;
      for (int32_t c = 0; c < C_; ++c) {
        dr[c] = src[2 * c];
        di[c] = src[2 * c + 1];
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  const int32_t C_;
  const int64_t cap_;
  std::vector<T> re_, im_;   // time-major (cap, C) plane rings
  int64_t head_ = 0;
  int64_t count_ = 0;
  bool closed_ = false;
  bool flush_pending_ = false;
  uint64_t stats_frames_in_ = 0;
  uint64_t stats_samples_out_ = 0;
  uint64_t stats_flushes_ = 0;
  uint64_t stats_dropped_ = 0;
};

// elem_bytes-dispatched wrapper (4 = float planes, 2 = int16 planes).
struct PlaneBankAny {
  PlaneBank<float>* f32 = nullptr;
  PlaneBank<int16_t>* i16 = nullptr;
  ~PlaneBankAny() {
    delete f32;
    delete i16;
  }
};

}  // namespace

extern "C" {

void* pskbank_create(int32_t channels, int64_t capacity_samples) {
  if (channels <= 0 || capacity_samples <= 0) return nullptr;
  return new ChannelBank(channels, capacity_samples);
}

void pskbank_destroy(void* h) { delete static_cast<ChannelBank*>(h); }

int pskbank_push_interleaved(void* h, const float* iq, int64_t n_frames) {
  if (n_frames < 0) return -1;
  if (n_frames == 0) return 0;
  return static_cast<ChannelBank*>(h)->push_interleaved(iq, n_frames);
}

int64_t pskbank_available(void* h, int64_t min_needed, int64_t timeout_ms) {
  return static_cast<ChannelBank*>(h)->available(min_needed, timeout_ms);
}

int64_t pskbank_pop_block(void* h, float* out, int64_t n,
                          int32_t* out_flushed) {
  return static_cast<ChannelBank*>(h)->pop_block(out, n, out_flushed);
}

void pskbank_close(void* h) { static_cast<ChannelBank*>(h)->close(); }

int64_t pskbank_depth(void* h) {
  return static_cast<ChannelBank*>(h)->depth();
}

void pskbank_stats(void* h, uint64_t* out4) {
  static_cast<ChannelBank*>(h)->get_stats(out4);
}

// ---- plane bank (time-major re/im planes; elem_bytes = 4 or 2) ----

void* pskplane_create(int32_t channels, int64_t capacity_samples,
                      int32_t elem_bytes) {
  if (channels <= 0 || capacity_samples <= 0) return nullptr;
  if (elem_bytes != 4 && elem_bytes != 2) return nullptr;
  auto* any = new PlaneBankAny();
  if (elem_bytes == 4) {
    any->f32 = new PlaneBank<float>(channels, capacity_samples);
  } else {
    any->i16 = new PlaneBank<int16_t>(channels, capacity_samples);
  }
  return any;
}

void pskplane_destroy(void* h) { delete static_cast<PlaneBankAny*>(h); }

int pskplane_push_interleaved(void* h, const void* iq, int64_t n_frames) {
  if (n_frames < 0) return -1;
  if (n_frames == 0) return 0;
  auto* any = static_cast<PlaneBankAny*>(h);
  if (any->f32) {
    return any->f32->push_interleaved(static_cast<const float*>(iq),
                                      n_frames);
  }
  return any->i16->push_interleaved(static_cast<const int16_t*>(iq),
                                    n_frames);
}

int64_t pskplane_available(void* h, int64_t min_needed, int64_t timeout_ms) {
  auto* any = static_cast<PlaneBankAny*>(h);
  return any->f32 ? any->f32->available(min_needed, timeout_ms)
                  : any->i16->available(min_needed, timeout_ms);
}

int64_t pskplane_pop_planes(void* h, void* out_re, void* out_im, int64_t n,
                            int32_t* out_flushed) {
  auto* any = static_cast<PlaneBankAny*>(h);
  if (any->f32) {
    return any->f32->pop_planes(static_cast<float*>(out_re),
                                static_cast<float*>(out_im), n, out_flushed);
  }
  return any->i16->pop_planes(static_cast<int16_t*>(out_re),
                              static_cast<int16_t*>(out_im), n, out_flushed);
}

void pskplane_close(void* h) {
  auto* any = static_cast<PlaneBankAny*>(h);
  any->f32 ? any->f32->close() : any->i16->close();
}

int64_t pskplane_depth(void* h) {
  auto* any = static_cast<PlaneBankAny*>(h);
  return any->f32 ? any->f32->depth() : any->i16->depth();
}

void pskplane_stats(void* h, uint64_t* out4) {
  auto* any = static_cast<PlaneBankAny*>(h);
  any->f32 ? any->f32->get_stats(out4) : any->i16->get_stats(out4);
}

}  // extern "C"
