// Multi-camera synchronized frame queue — the VideoSourceMulti /
// CameraGroupSubscriber runtime (reference: src/VideoSourceMulti.cc
// boost::asio thread-pool racing camera groups; CameraGroupSubscriber's
// ApproximateTime synchronizer, include/mcptam/CameraGroupSubscriber.h).
//
// C++ core: lock-protected per-camera ring buffers fed by producer
// threads (or external callers), and an ApproximateTime-style matcher
// that releases the earliest set of frames (one per camera) whose
// timestamps span less than a sync tolerance.  Exposed to Python via a
// C ABI (ctypes) — no pybind11 dependency.
//
// Build: g++ -O2 -shared -fPIC -pthread framequeue.cc -o libframequeue.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Frame {
  double timestamp;
  std::vector<uint8_t> data;
};

struct CameraRing {
  std::deque<Frame> frames;
};

struct FrameQueue {
  int n_cams;
  size_t frame_bytes;
  double sync_tol;
  size_t max_depth;
  std::vector<CameraRing> rings;
  std::mutex mu;
  std::condition_variable cv;
  uint64_t dropped = 0;
  // dynamic sync bound from the observed framerate (reference
  // CameraGroupSubscriber sbDynamicSync: the synchronizer's
  // inter-message bound is derived from the measured rate,
  // include/mcptam/CameraGroupSubscriber.h)
  bool dynamic_sync = false;
  std::vector<double> last_ts;       // per-camera last arrival
  std::vector<double> interval_ema;  // per-camera EMA of inter-arrival

  FrameQueue(int n, size_t bytes, double tol, size_t depth)
      : n_cams(n), frame_bytes(bytes), sync_tol(tol), max_depth(depth),
        rings(n), last_ts(n, -1.0), interval_ema(n, -1.0) {}

  double effective_tol_locked() const {
    if (!dynamic_sync) return sync_tol;
    // frames of one synchronized set must lie closer than half the
    // slowest camera's frame interval, else sets can interleave
    double max_interval = -1.0;
    for (int c = 0; c < n_cams; ++c) {
      if (interval_ema[c] <= 0.0) return sync_tol;  // not yet observed
      max_interval = std::max(max_interval, interval_ema[c]);
    }
    return std::min(sync_tol, 0.5 * max_interval);
  }

  void push(int cam, double ts, const uint8_t* data) {
    std::unique_lock<std::mutex> lk(mu);
    if (last_ts[cam] >= 0.0 && ts > last_ts[cam]) {
      double dt = ts - last_ts[cam];
      if (interval_ema[cam] < 0.0) {
        interval_ema[cam] = dt;
      } else if (dt < 3.0 * interval_ema[cam]) {
        // skip larger gaps: missed frames must not widen the sync bound
        interval_ema[cam] = 0.9 * interval_ema[cam] + 0.1 * dt;
      }
    }
    last_ts[cam] = ts;
    auto& ring = rings[cam].frames;
    if (ring.size() >= max_depth) {
      ring.pop_front();
      ++dropped;
    }
    Frame f;
    f.timestamp = ts;
    f.data.assign(data, data + frame_bytes);
    ring.push_back(std::move(f));
    cv.notify_all();
  }

  // Find the earliest synchronized set: the minimal-timestamp head among
  // cameras anchors the set; every camera must hold a frame within
  // sync_tol of it (ApproximateTime-lite).  Heads older than (anchor -
  // tol) are dropped.
  bool match_locked(std::vector<Frame>* out) {
    const double tol = effective_tol_locked();
    for (;;) {
      double newest_head = -1e300;
      for (auto& r : rings) {
        if (r.frames.empty()) return false;
        newest_head = std::max(newest_head, r.frames.front().timestamp);
      }
      // drop heads that can never match the newest head
      bool dropped_any = false;
      for (auto& r : rings) {
        while (!r.frames.empty() &&
               r.frames.front().timestamp < newest_head - tol) {
          r.frames.pop_front();
          ++dropped;
          dropped_any = true;
        }
        if (r.frames.empty()) return false;
      }
      if (dropped_any) continue;
      // all heads within tol of each other -> emit
      out->clear();
      for (auto& r : rings) {
        out->push_back(std::move(r.frames.front()));
        r.frames.pop_front();
      }
      return true;
    }
  }

  // timeout_ms < 0: block forever; 0: poll.
  bool get_synced(uint8_t* out_data, double* out_ts, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu);
    std::vector<Frame> set;
    auto ready = [&] { return match_locked(&set); };
    if (!ready()) {
      if (timeout_ms == 0) return false;
      if (timeout_ms < 0) {
        cv.wait(lk, ready);
      } else {
        if (!cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready))
          return false;
      }
    }
    for (int c = 0; c < n_cams; ++c) {
      std::memcpy(out_data + c * frame_bytes, set[c].data.data(), frame_bytes);
      out_ts[c] = set[c].timestamp;
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* fq_create(int n_cams, uint64_t frame_bytes, double sync_tol,
                uint64_t max_depth) {
  return new FrameQueue(n_cams, frame_bytes, sync_tol, max_depth);
}

void fq_destroy(void* q) { delete static_cast<FrameQueue*>(q); }

void fq_push(void* q, int cam, double ts, const uint8_t* data) {
  static_cast<FrameQueue*>(q)->push(cam, ts, data);
}

// out_data: n_cams * frame_bytes buffer; out_ts: n_cams doubles.
int fq_get_synced(void* q, uint8_t* out_data, double* out_ts,
                  int timeout_ms) {
  return static_cast<FrameQueue*>(q)->get_synced(out_data, out_ts, timeout_ms)
             ? 1
             : 0;
}

uint64_t fq_dropped(void* q) { return static_cast<FrameQueue*>(q)->dropped; }

// dynamic sync bound from the observed framerate (ref sbDynamicSync)
void fq_set_dynamic(void* q, int enable) {
  auto* fq = static_cast<FrameQueue*>(q);
  std::unique_lock<std::mutex> lk(fq->mu);
  fq->dynamic_sync = enable != 0;
}

double fq_effective_tol(void* q) {
  auto* fq = static_cast<FrameQueue*>(q);
  std::unique_lock<std::mutex> lk(fq->mu);
  return fq->effective_tol_locked();
}
}
