// visfs_tpu_torch native runtime: ingest queues, approx-time synchronization
// and the pipeline worker thread (a copy of visfs_tpu/runtime/runtime.cc for
// the port, which imports nothing of visfs_tpu; the same C API).
//
// The native runtime surface of the reference: the mutex+queue pipeline
// threads of System/Tracker/Estimator (corelib/src/System.cpp:45-52,
// Tracker.cpp:53-81, Estimator.cpp:90-114) and the message_filters
// approximate-time stereo synchronizer of the ROS interface
// (Interface/ROS/src/InterfaceROS.cpp:100-117).  The compute path stays in
// PyTorch; this library owns everything around it: bounded lock-guarded
// ring buffers (condition variables, no polling), timestamp matching of
// left/right/scan streams with a configurable slop, a worker thread that
// drives a registered callback (the System's step) and an output queue,
// and drop/latency statistics.
//
// C API only (consumed via ctypes from visfs_tpu_torch/runtime/__init__.py,
// built at first use by ops/kernels/_build.py with g++); no Python.h
// dependency.  Unlike the reference's copy it includes <algorithm> and
// <cmath> itself (std::min, std::abs): g++ 13's headers no longer bring
// them in through <chrono> and <deque>.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  double stamp = 0.0;
  std::vector<float> data;
  int rows = 0;
  int cols = 0;
};

struct SyncedFrame {
  uint64_t id = 0;
  double stamp = 0.0;
  Buffer left, right, scan;  // scan rows = n points, cols = 3 (optional)
  bool has_scan = false;
  std::chrono::steady_clock::time_point enqueued;
};

struct Stats {
  std::atomic<uint64_t> pushed_left{0}, pushed_right{0}, pushed_scan{0};
  std::atomic<uint64_t> synced{0}, dropped_unmatched{0}, dropped_overflow{0};
  std::atomic<uint64_t> processed{0};
  std::atomic<double> last_latency_ms{0.0};
};

using StepCallback = void (*)(uint64_t id, double stamp, const float* left,
                              const float* right, int rows, int cols,
                              const float* scan, int scan_points,
                              void* user);

class Runtime {
 public:
  Runtime(int capacity, double slop_s, int with_scan)
      : capacity_(capacity), slop_(slop_s), with_scan_(with_scan != 0) {}

  ~Runtime() { stop(); }

  void push_left(double stamp, const float* p, int rows, int cols) {
    stats_.pushed_left++;
    push_stream(left_q_, stamp, p, rows, cols);
    try_match();
  }
  void push_right(double stamp, const float* p, int rows, int cols) {
    stats_.pushed_right++;
    push_stream(right_q_, stamp, p, rows, cols);
    try_match();
  }
  void push_scan(double stamp, const float* p, int n_points) {
    stats_.pushed_scan++;
    push_stream(scan_q_, stamp, p, n_points, 3);
    try_match();
  }

  // Pull-mode: pop one synced frame (blocking up to timeout_ms; 0 = poll).
  bool poll(SyncedFrame& out, int timeout_ms) {
    std::unique_lock<std::mutex> lk(mu_);
    if (timeout_ms > 0) {
      cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                   [&] { return !synced_q_.empty() || stopping_; });
    }
    if (synced_q_.empty()) return false;
    out = std::move(synced_q_.front());
    synced_q_.pop_front();
    return true;
  }

  // Push-mode: worker thread drains the synced queue through the callback.
  void start(StepCallback cb, void* user) {
    stop();
    stopping_ = false;
    cb_ = cb;
    user_ = user;
    worker_ = std::thread([this] { run(); });
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stopping_ = true;
    }
    cv_.notify_all();
    if (worker_.joinable()) worker_.join();
  }

  Stats& stats() { return stats_; }
  int queue_depth() {
    std::lock_guard<std::mutex> lk(mu_);
    return static_cast<int>(synced_q_.size());
  }

 private:
  void push_stream(std::deque<Buffer>& q, double stamp, const float* p,
                   int rows, int cols) {
    Buffer b;
    b.stamp = stamp;
    b.rows = rows;
    b.cols = cols;
    b.data.assign(p, p + static_cast<size_t>(rows) * cols);
    std::lock_guard<std::mutex> lk(mu_);
    q.push_back(std::move(b));
    while (static_cast<int>(q.size()) > capacity_) {
      q.pop_front();
      stats_.dropped_unmatched++;
    }
  }

  // Approximate-time policy: match the oldest left against the closest
  // right (and scan) within slop; discard older unmatched entries.
  void try_match() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      if (left_q_.empty() || right_q_.empty()) return;
      if (with_scan_ && scan_q_.empty()) return;
      const double t = left_q_.front().stamp;

      auto best = [&](std::deque<Buffer>& q) -> int {
        int bi = -1;
        double bd = slop_;
        for (size_t i = 0; i < q.size(); ++i) {
          const double d = std::abs(q[i].stamp - t);
          if (d <= bd) {
            bd = d;
            bi = static_cast<int>(i);
          }
        }
        return bi;
      };

      const int ri = best(right_q_);
      const int si = with_scan_ ? best(scan_q_) : 0;
      // No candidate within slop: if the companion stream has already moved
      // past t (its newest stamp exceeds t + slop, and stamps arrive in
      // order), this left can never match — drop it.  Otherwise wait.
      if (ri < 0) {
        if (!right_q_.empty() && right_q_.back().stamp > t + slop_) {
          left_q_.pop_front();
          stats_.dropped_unmatched++;
          continue;
        }
        return;
      }
      if (with_scan_ && si < 0) {
        if (!scan_q_.empty() && scan_q_.back().stamp > t + slop_) {
          left_q_.pop_front();
          stats_.dropped_unmatched++;
          continue;
        }
        return;
      }

      SyncedFrame f;
      f.id = next_id_++;
      f.stamp = t;
      f.left = std::move(left_q_.front());
      left_q_.pop_front();
      f.right = std::move(right_q_[ri]);
      right_q_.erase(right_q_.begin() + ri);
      // drop older rights (they can never match a future, newer left)
      while (!right_q_.empty() && right_q_.front().stamp < t - slop_) {
        right_q_.pop_front();
        stats_.dropped_unmatched++;
      }
      if (with_scan_) {
        f.scan = std::move(scan_q_[si]);
        scan_q_.erase(scan_q_.begin() + si);
        f.has_scan = true;
        while (!scan_q_.empty() && scan_q_.front().stamp < t - slop_) {
          scan_q_.pop_front();
          stats_.dropped_unmatched++;
        }
      }
      f.enqueued = std::chrono::steady_clock::now();
      synced_q_.push_back(std::move(f));
      stats_.synced++;
      while (static_cast<int>(synced_q_.size()) > capacity_) {
        synced_q_.pop_front();
        stats_.dropped_overflow++;
      }
      lk.unlock();
      cv_.notify_one();
      lk.lock();
    }
  }

  void run() {
    for (;;) {
      SyncedFrame f;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stopping_ || !synced_q_.empty(); });
        if (stopping_ && synced_q_.empty()) return;
        f = std::move(synced_q_.front());
        synced_q_.pop_front();
      }
      const auto t0 = std::chrono::steady_clock::now();
      cb_(f.id, f.stamp, f.left.data.data(), f.right.data.data(),
          f.left.rows, f.left.cols,
          f.has_scan ? f.scan.data.data() : nullptr,
          f.has_scan ? f.scan.rows : 0, user_);
      const auto t1 = std::chrono::steady_clock::now();
      stats_.processed++;
      stats_.last_latency_ms =
          std::chrono::duration<double, std::milli>(t1 - f.enqueued).count();
      (void)t0;
    }
  }

  const int capacity_;
  const double slop_;
  const bool with_scan_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Buffer> left_q_, right_q_, scan_q_;
  std::deque<SyncedFrame> synced_q_;
  uint64_t next_id_ = 0;
  bool stopping_ = false;
  std::thread worker_;
  StepCallback cb_ = nullptr;
  void* user_ = nullptr;
  Stats stats_;
};

}  // namespace

extern "C" {

void* visfs_rt_create(int capacity, double slop_s, int with_scan) {
  return new Runtime(capacity, slop_s, with_scan);
}

void visfs_rt_destroy(void* h) { delete static_cast<Runtime*>(h); }

void visfs_rt_push_left(void* h, double stamp, const float* p, int rows,
                        int cols) {
  static_cast<Runtime*>(h)->push_left(stamp, p, rows, cols);
}

void visfs_rt_push_right(void* h, double stamp, const float* p, int rows,
                         int cols) {
  static_cast<Runtime*>(h)->push_right(stamp, p, rows, cols);
}

void visfs_rt_push_scan(void* h, double stamp, const float* p, int n_points) {
  static_cast<Runtime*>(h)->push_scan(stamp, p, n_points);
}

// Poll one synced frame into caller-provided buffers.  Returns 1 on success.
// left/right must hold rows*cols floats; scan (may be null) holds
// max_scan_points*3.  Outputs actual scan point count via out_scan_points.
int visfs_rt_poll(void* h, int timeout_ms, double* out_stamp,
                  uint64_t* out_id, float* left, float* right, int rows,
                  int cols, float* scan, int max_scan_points,
                  int* out_scan_points) {
  SyncedFrame f;
  if (!static_cast<Runtime*>(h)->poll(f, timeout_ms)) return 0;
  if (f.left.rows != rows || f.left.cols != cols) return -1;
  *out_stamp = f.stamp;
  *out_id = f.id;
  std::memcpy(left, f.left.data.data(), sizeof(float) * rows * cols);
  std::memcpy(right, f.right.data.data(), sizeof(float) * rows * cols);
  int n = 0;
  if (f.has_scan && scan != nullptr) {
    n = std::min(f.scan.rows, max_scan_points);
    std::memcpy(scan, f.scan.data.data(), sizeof(float) * n * 3);
  }
  *out_scan_points = n;
  return 1;
}

void visfs_rt_start(void* h, StepCallback cb, void* user) {
  static_cast<Runtime*>(h)->start(cb, user);
}

void visfs_rt_stop(void* h) { static_cast<Runtime*>(h)->stop(); }

int visfs_rt_queue_depth(void* h) {
  return static_cast<Runtime*>(h)->queue_depth();
}

void visfs_rt_stats(void* h, uint64_t* out8) {
  auto& s = static_cast<Runtime*>(h)->stats();
  out8[0] = s.pushed_left.load();
  out8[1] = s.pushed_right.load();
  out8[2] = s.pushed_scan.load();
  out8[3] = s.synced.load();
  out8[4] = s.dropped_unmatched.load();
  out8[5] = s.dropped_overflow.load();
  out8[6] = s.processed.load();
  out8[7] = static_cast<uint64_t>(s.last_latency_ms.load() * 1000.0);
}

}  // extern "C"
