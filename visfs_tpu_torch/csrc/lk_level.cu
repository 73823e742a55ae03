// Pyramidal Lucas-Kanade for N features, for Hopper (sm_90a): one LK level
// per launch (visfs_lk_level), or a whole pyramidal track -- every level,
// optionally both directions and the forward-backward gate -- per launch
// (visfs_lk_pyr).  Both entries run one kernel body, track_level().
//
// Replaces the Pallas TPU kernel visfs_tpu/ops/pallas/lk_kernel.py
// lk_level_pallas (body _lk_level_kernel, patch sampling _bilinear_patch)
// and, in visfs_lk_pyr, the per-feature glue around it in
// visfs_tpu/ops/lk.py lk_track_pyr / lk_track_bidirectional_pyr at
// backend="pallas".  track_level() computes exactly the level's semantics:
//   * bilinear win x win patches of I (from), gx and gy at pt; the
//     fractional weights come from the UNCLIPPED corner pt - win/2, only
//     the integer corner is clipped to [0, W - win - 2] x [0, H - win - 2];
//   * G = sum [gx^2, gx gy; gx gy, gy^2], min_eig = smaller eigenvalue / area,
//     ok = (min_eig > threshold) & (det > 1e-12);
//   * up to `iterations` steps: sample J (to) at pt + flow,
//     b = sum (I - J) g, step = G^-1 b, flow += step, stop once
//     |step|^2 < eps^2 (that last sub-eps step is kept);
//   * a feature that is inactive or not ok returns flow_in; ok and min_eig
//     are written for every feature.
// There is no region clamp around the starting position (that belongs to
// the reference's jnp "direct" formulation, not to this kernel).
// visfs_lk_pyr adds, per feature: flow = (pts_init - pts_from) / 2^L; per
// level pts_l = pts_from / 2^level + pad, active = valid & ok so far,
// flow *= 2 between levels; points = pts_from + flow, err = the level-0
// min_eig, status = ok & valid & inside [half, size - half); and, when
// bidirectional, the reverse track from the forward points (seeded at
// pts_from, valid = forward status) and the gate |rev - pts_from| <= fb.
// Those glue operations use the _rn intrinsics, so nvcc contracts none of
// them into a fused multiply-add and their bits equal the plain PyTorch
// version's (a contraction could flip a status bit at the gates).
//
// What bounds it: a chain of dependent Gauss-Newton steps per feature (up
// to `iterations` per level, 4 levels, 2 directions), each a gather of the
// `to` patch, a block reduction and a 2x2 solve.  The bytes are ~1 MB per
// call and the arithmetic ~10 MFLOP, microseconds on this card; latency
// sets the time.  The design against it:
//   * a block of 128 threads per feature (120-240 blocks on 132 SMs), <= 4
//     samples of the 441 per thread at win 21; the from, gx and gy samples
//     stay in registers for the level; G and b are reduced with shuffles
//     and then across the 4 warps through shared memory, every thread
//     summing the 4 partials in one order, so the step, the eps test and
//     the loop exit are block-uniform;
//   * the `to` neighbourhood, a (win + 1 + 2 * kMargin)^2 tile around the
//     first corner, is copied into shared memory with cp.async while the
//     setup samples are read; a step whose clipped corner leaves the tile
//     re-stages it around the new corner (a block-uniform decision), so no
//     step reads `to` from L2 tap by tap;
//   * levels and directions run in the block's own loop: one launch per
//     pyramidal track instead of one per level and direction.
//   * a fleet's streams are the grid's y axis (blockIdx.y): one launch
//     tracks the features of every stream, B * n blocks, each the single
//     track's block on its stream's planes (bit-equal to B launches).
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): at win <= 22 the one-level kernel
// uses 72 registers and the pyramid kernel 80 (72 before the stream axis),
// with an 8-byte stack frame (8 bytes of spill stores, 4 of loads), both
// 5,028 bytes of shared memory; at win <= 32, 92 and 120 registers (96
// before) and 8,228 bytes.  chip_smoke.py prints it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMargin = 6;     // tile margin (px) around the first corner
constexpr int kMaxLevels = 5;  // pyramid levels a visfs_lk_pyr call takes
constexpr unsigned kFullMask = 0xffffffffu;

// Integer corner (clipped) and bilinear weights (from the unclipped corner)
// of the patch centred at (cx, cy), as in _bilinear_patch.
struct Corner {
  int ix, iy;
  float w00, w10, w01, w11;
};

__device__ __forceinline__ Corner make_corner(float cx, float cy, int half,
                                              int max_ix, int max_iy) {
  const float x0 = cx - static_cast<float>(half);
  const float y0 = cy - static_cast<float>(half);
  const float flx = floorf(x0);
  const float fly = floorf(y0);
  const float fx = x0 - flx;
  const float fy = y0 - fly;
  Corner c;
  c.ix = min(max(static_cast<int>(flx), 0), max_ix);
  c.iy = min(max(static_cast<int>(fly), 0), max_iy);
  c.w00 = (1.0f - fx) * (1.0f - fy);
  c.w10 = fx * (1.0f - fy);
  c.w01 = (1.0f - fx) * fy;
  c.w11 = fx * fy;
  return c;
}

// The 4-tap blend of the taps at (0,0), (1,0), (0,1), (1,1) from c's
// corner, summed in _bilinear_patch's order.
__device__ __forceinline__ float blend(const Corner& c, float p00, float p10,
                                       float p01, float p11) {
  return c.w00 * p00 + c.w10 * p10 + c.w01 * p01 + c.w11 * p11;
}

__device__ __forceinline__ float sample_global(const float* __restrict__ img,
                                               int w, const Corner& c, int r,
                                               int col) {
  const float* p = img + static_cast<size_t>(c.iy + r) * w + (c.ix + col);
  return blend(c, __ldg(p), __ldg(p + 1), __ldg(p + w), __ldg(p + w + 1));
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The four planes of one level in one direction, [h, w] each.
struct Planes {
  const float* from;
  const float* to;
  const float* gx;
  const float* gy;
  int h, w;
};

// The shared memory of a block: the `to` tile and the reduction slots
// (two sets, used in turn, so one __syncthreads per reduction suffices).
template <int TMAX>
struct Smem {
  float tile[TMAX * TMAX];
  float red[2][kWarps][4];
};

// Sum v[0..K) over the block; every thread gets the same bits.
template <int K, int TMAX>
__device__ __forceinline__ void block_sum(float (&v)[K], Smem<TMAX>& sm,
                                          int& par) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      v[k] += __shfl_xor_sync(kFullMask, v[k], m);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) sm.red[par][warp][k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = sm.red[par][0][k];
#pragma unroll
    for (int j = 1; j < kWarps; ++j) s += sm.red[par][j][k];
    v[k] = s;
  }
  par ^= 1;
}

// Where the `to` tile lies in its plane: corner (x, y), size tw x th.
struct Tile {
  int x, y, tw, th;
};

// Place the tile around corner c (clamped into the plane) and start the
// asynchronous copy of it into shared memory.  A tile so placed always
// holds the (win+1)^2 taps of c.
template <int TMAX>
__device__ __forceinline__ void stage(const Planes& pl, const Corner& c,
                                      Tile& t, Smem<TMAX>& sm) {
  t.x = min(max(c.ix - kMargin, 0), pl.w - t.tw);
  t.y = min(max(c.iy - kMargin, 0), pl.h - t.th);
  const int count = t.tw * t.th;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int r = k / t.tw;
    const int col = k - r * t.tw;
    cp_async_f32(sm.tile + k,
                 pl.to + static_cast<size_t>(t.y + r) * pl.w + (t.x + col));
  }
}

__device__ __forceinline__ bool holds(const Tile& t, const Corner& c,
                                      int win) {
  return c.ix >= t.x && c.iy >= t.y && c.ix + win < t.x + t.tw &&
         c.iy + win < t.y + t.th;
}

struct LevelResult {
  float fx, fy, min_eig;
  bool ok;
};

// One LK level for one feature on the whole block (see the file header).
// Every argument and the result are block-uniform.
template <int MAXS, int TMAX>
__device__ LevelResult track_level(const Planes& pl, float px, float py,
                                   float fx0, float fy0, bool active, int win,
                                   int iterations, float eps_sq,
                                   float min_eig_threshold, Smem<TMAX>& sm,
                                   int& par) {
  const int tid = threadIdx.x;
  const int half = win / 2;
  const int area = win * win;
  const int max_ix = pl.w - win - 2;
  const int max_iy = pl.h - win - 2;
  const int side = win + 1 + 2 * kMargin;
  Tile t;
  t.tw = min(side, pl.w);
  t.th = min(side, pl.h);

  // The first step's tile is copied while the setup samples are read.
  Corner cj = make_corner(px + fx0, py + fy0, half, max_ix, max_iy);
  if (active) stage(pl, cj, t, sm);

  // Setup: this thread's samples of I, gx, gy, their tile offsets, and its
  // share of G.
  const Corner c0 = make_corner(px, py, half, max_ix, max_iy);
  float vi[MAXS], vx[MAXS], vy[MAXS];
  int off[MAXS];
  float g[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    const int k = tid + kThreads * s;
    vi[s] = vx[s] = vy[s] = 0.f;
    off[s] = 0;
    if (k < area) {
      const int r = k / win;
      const int col = k - r * win;
      vi[s] = sample_global(pl.from, pl.w, c0, r, col);
      vx[s] = sample_global(pl.gx, pl.w, c0, r, col);
      vy[s] = sample_global(pl.gy, pl.w, c0, r, col);
      off[s] = r * t.tw + col;
      g[0] += vx[s] * vx[s];
      g[1] += vx[s] * vy[s];
      g[2] += vy[s] * vy[s];
    }
  }
  cp_async_wait_all();
  block_sum(g, sm, par);  // its barrier also publishes the tile

  const float det = g[0] * g[2] - g[1] * g[1];
  const float trace = g[0] + g[2];
  const float min_eig =
      (trace - sqrtf(fmaxf(trace * trace - 4.0f * det, 0.0f))) * 0.5f /
      static_cast<float>(area);
  const bool ok_g = (min_eig > min_eig_threshold) && (det > 1e-12f);
  const float inv_det = 1.0f / (det > 1e-12f ? det : 1.0f);
  const float gi11 = g[2] * inv_det;
  const float gi12 = -g[1] * inv_det;
  const float gi22 = g[0] * inv_det;

  float fx = fx0, fy = fy0;
  bool run = active && ok_g;
  for (int it = 0; it < iterations && run; ++it) {
    if (it > 0) {
      cj = make_corner(px + fx, py + fy, half, max_ix, max_iy);
      if (!holds(t, cj, win)) {
        // every thread finished reading the old tile before the last
        // reduction's barrier
        stage(pl, cj, t, sm);
        cp_async_wait_all();
        __syncthreads();
      }
    }
    const float* base = sm.tile + (cj.iy - t.y) * t.tw + (cj.ix - t.x);
    float b[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s < MAXS; ++s) {
      if (tid + kThreads * s < area) {
        const float* p = base + off[s];
        const float diff =
            vi[s] - blend(cj, p[0], p[1], p[t.tw], p[t.tw + 1]);
        b[0] += diff * vx[s];
        b[1] += diff * vy[s];
      }
    }
    block_sum(b, sm, par);
    const float dx = gi11 * b[0] + gi12 * b[1];
    const float dy = gi12 * b[0] + gi22 * b[1];
    fx += dx;
    fy += dy;
    run = (dx * dx + dy * dy) >= eps_sq;
  }
  // an inactive or not-ok feature never stepped: fx, fy are flow_in
  return LevelResult{fx, fy, min_eig, ok_g};
}

template <int MAXS, int TMAX>
__global__ void __launch_bounds__(kThreads)
lk_level_kernel(Planes pl, const float* __restrict__ pts,
                const float* __restrict__ flow_in,
                const float* __restrict__ active, float* __restrict__ flow_out,
                float* __restrict__ ok_out, float* __restrict__ eig_out,
                int win, int iterations, float eps_sq,
                float min_eig_threshold) {
  __shared__ Smem<TMAX> sm;
  const int i = blockIdx.x;
  int par = 0;
  const LevelResult r = track_level<MAXS, TMAX>(
      pl, pts[2 * i], pts[2 * i + 1], flow_in[2 * i], flow_in[2 * i + 1],
      active[i] > 0.f, win, iterations, eps_sq, min_eig_threshold, sm, par);
  if (threadIdx.x == 0) {
    flow_out[2 * i] = r.fx;
    flow_out[2 * i + 1] = r.fy;
    ok_out[i] = r.ok ? 1.0f : 0.0f;
    eig_out[i] = r.min_eig;
  }
}

// Per level: the planes of pyramids A and B in the order
// A, B, gx(A), gy(A), gx(B), gy(B), and the level's [h, w].  Passed by
// value as a kernel parameter (no device-side table).  With a stream axis
// each pointer is stream 0's plane of a [n_streams, h, w] block and
// `stride` the distance to the next stream's (h * w when contiguous).
struct PyrPlanes {
  const float* p[kMaxLevels][6];
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long stride[kMaxLevels];  // floats from one stream's plane to the next
};

struct PyrConfig {
  int top;       // the coarsest level, max_level
  int h0, w0;    // unpadded level-0 size, for the in-bounds test
  float pad;     // the planes' border padding
  int win, iterations;
  float eps_sq, min_eig_threshold;
};

struct TrackResult {
  float x, y, err;
  bool status;
};

// lk_track_pyr for one feature: from pyramid A into B, or (reverse) from B
// into A.  The glue's float operations round as PyTorch's do.
template <int MAXS, int TMAX>
__device__ TrackResult track_pyr(const PyrPlanes& pp, const PyrConfig& cfg,
                                 int stream, bool reverse, float x, float y,
                                 float init_x, float init_y, bool valid, Smem<TMAX>& sm,
                                 int& par) {
  const int a = reverse ? 1 : 0;
  const int gxi = reverse ? 4 : 2;
  const float top_scale = static_cast<float>(1 << cfg.top);
  float fx = __fdiv_rn(__fsub_rn(init_x, x), top_scale);
  float fy = __fdiv_rn(__fsub_rn(init_y, y), top_scale);
  bool ok = valid;
  float min_eig = 0.f;
  for (int level = cfg.top; level >= 0; --level) {
    const float scale = static_cast<float>(1 << level);
    const long long off = stream * pp.stride[level];
    const Planes pl{pp.p[level][a] + off,   pp.p[level][1 - a] + off,
                    pp.p[level][gxi] + off, pp.p[level][gxi + 1] + off,
                    pp.h[level],            pp.w[level]};
    const LevelResult r = track_level<MAXS, TMAX>(
        pl, __fadd_rn(__fdiv_rn(x, scale), cfg.pad),
        __fadd_rn(__fdiv_rn(y, scale), cfg.pad), fx, fy, ok, cfg.win,
        cfg.iterations, cfg.eps_sq, cfg.min_eig_threshold, sm, par);
    fx = r.fx;
    fy = r.fy;
    min_eig = r.min_eig;
    ok = ok && r.ok;
    if (level > 0) {
      fx = __fmul_rn(fx, 2.0f);
      fy = __fmul_rn(fy, 2.0f);
    }
  }
  const float tx = __fadd_rn(x, fx);
  const float ty = __fadd_rn(y, fy);
  const float half = static_cast<float>(cfg.win / 2);
  const bool inb = tx >= half && tx < static_cast<float>(cfg.w0) - half &&
                   ty >= half && ty < static_cast<float>(cfg.h0) - half;
  return TrackResult{tx, ty, min_eig, ok && inb && valid};
}

template <int MAXS, int TMAX>
__global__ void __launch_bounds__(kThreads)
lk_pyr_kernel(PyrPlanes pp, PyrConfig cfg, const float* __restrict__ pts_from,
              const float* __restrict__ pts_init,
              const unsigned char* __restrict__ valid,
              float* __restrict__ points_out,
              unsigned char* __restrict__ status_out,
              float* __restrict__ err_out, int bidirectional,
              float fb_threshold, int pts_stride) {
  __shared__ Smem<TMAX> sm;
  // blockIdx.y is the stream; i indexes its features in the
  // [n_streams, pts_stride] point, valid and output arrays.
  const int stream = blockIdx.y;
  const long long i =
      static_cast<long long>(stream) * pts_stride + blockIdx.x;
  int par = 0;
  const float x = pts_from[2 * i];
  const float y = pts_from[2 * i + 1];
  const TrackResult fwd =
      track_pyr<MAXS, TMAX>(pp, cfg, stream, false, x, y, pts_init[2 * i],
                            pts_init[2 * i + 1], valid[i] != 0, sm, par);
  bool status = fwd.status;
  // A feature the forward track lost keeps status false whatever its
  // reverse track gives, so only tracked features run it.
  if (bidirectional && status) {
    const TrackResult rev = track_pyr<MAXS, TMAX>(
        pp, cfg, stream, true, fwd.x, fwd.y, x, y, true, sm, par);
    const float dx = __fsub_rn(rev.x, x);
    const float dy = __fsub_rn(rev.y, y);
    const float dist =
        __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    status = rev.status && dist <= fb_threshold;
  }
  if (threadIdx.x == 0) {
    points_out[2 * i] = fwd.x;
    points_out[2 * i + 1] = fwd.y;
    status_out[i] = status ? 1 : 0;
    err_out[i] = fwd.err;
  }
}

// Samples per thread and tile side for a window: win <= 22 takes <= 4
// samples of the patch per thread, win <= 32 at most 8.
constexpr int kSmallWin = 22;
constexpr int kLargeWin = 32;
constexpr int tile_side(int win) { return win + 1 + 2 * kMargin; }

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Every pointer is a
// contiguous float32 device buffer: planes [h, w], pts/flow [n, 2],
// active/ok/eig [n].  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a window or plane the kernel does not take.
extern "C" int visfs_lk_level(const float* img_from, const float* img_to,
                              const float* grad_x, const float* grad_y,
                              const float* pts, const float* flow_in,
                              const float* active, float* flow_out,
                              float* ok_out, float* eig_out, int n, int h,
                              int w, int win, int iterations, float eps_sq,
                              float min_eig_threshold, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (win < 1 || win > kLargeWin || h < win + 2 || w < win + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes pl{img_from, img_to, grad_x, grad_y, h, w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win <= kSmallWin) {
    lk_level_kernel<4, tile_side(kSmallWin)><<<n, kThreads, 0, s>>>(
        pl, pts, flow_in, active, flow_out, ok_out, eig_out, win, iterations,
        eps_sq, min_eig_threshold);
  } else {
    lk_level_kernel<8, tile_side(kLargeWin)><<<n, kThreads, 0, s>>>(
        pl, pts, flow_in, active, flow_out, ok_out, eig_out, win, iterations,
        eps_sq, min_eig_threshold);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of a whole pyramidal track (levels `levels - 1` .. 0), forward
// only or bidirectional.  `planes` is a HOST array of levels * 6 device
// pointers, per level A, B, gx(A), gy(A), gx(B), gy(B) (the last two may be
// null when not bidirectional); `shapes` a host array of levels * 2 ints,
// per level h, w.  pts_from/pts_init/points [n, 2] float32, valid/status
// [n] bool (one byte), err [n] float32, all on the device.
// The stream axis: n_streams tracks of the same shapes in one launch, grid
// (n, n_streams).  Each plane pointer is then stream 0's plane and
// `strides` a host array of `levels` plane strides (floats) to the next
// stream's; the point, valid and output arrays are [n_streams, pts_stride]
// rows of n features.  n_streams = 1 is the single track (strides and
// pts_stride unread).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int visfs_lk_pyr(const float* const* planes, const int* shapes,
                            int levels, int n_streams,
                            const long long* strides, int pts_stride,
                            const float* pts_from, const float* pts_init, const unsigned char* valid,
                            float* points_out, unsigned char* status_out,
                            float* err_out, int n, int h0, int w0, int pad,
                            int win, int iterations, float eps_sq,
                            float min_eig_threshold, int bidirectional,
                            float fb_threshold, void* stream) {
  if (n <= 0 || n_streams <= 0) return static_cast<int>(cudaSuccess);
  if (n_streams > 65535 || (n_streams > 1 && pts_stride < n) ||
      levels < 1 || levels > kMaxLevels || win < 1 || win > kLargeWin)
    return static_cast<int>(cudaErrorInvalidValue);
  PyrPlanes pp = {};
  for (int l = 0; l < levels; ++l) {
    pp.h[l] = shapes[2 * l];
    pp.w[l] = shapes[2 * l + 1];
    pp.stride[l] = n_streams > 1 ? strides[l] : 0;
    if (n_streams > 1 &&
        pp.stride[l] < static_cast<long long>(pp.h[l]) * pp.w[l])
      return static_cast<int>(cudaErrorInvalidValue);
    if (pp.h[l] < win + 2 || pp.w[l] < win + 2)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < 6; ++k) {
      pp.p[l][k] = planes[6 * l + k];
      if (pp.p[l][k] == nullptr && (k < 4 || bidirectional))
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const PyrConfig cfg{levels - 1,
                      h0,
                      w0,
                      static_cast<float>(pad),
                      win,
                      iterations,
                      eps_sq,
                      min_eig_threshold};
  const dim3 grid(n, n_streams);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (win <= kSmallWin) {
    lk_pyr_kernel<4, tile_side(kSmallWin)><<<grid, kThreads, 0, s>>>(
        pp, cfg, pts_from, pts_init, valid, points_out, status_out, err_out,
        bidirectional, fb_threshold, pts_stride);
  } else {
    lk_pyr_kernel<8, tile_side(kLargeWin)><<<grid, kThreads, 0, s>>>(
        pp, cfg, pts_from, pts_init, valid, points_out, status_out, err_out,
        bidirectional, fb_threshold, pts_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
