// The LK iteration loop in correlation form, for Hopper (sm_90a): one level
// of N features per launch (visfs_lk_xcorr), or a whole pyramidal track in
// correlation form -- every level's setup, correlation maps and loop, the
// per-feature glue, and optionally the reverse track and the
// forward-backward gate -- per launch (visfs_lk_xcorr_pyr).  Both entries
// run one loop function, xcorr_loop().
//
// Replaces the Pallas TPU kernel visfs_tpu/ops/pallas/lk_xcorr.py
// lk_xcorr_iterate (body _kernel) and computes its semantics:
//   * per feature, two correlation maps C1, C2 of shape [A, A] (row a = y
//     shift, column b = x shift) and the scalars c1, c2, G^-1 = (gi11,
//     gi12; gi12, gi22), base_x, base_y;
//   * up to `iterations` steps: off = clip(base + flow, 0, max_off),
//     b = c - <C, w> with the bilinear tent weights w at (offy, offx),
//     step = G^-1 b, flow += step, stop once |step|^2 < eps^2 (that last
//     sub-eps step is kept);
//   * a feature inactive at entry returns flow_in.
// The tent weights over the A x A map are nonzero at no more than the 2 x 2
// taps (floor(offy) + {0, 1}, floor(offx) + {0, 1}), so the lookup reads
// those four taps (a tap at index A is skipped: its weight is 0).  Only the
// order of summation differs from the full 484-term dot of the TPU kernel,
// which is a VPU layout choice.  The TPU kernel's whole-loop exit once no
// feature is active changes no result; each feature here runs its own loop.
//
// visfs_lk_xcorr_pyr also fuses, per feature, what the reference builds
// around that kernel in jnp (visfs_tpu/ops/lk.py _track_level with
// iter_mode="xcorr", _xcorr_maps, _iterate_xcorr, lk_track_pyr,
// lk_track_bidirectional_pyr), as the port's plain version computes it
// (ops/kernels/jnp_level.py level_setup, xcorr_inputs;
// ops/kernels/pyramid.py track_pyramid, track_bidirectional).  Per level:
//   * setup: x0 = clip(px - half, 0, w - win - 1) (and y0); the integer
//     corner of a (win + 2)^2 region clip(floor(x0), 0, w - win - 2); the
//     win x win patches of from, gx, gy with tent weights max(0, 1 -
//     |r - (off + p)|), rows then columns; G, min_eig = (tr - sqrt(max(tr^2
//     - 4 det, 0))) / 2 / area, ok = min_eig > threshold & det > 1e-12,
//     G^-1 by 1 / det; c1 = sum patch * gx, c2 = sum patch * gy;
//   * the `to` region, R = win + 1 + 2 * 10, corner clip(floor(px + fx) -
//     half - 10, 0, w - R); taps outside the plane read 0;
//   * the maps C[a, b] = sum_pq region[a + p, b + q] g[p, q] for g = gx,
//     gy (A = R - win + 1 = 22), built only where the loop runs (active &
//     ok), then the loop above with base = pts - half - corner and max_off =
//     R - win - 1.
// The glue: flow = (pts_init - pts_from) / 2^L; per level pts_l = pts_from
// / 2^level + pad, active = valid & ok so far, flow *= 2 between levels;
// points = pts_from + flow, err = the level-0 min_eig, status = ok & valid
// & inside [half, size - half); and, when bidirectional, the reverse track
// from the forward points (seeded at pts_from, valid = forward status, run
// only for the features the forward track kept) and the gate |rev -
// pts_from| <= fb.  The glue, the setup's clips and the offsets use the _rn
// intrinsics, so nvcc contracts none of them into a fused multiply-add and
// their bits equal the plain PyTorch version's (a contraction could move a
// corner or flip a status bit).
//
// The one-level entry's shape on the card: one warp per feature, 4
// features per 128-thread block.  The warp copies its feature's C1 and C2
// (2 x A*A f32, 3.9 KB at A = 22) into shared memory with 16-byte loads,
// then every lane runs the same dependent chain of <= `iterations` steps
// from shared memory (broadcast reads) with the scalars in registers, so
// the loop exit is warp-uniform; lane 0 writes the flow.  What bounds it:
// the map taps and scalars are a few KB; latency (a serial chain of
// shared-memory reads and FMAs per feature) sets the time.
//
// The pyramid entry's bound is small: the function needs only the map
// entries its steps look up (<= 4 taps of each map a step, a 441-term dot
// each; ~1 % of the entries of the whole maps on the bench pair), the
// setup (~31 FLOPs per sample, 441 samples a feature-level) and the pixels
// under both: a few MB and a few tens of MFLOP at N = 240, so about a
// microsecond, set by the bytes (chip_smoke.py counts both from the run's
// data).  This design builds the whole maps instead: 2 x 22^2 x win^2
// FMAs per running feature-level (426,888 at win 21), ~1.6 GFLOP at
// N = 240 over 8 feature-levels, ~25 us at 67 TFLOP/s fp32, most of it
// entries no step reads.  The whole-map build has no dependence on the
// loop and spreads over the block, where the taps a step needs are known
// only one step at a time; computing just those, on the block, per step, is
// the alternative to weigh.  The design:
//   * a block of 128 threads per feature; the `to` region (R^2 f32, 7 KB
//     at win 21) is copied into shared memory with cp.async, zero-filling
//     the taps outside the plane (src-size 0), while the setup samples are
//     read from L2 and G, c1, c2 are reduced (shuffles, then the 4 warps'
//     partials in one order, so every thread holds the same bits);
//   * the gx, gy patches go to shared memory as (gx, gy) pairs; the maps
//     are built on the CUDA cores in fp32: each of 88 threads owns a strip
//     of 6 adjacent outputs b of one row a, for both maps, accumulates 12
//     sums in registers, and per p slides a 6-tap window along the region
//     row (one shared-memory read per q, reused by 12 FMAs; the (gx, gy)
//     pair is a broadcast read).  Not the tensor cores: TF32 keeps 10
//     mantissa bits, each entry sums 441 terms of up to ~1e6, and b = c -
//     <C, w> cancels down to the residual near convergence;
//   * warp 0 runs the loop (xcorr_loop, as the one-level entry does) from
//     the maps in shared memory and hands the flow to the block through
//     shared memory; levels and directions run in the block's own loop:
//     one launch per pyramidal track instead of one per level and
//     direction, and no host dispatch for the setup and the maps.
//   * a fleet's streams are the grid's y axis, as in lk_level.cu: one
//     launch for every stream's track, bit-equal to one launch a stream.
// The setup and the maps take 92-98 % of a launch (chip_smoke.py's probe
// with eps = 1e9, one step a running level): the map stage runs on 3 warps,
// one per SM sub-partition, as a stream of shared-memory reads and FMAs.
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): the pyramid kernel 56 registers
// (64 before the stream axis), 23,488 bytes of shared memory, an 8-byte
// stack frame (8 bytes of spill stores, 8 of loads); the one-level kernel 48
// registers, a 24-byte stack frame (20 bytes of spill stores, 52 of loads).
// chip_smoke.py prints it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float lookup(const float* m, int a_size, int ia,
                                        int ib, float wy0, float wy1,
                                        float wx0, float wx1, bool ra,
                                        bool rb) {
  const float* p = m + ia * a_size + ib;
  float top = wx0 * p[0];
  if (rb) top += wx1 * p[1];
  float v = wy0 * top;
  if (ra) {
    float bot = wx0 * p[a_size];
    if (rb) bot += wx1 * p[a_size + 1];
    v += wy1 * bot;
  }
  return v;
}

// The scalars of one feature's loop.
struct XcorrScalars {
  float cc1, cc2, gi11, gi12, gi22, bx, by;
};

// The LK loop in correlation form for one feature, from its maps m1, m2
// [a_size, a_size] in shared memory (see the file header); (fx, fy) enter
// as flow_in and leave as the flow.  Every caller runs it on a whole warp,
// all lanes alike, so the exit is warp-uniform.
__device__ __forceinline__ void xcorr_loop(const float* m1, const float* m2,
                                           int a_size, const XcorrScalars& s,
                                           float& fx, float& fy,
                                           int iterations, float eps_sq,
                                           float max_off) {
  bool run = true;
  for (int it = 0; it < iterations && run; ++it) {
    const float offx = fminf(fmaxf(s.bx + fx, 0.0f), max_off);
    const float offy = fminf(fmaxf(s.by + fy, 0.0f), max_off);
    const float fa = floorf(offy);
    const float fb = floorf(offx);
    const int ia = static_cast<int>(fa);
    const int ib = static_cast<int>(fb);
    const float wy1 = offy - fa, wy0 = 1.0f - wy1;
    const float wx1 = offx - fb, wx0 = 1.0f - wx1;
    const bool ra = ia + 1 < a_size;
    const bool rb = ib + 1 < a_size;
    const float b1 =
        s.cc1 - lookup(m1, a_size, ia, ib, wy0, wy1, wx0, wx1, ra, rb);
    const float b2 =
        s.cc2 - lookup(m2, a_size, ia, ib, wy0, wy1, wx0, wx1, ra, rb);
    const float dx = s.gi11 * b1 + s.gi12 * b2;
    const float dy = s.gi12 * b1 + s.gi22 * b2;
    fx += dx;
    fy += dy;
    run = (dx * dx + dy * dy) >= eps_sq;
  }
}

// --- the one-level entry ----------------------------------------------------

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lk_xcorr_kernel(const float* __restrict__ c1, const float* __restrict__ c2,
                const float* __restrict__ c1_const,
                const float* __restrict__ c2_const,
                const float* __restrict__ gi11_in,
                const float* __restrict__ gi12_in,
                const float* __restrict__ gi22_in,
                const float* __restrict__ base_x,
                const float* __restrict__ base_y,
                const float* __restrict__ flow_in,
                const unsigned char* __restrict__ active,
                float* __restrict__ flow_out, int n, int a_size,
                int iterations, float eps_sq, float max_off) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n) return;  // warp-uniform: the whole warp leaves together

  const int area = a_size * a_size;  // a multiple of 4 (checked at launch)
  float* m1 = smem + warp * 2 * area;
  float* m2 = m1 + area;
  const float4* g1 =
      reinterpret_cast<const float4*>(c1 + static_cast<size_t>(i) * area);
  const float4* g2 =
      reinterpret_cast<const float4*>(c2 + static_cast<size_t>(i) * area);
  for (int k = lane; k < area / 4; k += 32) {
    reinterpret_cast<float4*>(m1)[k] = __ldg(g1 + k);
    reinterpret_cast<float4*>(m2)[k] = __ldg(g2 + k);
  }
  __syncwarp();

  float fx = flow_in[2 * i];
  float fy = flow_in[2 * i + 1];
  if (active[i]) {
    const XcorrScalars s{c1_const[i], c2_const[i], gi11_in[i], gi12_in[i],
                         gi22_in[i],  base_x[i],   base_y[i]};
    xcorr_loop(m1, m2, a_size, s, fx, fy, iterations, eps_sq, max_off);
  }
  if (lane == 0) {
    flow_out[2 * i] = fx;
    flow_out[2 * i + 1] = fy;
  }
}

// --- the pyramid entry ------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMargin = 10;  // the search margin, jnp_level.py MARGIN
constexpr int kMaxWin = 32;
constexpr int kMaxLevels = 5;
constexpr int kA = 2 * kMargin + 2;  // map side A = R - win + 1
constexpr int kMaxR = kMaxWin + 1 + 2 * kMargin;
// The map stage: a strip of kStrip adjacent outputs b of one row a per
// thread, kStrips strips a row (the last one reaches past column A - 1:
// its extra outputs are dropped).
constexpr int kStrip = 6;
constexpr int kStrips = (kA + kStrip - 1) / kStrip;
constexpr int kMapThreads = kA * kStrips;
static_assert(kMapThreads <= kThreads, "a map strip per thread");
// Past the region, what the last strip's dropped outputs read.
constexpr int kRegionSlack = kStrips * kStrip - kA;

struct Smem {
  float region[kMaxR * kMaxR + kRegionSlack];  // `to`, row stride R
  float2 g[kMaxWin * kMaxWin];                 // (gx, gy) patches
  float m1[kA * kA];
  float m2[kA * kA];
  float red[2][kWarps][5];  // two sets used in turn: one barrier a sum
  float2 flow;              // the loop's result, from warp 0
};

// Sum v[0..K) over the block; every thread gets the same bits.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], Smem& sm, int& par) {
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

// Copy 4 bytes global -> shared asynchronously; with inside false, no byte
// is read and the destination is zero-filled (src-size 0).
__device__ __forceinline__ void cp_async_f32_zfill(float* dst,
                                                   const float* src,
                                                   bool inside) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned n = inside ? 4u : 0u;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
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

// Start copying the R x R `to` region at corner (ox, oy) into shared
// memory; taps outside the plane read 0, as jnp_level.py regions.
__device__ __forceinline__ void stage_region(const Planes& pl, int ox,
                                             int oy, int rs, Smem& sm) {
  const int count = rs * rs;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int r = k / rs;
    const int c = k - r * rs;
    const int y = oy + r;
    const int x = ox + c;
    const bool inside = y >= 0 && y < pl.h && x >= 0 && x < pl.w;
    const float* src = inside ? pl.to + static_cast<size_t>(y) * pl.w + x
                              : pl.to;
    cp_async_f32_zfill(sm.region + k, src, inside);
  }
}

// The two nonzero taps i, i + 1 of the tent selector row max(0, 1 -
// |r - (off + p)|) and their weights, rounded as jnp_level.py tents rounds.
struct Tent {
  int i;
  float w0, w1;
};

__device__ __forceinline__ Tent tent(float off, int p) {
  const float t = __fadd_rn(off, static_cast<float>(p));
  const float f = floorf(t);
  Tent r;
  r.i = static_cast<int>(f);
  r.w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(f, t))), 0.0f);
  r.w1 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(__fadd_rn(f, 1.0f), t))),
               0.0f);
  return r;
}

// The patch sample at tent rows ty and columns tx of a plane whose setup
// region has its corner at `corner`: the rows' blend, then the columns'.
__device__ __forceinline__ float tent_sample(const float* __restrict__ plane,
                                             int w, size_t corner,
                                             const Tent& ty, const Tent& tx) {
  const float* p = plane + corner + static_cast<size_t>(ty.i) * w + tx.i;
  const float c0 = ty.w0 * __ldg(p) + ty.w1 * __ldg(p + w);
  const float c1 = ty.w0 * __ldg(p + 1) + ty.w1 * __ldg(p + w + 1);
  return tx.w0 * c0 + tx.w1 * c1;
}

// C1, C2 of the region against the gx, gy patches into shared memory (the
// threads below kMapThreads; see the file header).
__device__ __forceinline__ void build_maps(Smem& sm, int rs, int win) {
  const int t = threadIdx.x;
  if (t >= kMapThreads) return;
  const int a = t / kStrips;
  const int b0 = kStrip * (t - a * kStrips);
  float acc1[kStrip], acc2[kStrip];
#pragma unroll
  for (int j = 0; j < kStrip; ++j) acc1[j] = acc2[j] = 0.0f;
  for (int p = 0; p < win; ++p) {
    const float* row = sm.region + (a + p) * rs + b0;
    const float2* g = sm.g + p * win;
    float x[kStrip];
#pragma unroll
    for (int j = 0; j < kStrip - 1; ++j) x[j] = row[j];
#pragma unroll 3
    for (int q = 0; q < win; ++q) {
      x[kStrip - 1] = row[q + kStrip - 1];
      const float2 gq = g[q];
#pragma unroll
      for (int j = 0; j < kStrip; ++j) {
        acc1[j] = fmaf(x[j], gq.x, acc1[j]);
        acc2[j] = fmaf(x[j], gq.y, acc2[j]);
      }
#pragma unroll
      for (int j = 0; j < kStrip - 1; ++j) x[j] = x[j + 1];
    }
  }
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    if (b0 + j < kA) {
      sm.m1[a * kA + b0 + j] = acc1[j];
      sm.m2[a * kA + b0 + j] = acc2[j];
    }
  }
}

struct LevelResult {
  float fx, fy, min_eig;
  bool ok;
};

// One level in correlation form for one feature on the whole block (see
// the file header).  Every argument and the result are block-uniform.  A
// feature that is inactive and whose min_eig nothing reads (need_eig
// false) skips the level: its ok would meet an ok that is already false.
__device__ LevelResult xcorr_level(const Planes& pl, float px, float py,
                                   float fx0, float fy0, bool active,
                                   bool need_eig, int win, int iterations,
                                   float eps_sq, float min_eig_threshold,
                                   Smem& sm, int& par) {
  if (!active && !need_eig) return LevelResult{fx0, fy0, 0.0f, false};
  const int half = win / 2;
  const int area = win * win;
  const int rs = win + 1 + 2 * kMargin;

  // The `to` region is copied while the setup samples are read.
  const int ox = min(max(static_cast<int>(floorf(__fadd_rn(px, fx0))) -
                             half - kMargin,
                         0),
                     pl.w - rs);
  const int oy = min(max(static_cast<int>(floorf(__fadd_rn(py, fy0))) -
                             half - kMargin,
                         0),
                     pl.h - rs);
  if (active) stage_region(pl, ox, oy, rs, sm);

  // Setup: this thread's samples of from, gx, gy; its shares of G, c1, c2.
  const float x0 = fminf(fmaxf(__fsub_rn(px, static_cast<float>(half)), 0.0f),
                         static_cast<float>(pl.w - win - 1));
  const float y0 = fminf(fmaxf(__fsub_rn(py, static_cast<float>(half)), 0.0f),
                         static_cast<float>(pl.h - win - 1));
  const int sx = min(max(static_cast<int>(floorf(x0)), 0), pl.w - win - 2);
  const int sy = min(max(static_cast<int>(floorf(y0)), 0), pl.h - win - 2);
  const float offx = __fsub_rn(x0, static_cast<float>(sx));
  const float offy = __fsub_rn(y0, static_cast<float>(sy));
  const size_t corner = static_cast<size_t>(sy) * pl.w + sx;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // g11 g12 g22 c1 c2
  for (int k = threadIdx.x; k < area; k += kThreads) {
    const int p = k / win;
    const int q = k - p * win;
    const Tent ty = tent(offy, p);
    const Tent tx = tent(offx, q);
    const float vi = tent_sample(pl.from, pl.w, corner, ty, tx);
    const float vx = tent_sample(pl.gx, pl.w, corner, ty, tx);
    const float vy = tent_sample(pl.gy, pl.w, corner, ty, tx);
    sm.g[k] = make_float2(vx, vy);
    acc[0] += vx * vx;
    acc[1] += vx * vy;
    acc[2] += vy * vy;
    acc[3] += vi * vx;
    acc[4] += vi * vy;
  }
  cp_async_wait_all();
  block_sum(acc, sm, par);  // its barrier also publishes the region and g

  const float det = acc[0] * acc[2] - acc[1] * acc[1];
  const float trace = acc[0] + acc[2];
  const float min_eig =
      (trace - sqrtf(fmaxf(trace * trace - 4.0f * det, 0.0f))) * 0.5f /
      static_cast<float>(area);
  const bool ok_g = (min_eig > min_eig_threshold) && (det > 1e-12f);
  float fx = fx0, fy = fy0;
  if (active && ok_g) {
    const float inv_det = 1.0f / det;
    build_maps(sm, rs, win);
    __syncthreads();
    if (threadIdx.x < 32) {
      const XcorrScalars s{
          acc[3],
          acc[4],
          acc[2] * inv_det,
          -acc[1] * inv_det,
          acc[0] * inv_det,
          __fsub_rn(__fsub_rn(px, static_cast<float>(half)),
                    static_cast<float>(ox)),
          __fsub_rn(__fsub_rn(py, static_cast<float>(half)),
                    static_cast<float>(oy))};
      xcorr_loop(sm.m1, sm.m2, kA, s, fx, fy, iterations, eps_sq,
                 static_cast<float>(rs - win - 1));
      if (threadIdx.x == 0) sm.flow = make_float2(fx, fy);
    }
    __syncthreads();
    fx = sm.flow.x;
    fy = sm.flow.y;
  }
  // an inactive or not-ok feature never stepped: fx, fy are flow_in
  return LevelResult{fx, fy, min_eig, ok_g};
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
  int top;     // the coarsest level, max_level
  int h0, w0;  // unpadded level-0 size, for the in-bounds test
  float pad;   // the planes' border padding
  int win, iterations;
  float eps_sq, min_eig_threshold;
};

struct TrackResult {
  float x, y, err;
  bool status;
};

// lk_track_pyr in correlation form for one feature: from pyramid A into B,
// or (reverse) from B into A.  The glue's float operations round as
// PyTorch's do.
__device__ TrackResult track_pyr(const PyrPlanes& pp, const PyrConfig& cfg,
                                 int stream, bool reverse, float x, float y,
                                 float init_x, float init_y, bool valid, Smem& sm,
                                 int& par) {
  const int a = reverse ? 1 : 0;
  const int gxi = reverse ? 4 : 2;
  const float top_scale = static_cast<float>(1 << cfg.top);
  float fx = __fdiv_rn(__fsub_rn(init_x, x), top_scale);
  float fy = __fdiv_rn(__fsub_rn(init_y, y), top_scale);
  bool ok = valid;
  float min_eig = 0.0f;
  for (int level = cfg.top; level >= 0; --level) {
    const float scale = static_cast<float>(1 << level);
    const long long off = stream * pp.stride[level];
    const Planes pl{pp.p[level][a] + off,   pp.p[level][1 - a] + off,
                    pp.p[level][gxi] + off, pp.p[level][gxi + 1] + off,
                    pp.h[level],            pp.w[level]};
    const LevelResult r = xcorr_level(
        pl, __fadd_rn(__fdiv_rn(x, scale), cfg.pad),
        __fadd_rn(__fdiv_rn(y, scale), cfg.pad), fx, fy, ok,
        !reverse && level == 0, cfg.win, cfg.iterations, cfg.eps_sq,
        cfg.min_eig_threshold, sm, par);
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

__global__ void __launch_bounds__(kThreads)
lk_xcorr_pyr_kernel(PyrPlanes pp, PyrConfig cfg,
                    const float* __restrict__ pts_from,
                    const float* __restrict__ pts_init,
                    const unsigned char* __restrict__ valid,
                    float* __restrict__ points_out,
                    unsigned char* __restrict__ status_out,
                    float* __restrict__ err_out, int bidirectional,
                    float fb_threshold, int pts_stride) {
  __shared__ Smem sm;
  // blockIdx.y is the stream; i indexes its features in the
  // [n_streams, pts_stride] point, valid and output arrays.
  const int stream = blockIdx.y;
  const long long i =
      static_cast<long long>(stream) * pts_stride + blockIdx.x;
  int par = 0;
  const float x = pts_from[2 * i];
  const float y = pts_from[2 * i + 1];
  const TrackResult fwd =
      track_pyr(pp, cfg, stream, false, x, y, pts_init[2 * i],
                pts_init[2 * i + 1], valid[i] != 0, sm, par);
  bool status = fwd.status;
  // A feature the forward track lost keeps status false whatever its
  // reverse track gives, so only tracked features run it.
  if (bidirectional && status) {
    const TrackResult rev =
        track_pyr(pp, cfg, stream, true, fwd.x, fwd.y, x, y, true, sm, par);
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

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Every pointer is a
// contiguous device buffer: C1/C2 float32 [n, a_size, a_size], the seven
// scalars float32 [n], flow_in/flow_out float32 [n, 2], active bool (one
// byte) [n].  max_off must lie in [0, a_size - 1]; a_size * a_size must be
// a multiple of 4 and C1/C2 16-byte aligned (the maps are copied with
// 16-byte loads; the port's maps have A = 22).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a map the kernel does not
// take.
extern "C" int visfs_lk_xcorr(const float* c1, const float* c2,
                              const float* c1_const, const float* c2_const,
                              const float* gi11, const float* gi12,
                              const float* gi22, const float* base_x,
                              const float* base_y, const float* flow_in,
                              const unsigned char* active, float* flow_out,
                              int n, int a_size, int iterations, float eps_sq,
                              float max_off, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      sizeof(float) * 2 * kWarpsPerBlock * static_cast<size_t>(a_size) *
      a_size;
  if (a_size < 1 || (a_size * a_size) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(c1) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c2) % 16 != 0 || smem > 48 * 1024 ||
      !(max_off >= 0.0f) || max_off > static_cast<float>(a_size - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lk_xcorr_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      c1, c2, c1_const, c2_const, gi11, gi12, gi22, base_x, base_y, flow_in,
      active, flow_out, n, a_size, iterations, eps_sq, max_off);
  return static_cast<int>(cudaGetLastError());
}

// One launch of a whole pyramidal track in correlation form (levels
// `levels - 1` .. 0), forward only or bidirectional.  `planes` is a HOST
// array of levels * 6 device pointers, per level A, B, gx(A), gy(A), gx(B),
// gy(B) (the last two may be null when not bidirectional); `shapes` a host
// array of levels * 2 ints, per level h, w (each at least win + 2).
// pts_from/pts_init/points [n, 2] float32, valid/status [n] bool (one
// byte), err [n] float32, all on the device.  The stream axis is
// visfs_lk_pyr's (lk_level.cu): grid (n, n_streams), per-level plane
// strides in `strides` (host), [n_streams, pts_stride] point and output
// rows.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int visfs_lk_xcorr_pyr(const float* const* planes,
                                  const int* shapes, int levels,
                                  int n_streams, const long long* strides,
                                  int pts_stride, const float* pts_from,
                                  const float* pts_init,
                                  const unsigned char* valid,
                                  float* points_out,
                                  unsigned char* status_out, float* err_out,
                                  int n, int h0, int w0, int pad, int win,
                                  int iterations, float eps_sq,
                                  float min_eig_threshold, int bidirectional,
                                  float fb_threshold, void* stream) {
  if (n <= 0 || n_streams <= 0) return static_cast<int>(cudaSuccess);
  if (n_streams > 65535 || (n_streams > 1 && pts_stride < n) ||
      levels < 1 || levels > kMaxLevels || win < 1 || win > kMaxWin)
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
  lk_xcorr_pyr_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pp, cfg, pts_from, pts_init, valid, points_out, status_out, err_out,
      bidirectional, fb_threshold, pts_stride);
  return static_cast<int>(cudaGetLastError());
}
