// One pyramid level of Lucas-Kanade for N features, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel visfs_tpu/ops/pallas/lk_kernel.py
// lk_level_pallas (body _lk_level_kernel, patch sampling _bilinear_patch)
// and computes exactly its semantics:
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
//
// Shape on the card: one warp per feature, 4 features per 128-thread block.
// Each lane owns samples k = lane + 32 s (s < MAXS) of the win x win patch
// and keeps its I, gx and gy samples in registers for the whole loop; G and
// b are reduced with xor-butterfly shuffles, so every lane holds the same
// bits and the step, the eps test and the loop exit are warp-uniform.
//
// What bounds it: each iteration gathers 4 taps of J per sample from the
// `to` plane, a dependent chain of L2 reads (a padded level-0 plane is
// ~1.3 MB and the four planes of a level stay resident in the 50 MB L2;
// reads go through the read-only path), and a warp does little arithmetic
// per read.  With N = 120 or 240 features a launch has only 30 to 60 blocks
// on 132 SMs, so the card is mostly idle and latency, not bandwidth or
// FLOPs, sets the time.  Later work: fuse levels and passes into one
// launch and spread a feature over more threads.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFullMask, v, m);
  return v;
}

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

__device__ __forceinline__ float sample(const float* __restrict__ img, int w,
                                        const Corner& c, int r, int col) {
  const float* p = img + static_cast<size_t>(c.iy + r) * w + (c.ix + col);
  return c.w00 * __ldg(p) + c.w10 * __ldg(p + 1) + c.w01 * __ldg(p + w) +
         c.w11 * __ldg(p + w + 1);
}

template <int MAXS>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
lk_level_kernel(const float* __restrict__ img_from,
                const float* __restrict__ img_to,
                const float* __restrict__ grad_x,
                const float* __restrict__ grad_y,
                const float* __restrict__ pts,
                const float* __restrict__ flow_in,
                const float* __restrict__ active,
                float* __restrict__ flow_out, float* __restrict__ ok_out,
                float* __restrict__ eig_out, int n, int h, int w, int win,
                int iterations, float eps_sq, float min_eig_threshold) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // warp-uniform: the whole warp leaves together

  const int half = win / 2;
  const int area = win * win;
  const int max_ix = w - win - 2;
  const int max_iy = h - win - 2;
  const float px = pts[2 * i];
  const float py = pts[2 * i + 1];

  // Setup: this lane's samples of I, gx, gy and its share of G.
  float vi[MAXS], vx[MAXS], vy[MAXS];
  float g11 = 0.f, g12 = 0.f, g22 = 0.f;
  const Corner c0 = make_corner(px, py, half, max_ix, max_iy);
#pragma unroll
  for (int s = 0; s < MAXS; ++s) {
    const int k = lane + 32 * s;
    vi[s] = vx[s] = vy[s] = 0.f;
    if (k < area) {
      const int r = k / win;
      const int col = k - r * win;
      vi[s] = sample(img_from, w, c0, r, col);
      vx[s] = sample(grad_x, w, c0, r, col);
      vy[s] = sample(grad_y, w, c0, r, col);
      g11 += vx[s] * vx[s];
      g12 += vx[s] * vy[s];
      g22 += vy[s] * vy[s];
    }
  }
  g11 = warp_sum(g11);
  g12 = warp_sum(g12);
  g22 = warp_sum(g22);

  const float det = g11 * g22 - g12 * g12;
  const float trace = g11 + g22;
  const float min_eig =
      (trace - sqrtf(fmaxf(trace * trace - 4.0f * det, 0.0f))) * 0.5f /
      static_cast<float>(area);
  const bool ok_g = (min_eig > min_eig_threshold) && (det > 1e-12f);
  const float inv_det = 1.0f / (det > 1e-12f ? det : 1.0f);
  const float gi11 = g22 * inv_det;
  const float gi12 = -g12 * inv_det;
  const float gi22 = g11 * inv_det;

  const float fx0 = flow_in[2 * i];
  const float fy0 = flow_in[2 * i + 1];
  const bool run0 = (active[i] > 0.f) && ok_g;
  float fx = fx0, fy = fy0;
  bool run = run0;
  for (int it = 0; it < iterations && run; ++it) {
    const Corner cj = make_corner(px + fx, py + fy, half, max_ix, max_iy);
    float b1 = 0.f, b2 = 0.f;
#pragma unroll
    for (int s = 0; s < MAXS; ++s) {
      const int k = lane + 32 * s;
      if (k < area) {
        const int r = k / win;
        const int col = k - r * win;
        const float diff = vi[s] - sample(img_to, w, cj, r, col);
        b1 += diff * vx[s];
        b2 += diff * vy[s];
      }
    }
    b1 = warp_sum(b1);
    b2 = warp_sum(b2);
    const float dx = gi11 * b1 + gi12 * b2;
    const float dy = gi12 * b1 + gi22 * b2;
    fx += dx;
    fy += dy;
    run = (dx * dx + dy * dy) >= eps_sq;
  }

  if (lane == 0) {
    flow_out[2 * i] = run0 ? fx : fx0;
    flow_out[2 * i + 1] = run0 ? fy : fy0;
    ok_out[i] = ok_g ? 1.0f : 0.0f;
    eig_out[i] = min_eig;
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream).  Every pointer is a
// contiguous float32 device buffer: planes [h, w], pts/flow [n, 2],
// active/ok/eig [n].  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a window the kernel does not take.
extern "C" int visfs_lk_level(const float* img_from, const float* img_to,
                              const float* grad_x, const float* grad_y,
                              const float* pts, const float* flow_in,
                              const float* active, float* flow_out,
                              float* ok_out, float* eig_out, int n, int h,
                              int w, int win, int iterations, float eps_sq,
                              float min_eig_threshold, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (win < 1 || h < win + 2 || w < win + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int area = win * win;
  if (area <= 32 * 14) {  // win <= 21
    lk_level_kernel<14><<<grid, block, 0, s>>>(
        img_from, img_to, grad_x, grad_y, pts, flow_in, active, flow_out,
        ok_out, eig_out, n, h, w, win, iterations, eps_sq, min_eig_threshold);
  } else if (area <= 32 * 31) {  // win <= 31
    lk_level_kernel<31><<<grid, block, 0, s>>>(
        img_from, img_to, grad_x, grad_y, pts, flow_in, active, flow_out,
        ok_out, eig_out, n, h, w, win, iterations, eps_sq, min_eig_threshold);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
