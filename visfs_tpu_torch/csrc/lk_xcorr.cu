// The LK iteration loop in correlation form for N features, for Hopper
// (sm_90a).
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
// Shape on the card: one warp per feature, 4 features per 128-thread block.
// The warp copies its feature's C1 and C2 (2 x A*A f32, 3.9 KB at A = 22)
// into shared memory with 16-byte loads, then every lane runs the same
// dependent chain of <= `iterations` steps from shared memory (broadcast
// reads) with the scalars in registers, so the loop exit is warp-uniform;
// lane 0 writes the flow.
//
// What bounds it: the maps are the only sizeable input (2 x 1.9 KB per
// feature, 0.93 MB at N = 240), under a microsecond at 3.35 TB/s, and the
// arithmetic is ~40 FLOPs per feature-step.  The loop is a serial chain of
// shared-memory reads and FMAs per feature, and N = 120..240 features fill
// only 30..60 blocks of 132 SMs, so the launch latency and that chain set
// the time.  Fusing the map setup (ops/lk.py:_xcorr_maps) into this kernel
// is left for later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;

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
    const float cc1 = c1_const[i], cc2 = c2_const[i];
    const float gi11 = gi11_in[i], gi12 = gi12_in[i], gi22 = gi22_in[i];
    const float bx = base_x[i], by = base_y[i];
    bool run = true;
    for (int it = 0; it < iterations && run; ++it) {
      const float offx = fminf(fmaxf(bx + fx, 0.0f), max_off);
      const float offy = fminf(fmaxf(by + fy, 0.0f), max_off);
      const float fa = floorf(offy);
      const float fb = floorf(offx);
      const int ia = static_cast<int>(fa);
      const int ib = static_cast<int>(fb);
      const float wy1 = offy - fa, wy0 = 1.0f - wy1;
      const float wx1 = offx - fb, wx0 = 1.0f - wx1;
      const bool ra = ia + 1 < a_size;
      const bool rb = ib + 1 < a_size;
      const float b1 =
          cc1 - lookup(m1, a_size, ia, ib, wy0, wy1, wx0, wx1, ra, rb);
      const float b2 =
          cc2 - lookup(m2, a_size, ia, ib, wy0, wy1, wx0, wx1, ra, rb);
      const float dx = gi11 * b1 + gi12 * b2;
      const float dy = gi12 * b1 + gi22 * b2;
      fx += dx;
      fy += dy;
      run = (dx * dx + dy * dy) >= eps_sq;
    }
  }
  if (lane == 0) {
    flow_out[2 * i] = fx;
    flow_out[2 * i + 1] = fy;
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
