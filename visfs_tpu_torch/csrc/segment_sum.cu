// Per-pose sums of the pose graph's per-edge terms in one fixed order, for
// Hopper (sm_90a): visfs_segment_sum.
//
// The pose-graph solve (visfs_tpu_torch/parallel/pose_graph.py) adds, for
// every pose, the from-side terms of the edges leaving it and the to-side
// terms of the edges reaching it: the gradient, the block-Jacobi blocks and
// each CG matvec.  The reference adds them with .at[].add inside one XLA
// program (visfs_tpu/parallel/pose_graph.py:93,100,113).  index_add_ on the
// card adds in the order its atomics land, so two solves of one graph
// differ in their last bits, and the CG carries that to ~1e-4 m.  This
// kernel adds in the order the solve on the CPU uses (index_add_ there walks
// its index in order): for pose p, first the from-side terms of its edges in
// edge order, then their to-side terms in edge order, starting from 0.0f.
//
// Inputs (device pointers, all contiguous):
//   vals  [2E, cols] f32: edge e's from-side terms in row 2e, its to-side
//         terms in row 2e + 1 (the solve's stacked [E, 2, ...] terms);
//   rows  [2E] int64: the rows in walking order, pose-major (a stable sort
//         of the endpoints by pose, built once per graph); the endpoints of
//         masked edges sort last and are not walked (their terms carry a
//         weight of 0: an exact 0 adds nothing to a sum that starts at +0);
//   start [n + 1] int64: pose p walks rows[start[p] .. start[p + 1]);
//   out   [n, cols] f32, written whole.
//
// Design: one thread per (pose, column), so a warp reads contiguous columns
// of one term row; each thread loads kUnroll terms ahead before it adds
// them in order, so the loads of a run overlap and only the adds chain.  A
// pose's run is its degree (a few edges; closures add a few more).  The
// bytes are the walked rows once; the card spends the launch, not the sum.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void segment_sum_kernel(const float* __restrict__ vals,
                                   const long long* __restrict__ rows,
                                   const long long* __restrict__ start,
                                   float* __restrict__ out, int n,
                                   int cols) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n) * cols) return;
  const int p = static_cast<int>(t / cols);
  const int c = static_cast<int>(t - static_cast<long long>(p) * cols);
  const long long end = start[p + 1];
  long long k = start[p];
  float acc = 0.0f;
  for (; k + kUnroll <= end; k += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = vals[rows[k + u] * cols + c];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; k < end; ++k) acc = __fadd_rn(acc, vals[rows[k] * cols + c]);
  out[t] = acc;
}

}  // namespace

extern "C" int visfs_segment_sum(const float* vals, const long long* rows,
                                 const long long* start, float* out, int n,
                                 int cols, void* stream) {
  if (n <= 0 || cols <= 0) return static_cast<int>(cudaSuccess);
  const long long threads = static_cast<long long>(n) * cols;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  segment_sum_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      vals, rows, start, out, n, cols);
  return static_cast<int>(cudaGetLastError());
}
