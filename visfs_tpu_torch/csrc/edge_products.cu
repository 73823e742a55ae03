// The pose graph's per-edge products in one fixed order, for Hopper
// (sm_90a): visfs_edge_products.
//
// The pose-graph solve (visfs_tpu_torch/parallel/pose_graph.py) makes, on
// each rank's block of edges, the terms it then adds per pose (K3,
// segment_sum.cu): the gradient's w Ji^T r and w Jj^T r, the block-Jacobi
// blocks w Ji^T Ji and w Jj^T Jj, and in every CG matvec w Ji^T y and
// w Jj^T y with y = Ji x_i + Jj x_j.  The reference writes them as einsums
// inside its XLA program (visfs_tpu/parallel/pose_graph.py:90-111); it
// replaces no TPU kernel.  torch.einsum on the card becomes a cuBLAS
// batched product whose kernel, and so whose rounding, cuBLAS picks by the
// batch: a 128-edge shard's terms differ in their last bits from the same
// rows of the 512-edge graph's, and the sharded solve then drifts from the
// one-rank solve.  This kernel computes each output element in the order
// the CPU's einsum uses, whatever the batch, the launch shape or where a
// shard starts:
//
//   gradient, matvec: t_k = w * v_k, then out_i = sum over k = 0..5 of
//       J[k][i] * t_k, from +0, k ascending (v = r, or v = y);
//   blocks:  out_ij = sum over k = 0..5 of (w * J[k][i]) * J[k][j], from
//       +0, k ascending;
//   y_k = (sum over i of Ji[k][i] * x[edge_i][i]) + (sum over i of
//       Jj[k][i] * x[edge_j][i]), each part from +0, i ascending.
//
// Every product is __fmul_rn and every add __fadd_rn, so nvcc contracts
// none of them into a fused multiply-add, which rounds once where the CPU
// rounds twice.
//
// Inputs (device pointers, all contiguous, float32 unless said):
//   w [E]; Ji, Jj [E, 6, 6] (row k, column i); v [E, 6] (gradient: r);
//   x [N, 6], edge_i, edge_j [E] int64 (matvec; an index outside [0, N)
//   makes its edge's outputs NaN, where PyTorch's gather would raise: the
//   wrapper cannot read the indices without waiting for the card);
//   out [E, 2, 6] (gradient, matvec) or [E, 2, 6, 6] (blocks): the from
//   side (Ji) in out[e][0], the to side (Jj) in out[e][1], as the per-pose
//   sum takes them.
//
// Design: one thread per (edge, side, output element); a matvec thread
// makes the edge's six y_k itself (12 threads make the same y, from the
// same loads, in the same order).  The bytes bound it: the launch reads
// each edge's 2 x 36 Jacobian entries once for ~144 (gradient) to ~864
// (blocks) operations; at the solve's 512 edges it is a few microseconds
// of launch on the card, and only the order matters here.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kGradient = 0;
constexpr int kBlocks = 1;
constexpr int kMatvec = 2;

// sum over k of J[k][i] * (w * v[k]), from +0, k ascending
__device__ __forceinline__ float weighted_jt(const float* __restrict__ J,
                                             float w, const float* v, int i) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k)
    acc = __fadd_rn(acc, __fmul_rn(J[k * 6 + i], __fmul_rn(w, v[k])));
  return acc;
}

// sum over i of J[k][i] * x[i], from +0, i ascending
__device__ __forceinline__ float j_row_x(const float* __restrict__ J,
                                         const float* __restrict__ x,
                                         int k) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc = __fadd_rn(acc, __fmul_rn(J[k * 6 + i],
                                                             x[i]));
  return acc;
}

template <int kMode>
__global__ void edge_products_kernel(const float* __restrict__ w,
                                     const float* __restrict__ Ji,
                                     const float* __restrict__ Jj,
                                     const float* __restrict__ v,
                                     const float* __restrict__ x,
                                     const long long* __restrict__ edge_i,
                                     const long long* __restrict__ edge_j,
                                     float* __restrict__ out, int n_edges,
                                     int n_poses) {
  constexpr int kCols = kMode == kBlocks ? 36 : 6;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(n_edges) * 2 * kCols) return;
  const int e = static_cast<int>(t / (2 * kCols));
  const int rest = static_cast<int>(t - static_cast<long long>(e) * 2 * kCols);
  const int side = rest / kCols;
  const int c = rest - side * kCols;
  const float we = w[e];
  const float* J = (side == 0 ? Ji : Jj) + static_cast<long long>(e) * 36;
  float result;
  if (kMode == kBlocks) {
    const int i = c / 6;
    const int j = c - i * 6;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(we, J[k * 6 + i]),
                                     J[k * 6 + j]));
    result = acc;
  } else if (kMode == kGradient) {
    float r[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) r[k] = v[static_cast<long long>(e) * 6 + k];
    result = weighted_jt(J, we, r, c);
  } else {
    const long long ii = edge_i[e];
    const long long jj = edge_j[e];
    if (ii < 0 || ii >= n_poses || jj < 0 || jj >= n_poses) {
      out[t] = NAN;
      return;
    }
    const float* xi = x + ii * 6;
    const float* xj = x + jj * 6;
    const float* Jie = Ji + static_cast<long long>(e) * 36;
    const float* Jje = Jj + static_cast<long long>(e) * 36;
    float y[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
      y[k] = __fadd_rn(j_row_x(Jie, xi, k), j_row_x(Jje, xj, k));
    result = weighted_jt(J, we, y, c);
  }
  out[t] = result;
}

}  // namespace

// mode 0 gradient (v = r), 1 blocks, 2 matvec (x [n_poses, 6], edge_i,
// edge_j); the pointers a mode does not read may be null.  Returns the
// launch's CUDA error (0 on success).
extern "C" int visfs_edge_products(int mode, const float* w, const float* Ji,
                                   const float* Jj, const float* v,
                                   const float* x, const long long* edge_i,
                                   const long long* edge_j, float* out,
                                   int n_edges, int n_poses, void* stream) {
  if (n_edges <= 0) return static_cast<int>(cudaSuccess);
  if (mode < kGradient || mode > kMatvec)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads =
      static_cast<long long>(n_edges) * 2 * (mode == kBlocks ? 36 : 6);
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kGradient)
    edge_products_kernel<kGradient><<<blocks, kThreads, 0, s>>>(
        w, Ji, Jj, v, x, edge_i, edge_j, out, n_edges, n_poses);
  else if (mode == kBlocks)
    edge_products_kernel<kBlocks><<<blocks, kThreads, 0, s>>>(
        w, Ji, Jj, v, x, edge_i, edge_j, out, n_edges, n_poses);
  else
    edge_products_kernel<kMatvec><<<blocks, kThreads, 0, s>>>(
        w, Ji, Jj, v, x, edge_i, edge_j, out, n_edges, n_poses);
  return static_cast<int>(cudaGetLastError());
}
