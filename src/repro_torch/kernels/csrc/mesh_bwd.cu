// Backward sweep (VJP) of one n-channel mesh of arbitrary complex 2x2 cells.
//
// Forward (mesh_fwd.cu): y = T_{C-1} ... T_1 T_0 x.  Given y and the
// cotangent g = dL/dRe(y) + i dL/dIm(y), this computes
//
//   dx          = T_0^H ... T_{C-1}^H g                  complex64 [B, n]
//   dcoef[c]    = sum over rows of conj(s_c) (x) g_{c+1}  float32 [C, 8, P]
//
// where s_c is column c's input state and g_{c+1} the cotangent at its
// output.  Row layout of dcoef[c, :, s] matches coef: (t00, t01, t10, t11)
// x (re, im); for the cell (a2, b2) = t (a, b) the rows are conj(a) ga,
// conj(b) ga, conj(a) gb, conj(b) gb.  The wrap slot P-1 of a parity-1
// column holds no cell, and its gradient is exactly 0.
//
// Replaces the JAX package's Pallas TPU kernel
// repro/kernels/givens_mesh.py: mesh_bwd_kernel (via mesh_bwd_pallas_call).
// The same recompute scheme: only y is kept from the forward, and the sweep
// walks the columns in reverse, rebuilding s_c = T_c^{-1} s_{c+1} with the
// analytic per-cell inverse adj(t) / det(t) (|det|^2 floored at 1e-12) and
// carrying the cotangent with the adjoint t^H.  Both are computed here per
// cell from coef, where the TPU kernel took two host-built coefficient sets.
// Shared memory therefore holds only the row tile of state and cotangent
// plus the per-row gradient terms of one column, 32 R n bytes, for any C.
//
// The column loop (inverse, gradient terms, adjoint, row sums) is
// mesh_sweep.cuh: reverse_sweep, shared with the fused layer's backward
// (rfnn_bwd.cu).
//
// Determinism: no float atomics.  Each block walks its row tiles in a fixed
// order and, per column, sums the per-row gradient terms over its rows in
// row order into its own slice partial[block, C, 8, P] (a plain store on its
// first tile, then read-add-store by the same thread).  A second kernel
// (mesh_sweep.cuh: reduce_partials) sums the slices in block order.  The
// block count depends only on B, n and the card (one wave of resident
// blocks), so two calls on the same inputs give the same bits.
//
// Bound: per row, read y and g and write dx (24 n bytes) against ~88 flops
// per pair and column (inverse and adjoint 2x2 products and four conjugate
// products): about 3.7 n flop/byte for a Clements mesh (C = n), below the
// H100's float32 ridge of 20 flop/byte up to n ~ 5, above it beyond.  At
// the paper's n = 8 both bounds are far under a launch's own latency.

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::kThreads;

__global__ void __launch_bounds__(kThreads)
mesh_bwd_kernel(const float2* __restrict__ y, const float2* __restrict__ g,
                const float* __restrict__ coef, const int* __restrict__ parity,
                float* __restrict__ partial, float2* __restrict__ dx,
                int batch, int n, int n_cols, int rows_per_tile, int n_tiles) {
  extern __shared__ float2 smem[];
  const int m = 4 * n;  // gradient entries per column (8 P)
  float2* st = smem;                                   // [R][n] state
  float2* gt = smem + rows_per_tile * n;               // [R][n] cotangent
  float* terms = reinterpret_cast<float*>(gt + rows_per_tile * n);  // [R][m]
  float* part = partial + static_cast<long long>(blockIdx.x) * n_cols * m;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows_per_tile;
    const long long left = batch - row0;
    const int rows = left < rows_per_tile ? static_cast<int>(left)
                                          : rows_per_tile;
    const long long base = row0 * n;
    const int count = rows * n;
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      st[i] = y[base + i];
      gt[i] = g[base + i];
    }
    __syncthreads();
    mesh_sweep::reverse_sweep(st, gt, terms, coef, parity, n_cols, rows, n,
                              part, first);
    for (int i = threadIdx.x; i < count; i += blockDim.x) dx[base + i] = gt[i];
    __syncthreads();
    first = false;
  }
}

}  // namespace

// The number of blocks mesh_bwd_launch expects (the first dimension of its
// `partial` scratch): the row tiles of the batch, capped at one wave of
// resident blocks on the current device.  Returns -(CUDA error) on failure.
// The caller guarantees batch > 0 and even n >= 2.
extern "C" int mesh_bwd_blocks(int batch, int n) {
  const int tiles = mesh_sweep::tile_count(batch, mesh_sweep::rows_per_tile(n));
  return mesh_sweep::wave_blocks(mesh_bwd_kernel, tiles,
                                 mesh_sweep::reverse_shared_bytes(n));
}

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  `partial` is float32 scratch of
// [n_blocks, n_cols, 8, n/2] with n_blocks from mesh_bwd_blocks.  The caller
// guarantees batch > 0, even n >= 2 and contiguous tensors.  Returns
// cudaGetLastError() after both launches (a refused launch included: the
// tiles exceed the 48 KB of static shared memory above n = 1536).
extern "C" int mesh_bwd_launch(const void* y, const void* g, const void* coef,
                               const void* parity, void* partial, void* dcoef,
                               void* dx, int batch, int n, int n_cols,
                               int n_blocks, void* stream) {
  const int rows = mesh_sweep::rows_per_tile(n);
  const int tiles = mesh_sweep::tile_count(batch, rows);
  if (n_blocks < 1 || n_blocks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);  // a slice left unwritten
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = mesh_sweep::reverse_shared_bytes(n);
  mesh_bwd_kernel<<<n_blocks, kThreads, smem, s>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(g),
      static_cast<const float*>(coef), static_cast<const int*>(parity),
      static_cast<float*>(partial), static_cast<float2*>(dx), batch, n, n_cols,
      rows, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_cols * 8 * (n / 2);
  mesh_sweep::reduce_partials<<<(total + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dcoef), n_blocks,
      total);
  return static_cast<int>(cudaGetLastError());
}
