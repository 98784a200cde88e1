// Forward sweep of one n-channel mesh of arbitrary complex 2x2 cells.
//
//   y = T_{C-1} ... T_1 T_0 x,   x, y: complex64 [B, n] (interleaved re, im)
//
// Column c applies, for every pair slot s, the 2x2 matrix held in
// coef[c, 0:8, s] = (t00, t01, t10, t11) x (re, im) to the channel pair
//   parity 0: (2s,   2s+1)  for s in [0, P)
//   parity 1: (2s+1, 2s+2)  for s in [0, P-1)  (slot P-1 is never a cell;
//                                               channels 0 and n-1 pass)
// with P = n / 2.  Same [C, 8, P] float32 coefficient layout as the JAX
// package's Pallas kernel (repro/kernels/givens_mesh.py: mesh_kernel), which
// this kernel replaces on Hopper.
//
// Design: one block owns a tile of R rows, staged in shared memory as
// float2[R][n].  The C columns run in a loop inside the block
// (mesh_sweep.cuh: forward_sweep); each thread takes (row, slot) pairs,
// reads its cell through __ldg and rotates the pair in place (pairs within
// a column are disjoint), and __syncthreads() separates the columns.  The
// last tile is masked to the rows that exist.
// The coefficients are read from global memory (L1/L2-resident: they are
// the same for every block); staging all of them would take 16 n^2 bytes of
// shared memory, 256 KiB at n = 128, above the 227 KiB a block may use.
//
// Bound: each row moves 16 n bytes (read x, write y) for 28 flops per pair
// and column, 14 n^2 flops for a Clements mesh (C = n): about n flop/byte.
// The H100's float32 ridge is 67 TFLOP/s over 3.35 TB/s = 20 flop/byte, so
// below n ~ 20 the sweep is memory-bound.  At the paper's n = 8 (28 cells)
// the bytes take 0.16 us at B = 4096, far under a launch's own latency, so
// there a launch is bound by launch latency.

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::kThreads;

__global__ void __launch_bounds__(kThreads)
mesh_fwd_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                const float* __restrict__ coef, const int* __restrict__ parity,
                int batch, int n, int n_cols, int rows_per_block) {
  extern __shared__ float2 tile[];  // [rows_per_block][n]
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = batch - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const long long base = row0 * n;
  const int count = rows * n;

  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = x[base + i];
  __syncthreads();
  mesh_sweep::forward_sweep(tile, coef, parity, n_cols, rows, n);
  for (int i = threadIdx.x; i < count; i += blockDim.x) y[base + i] = tile[i];
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  The caller guarantees batch > 0,
// even n >= 2 and contiguous tensors.  Returns cudaGetLastError(), which
// also reports a refused launch (a tile above the 48 KB of static shared
// memory, n > 6144).
extern "C" int mesh_fwd_launch(const void* x, void* y, const void* coef,
                               const void* parity, int batch, int n,
                               int n_cols, void* stream) {
  const int rows_per_block = mesh_sweep::rows_per_tile(n);
  const size_t smem = static_cast<size_t>(rows_per_block) * n * sizeof(float2);
  const int blocks = mesh_sweep::tile_count(batch, rows_per_block);
  mesh_fwd_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y),
      static_cast<const float*>(coef), static_cast<const int*>(parity), batch,
      n, n_cols, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
