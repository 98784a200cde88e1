// Forward sweep of one n-channel mesh of arbitrary complex 2x2 cells (B1).
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
// Two paths, chosen by the caller's plan (givens_mesh.mesh_fwd_plan: by n,
// B and, through shared memory, C; an error, never a fallback):
//
// Register path, n in {2, 4, 8, 16, 32} (mesh_fwd_reg_kernel<n>): one
// thread a row holds the row's n channels in registers.  The block stages
// every cell once in shared memory, cell-major (mesh_sweep.cuh:
// stage_cells, 16 n C bytes: 1 KiB at the paper's n = C = 8), behind the
// one barrier of the kernel; then each thread walks the C columns alone,
// reading a cell as two broadcast float4 loads and rotating its pair with
// rotate_cell's expressions in their order (rotate_regs), so the outputs
// are the shared-memory sweep's bits.  A row is read and written as n / 2
// 16-byte words where x and y are 16-byte aligned (mesh_sweep.cuh:
// load_row, store_row).  Rows a block R: one block holds a batch of up to
// 256 rows; above, ceil(B / SMs) rows rounded up to a warp, at most 256.
//
// General path, any other even n (mesh_fwd_kernel): a block owns a tile of
// R = 128 / P rows staged in shared memory as float2[R][n]; threads take
// (row, slot) pairs, read the cell through __ldg and rotate the pair in
// place, and __syncthreads() separates the columns (mesh_sweep.cuh:
// forward_sweep).  The last tile is masked to the rows that exist.
//
// Bound: each row moves 16 n bytes (read x, write y) for 28 flops per pair
// and column, 14 n^2 flops for a Clements mesh (C = n): about n flop/byte.
// The H100's float32 ridge is 67 TFLOP/s over 3.35 TB/s = 20 flop/byte, so
// below n ~ 20 the sweep is memory-bound.  At the paper's n = 8 (28 cells)
// the bytes take 0.04 us at B = 1000, far under a launch's own latency:
// what a call costs there is the launch, one global round trip and the
// chain of C dependent columns of one thread, which the register path
// keeps free of barriers (about 3 us a call on an H100 at B <= 1000, PERF.md
// §6).  At B = 65536 the 8 MB of rows bound it (2.5 us at 3.35 TB/s).

#include <cstdint>

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

template <int N>
__global__ void __launch_bounds__(mesh_sweep::kRegRowsMax)
mesh_fwd_reg_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    const float* __restrict__ coef,
                    const int* __restrict__ parity, int batch, int n_cols) {
  constexpr int P = N / 2;
  extern __shared__ float4 cells[];  // [C][P][2], then the C parities
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
  const bool live = row < batch;
  const bool vec = ((reinterpret_cast<uintptr_t>(x)
                     | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  float2 st[N];
  // the row's loads are in flight while the cells are staged
  if (live) mesh_sweep::load_row(st, x + row * N, vec);
  mesh_sweep::stage_cells<false>(cells, coef, parity, n_cols, P);
  __syncthreads();
  if (!live) return;
  const int* spar = reinterpret_cast<const int*>(cells + 2 * n_cols * P);
  for (int c = 0; c < n_cols; ++c) {
    const float4* cc = cells + 2 * c * P;
    if (spar[c]) {
      mesh_sweep::rotate_column<N, 1>(st, cc);
    } else {
      mesh_sweep::rotate_column<N, 0>(st, cc);
    }
  }
  mesh_sweep::store_row(y + row * N, st, vec);
}

template <int N>
int launch_reg(const float2* x, float2* y, const float* coef,
               const int* parity, int batch, int n_cols, int rows, int blocks,
               size_t smem, cudaStream_t stream) {
  auto kernel = mesh_fwd_reg_kernel<N>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, rows, smem, stream>>>(x, y, coef, parity, batch, n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  The plan (givens_mesh.py:
// mesh_fwd_plan) gives the path (`reg`), the rows a block and the dynamic
// shared bytes a block; the block count follows from the batch.  The caller
// guarantees batch > 0, even n >= 2 and contiguous tensors.  Returns
// cudaGetLastError(), which also reports a refused launch (on the general
// path a tile above the 48 KB of static shared memory, n > 6144), or
// cudaErrorInvalidValue for a plan this kernel cannot run.
extern "C" int mesh_fwd_launch(const void* x, void* y, const void* coef,
                               const void* parity, int batch, int n,
                               int n_cols, int reg, int rows, long long smem,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xx = static_cast<const float2*>(x);
  auto* yy = static_cast<float2*>(y);
  const auto* cf = static_cast<const float*>(coef);
  const auto* par = static_cast<const int*>(parity);
  const int blocks = mesh_sweep::tile_count(batch, rows);
  if (reg) {
    if (rows < 1 || rows > mesh_sweep::kRegRowsMax || rows % 32 != 0
        || static_cast<size_t>(smem)
               < mesh_sweep::staged_cell_bytes(n, n_cols, 2)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (n) {
      case 2: return launch_reg<2>(xx, yy, cf, par, batch, n_cols, rows,
                                   blocks, smem, s);
      case 4: return launch_reg<4>(xx, yy, cf, par, batch, n_cols, rows,
                                   blocks, smem, s);
      case 8: return launch_reg<8>(xx, yy, cf, par, batch, n_cols, rows,
                                   blocks, smem, s);
      case 16: return launch_reg<16>(xx, yy, cf, par, batch, n_cols, rows,
                                     blocks, smem, s);
      case 32: return launch_reg<32>(xx, yy, cf, par, batch, n_cols, rows,
                                     blocks, smem, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (rows != mesh_sweep::rows_per_tile(n)
      || static_cast<size_t>(smem)
             != static_cast<size_t>(rows) * n * sizeof(float2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mesh_fwd_kernel<<<blocks, kThreads, smem, s>>>(xx, yy, cf, par, batch, n,
                                                 n_cols, rows);
  return static_cast<int>(cudaGetLastError());
}
