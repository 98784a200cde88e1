// Backward sweep (VJP) of one n-channel mesh of arbitrary complex 2x2 cells
// (B2).
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
// carrying the cotangent with the adjoint t^H, both from coef, where the
// TPU kernel took two host-built coefficient sets.
//
// Two paths, chosen by the caller's plan (givens_mesh.mesh_bwd_plan: by n,
// B and, through shared memory, C; an error, never a fallback):
//
// Register path, n in {2, 4, 8, 16, 32} (mesh_bwd_reg_kernel<n>): one
// thread a row holds the row's state and cotangent in registers, read and
// its dx written as 16-byte words where y, g and dx are 16-byte aligned.
// The block stages every cell and its inverse once (mesh_sweep.cuh:
// stage_cells, 32 n C bytes: 2 KiB at n = C = 8), so no row pays for the
// inverse's division.  Per column each thread reverses its cells
// (reverse_regs: reverse_cell's expressions) and the warp sums the
// column's 8 P gradient terms over its 32 rows by shuffles, in groups of
// up to 32 terms (mesh_sweep.cuh: reverse_group, add_terms,
// warp_scatter_sum: 31 shuffles a group, each lane ending with one sum);
// one lane a term adds it into the warp's own [C, 8, P] accumulator in
// shared memory.  For n <= 8 (one group a column) a column's warp sum is
// taken while the next column's cells are reversed, so the shuffles'
// latency hides behind that arithmetic.  No barrier falls inside the
// sweep.  At the end the block adds its warps' accumulators in warp order
// and writes them once: straight into dcoef when one block covers the
// batch (B <= 256 rows: one kernel a call, as at the paper's SGD batch of
// 10), else into its slice of partial[blocks, C, 8, P], which
// reduce_partials sums in block order.  Blocks walk the batch's 256-row
// tiles with a grid stride, at most one wave of them.
//
// General path, any other even n (mesh_bwd_kernel): a block stages a tile
// of R = 128 / P rows of state and cotangent in shared memory, threads take
// (row, slot) pairs through mesh_sweep.cuh: reverse_sweep (two barriers a
// column), each column's terms summed over the tile's rows into the block's
// slice, then reduce_partials.
//
// Determinism: no float atomics.  Every sum runs in an order fixed by the
// plan (lanes, warps, tiles a block, blocks), and the plan depends only on
// B, n, C and the card: two calls on the same inputs give the same bits.
//
// Bound: per row, read y and g and write dx (24 n bytes) against ~88 flops
// per pair and column (inverse and adjoint 2x2 products and four conjugate
// products with their row sums): about 3.7 n flop/byte for a Clements mesh
// (C = n), below the H100's float32 ridge of 20 flop/byte up to n ~ 5.  At
// the paper's n = 8 both bounds are far under a launch's own latency: a
// call costs the launch, one global round trip and one warp's chain of C
// columns, each its cells and a five-level shuffle tree (about 5.7 us a
// call on an H100 at B = 10, PERF.md §6).

#include <cstdint>

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

// Shared bytes of a register-path block of `warps` warps: the staged cells
// and inverses, the parities, and each warp's [C, 8, P] accumulator.
inline size_t reg_shared_bytes(int n, int n_cols, int warps) {
  return mesh_sweep::staged_cell_bytes(n, n_cols, 4)
         + static_cast<size_t>(warps) * n_cols * 4 * n * sizeof(float);
}

template <int N>
__global__ void __launch_bounds__(mesh_sweep::kRegRowsMax)
mesh_bwd_reg_kernel(const float2* __restrict__ y, const float2* __restrict__ g,
                    const float* __restrict__ coef,
                    const int* __restrict__ parity, float* __restrict__ out,
                    float2* __restrict__ dx, int batch, int n_cols,
                    int n_tiles) {
  constexpr int P = N / 2;
  constexpr int M = 8 * P;  // gradient entries a column
  extern __shared__ float4 cells[];  // [C][P][4], parities, accumulators
  const int* spar = reinterpret_cast<const int*>(cells + 4 * n_cols * P);
  float* acc = reinterpret_cast<float*>(cells + 4 * n_cols * P
                                        + ((n_cols + 3) >> 2));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* mine = acc + warp * n_cols * M;  // this warp's [C][8 P]

  const bool vec = ((reinterpret_cast<uintptr_t>(y)
                     | reinterpret_cast<uintptr_t>(g)
                     | reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  mesh_sweep::stage_cells<true>(cells, coef, parity, n_cols, P);
  __syncthreads();

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row = static_cast<long long>(tile) * blockDim.x
                          + threadIdx.x;
    const bool live = row < batch;
    float2 st[N], gt[N];
    if (live) {
      mesh_sweep::load_row(st, y + row * N, vec);
      mesh_sweep::load_row(gt, g + row * N, vec);
    } else {  // rows past the batch add exact zeros
#pragma unroll
      for (int k = 0; k < N; ++k) st[k] = gt[k] = make_float2(0.f, 0.f);
    }
    if constexpr (P <= 4) {
      // One group a column: column c's warp sum is taken while the cells
      // of column c - 1 are reversed (the two are independent, so the
      // shuffles' latency hides behind the cells' arithmetic).
      float prev[M];
      int c = n_cols - 1;
      if (spar[c]) {
        mesh_sweep::reverse_group<N, 1>(st, gt, cells + 4 * c * P, 0, prev);
      } else {
        mesh_sweep::reverse_group<N, 0>(st, gt, cells + 4 * c * P, 0, prev);
      }
      for (; c > 0; --c) {
        float cur[M];
        if (spar[c - 1]) {
          mesh_sweep::reverse_group<N, 1>(st, gt, cells + 4 * (c - 1) * P,
                                          0, cur);
          mesh_sweep::add_terms(prev, mine + c * M, lane, first);
        } else {
          mesh_sweep::reverse_group<N, 0>(st, gt, cells + 4 * (c - 1) * P,
                                          0, cur);
          mesh_sweep::add_terms(prev, mine + c * M, lane, first);
        }
#pragma unroll
        for (int v = 0; v < M; ++v) prev[v] = cur[v];
      }
      mesh_sweep::add_terms(prev, mine, lane, first);
    } else {
      for (int c = n_cols - 1; c >= 0; --c) {
        const float4* cc = cells + 4 * c * P;
        if (spar[c]) {
          mesh_sweep::reverse_column<N, 1>(st, gt, cc, mine + c * M, lane,
                                           first);
        } else {
          mesh_sweep::reverse_column<N, 0>(st, gt, cc, mine + c * M, lane,
                                           first);
        }
      }
    }
    if (live) mesh_sweep::store_row(dx + row * N, gt, vec);
    first = false;
  }
  __syncthreads();
  // The block's sum, warps in order, in coef's layout: entry (c, q, s) sits
  // in a warp's accumulator at group s / G, value q G + s % G.
  constexpr int G = P < 4 ? P : 4;
  float* dst = out + static_cast<long long>(blockIdx.x) * n_cols * M;
  for (int e = threadIdx.x; e < n_cols * M; e += blockDim.x) {
    const int c = e / M, r = e - c * M;
    const int q = r / P, s = r - q * P;
    const int at = c * M + 8 * (s - s % G) + q * G + s % G;
    float sum = acc[at];
    for (int w = 1; w < warps; ++w) sum += acc[w * n_cols * M + at];
    dst[e] = sum;
  }
}

template <int N>
int launch_reg(const float2* y, const float2* g, const float* coef,
               const int* parity, float* out, float2* dx, int batch,
               int n_cols, int rows, int blocks, size_t smem,
               cudaStream_t stream) {
  auto kernel = mesh_bwd_reg_kernel<N>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, rows, smem, stream>>>(y, g, coef, parity, out, dx, batch,
                                         n_cols,
                                         mesh_sweep::tile_count(batch, rows));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks an SM holds of `kernel`; a register-path kernel is first
// allowed its dynamic shared memory above 48 KB, as its launch does.
int occupancy(const void* kernel, int threads, size_t smem, bool reg) {
  if (reg && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

}  // namespace

// Resident blocks an SM of the current device holds of the backward kernel
// on path `reg` for width n at `threads` threads and `smem` dynamic shared
// bytes a block (the plan caps its blocks at one wave of them; the plan is
// cached per batch, width, columns and card, so this runs once a shape).
// Returns -(CUDA error) on failure, and -cudaErrorInvalidValue for a width
// the register path does not take.
extern "C" int mesh_bwd_occupancy(int reg, int n, int threads, long long smem) {
  const size_t sm = static_cast<size_t>(smem);
  if (!reg) {
    return occupancy(reinterpret_cast<const void*>(mesh_bwd_kernel), threads,
                     sm, false);
  }
  switch (n) {
    case 2: return occupancy(reinterpret_cast<const void*>(
        mesh_bwd_reg_kernel<2>), threads, sm, true);
    case 4: return occupancy(reinterpret_cast<const void*>(
        mesh_bwd_reg_kernel<4>), threads, sm, true);
    case 8: return occupancy(reinterpret_cast<const void*>(
        mesh_bwd_reg_kernel<8>), threads, sm, true);
    case 16: return occupancy(reinterpret_cast<const void*>(
        mesh_bwd_reg_kernel<16>), threads, sm, true);
    case 32: return occupancy(reinterpret_cast<const void*>(
        mesh_bwd_reg_kernel<32>), threads, sm, true);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  The plan (givens_mesh.py:
// mesh_bwd_plan) gives the path (`reg`), the rows a block tile, the block
// count and the dynamic shared bytes a block.  `partial` is float32 scratch
// of [blocks, n_cols, 8, n/2], unused (may be null) when the register path
// runs one block, which writes dcoef itself.  The caller guarantees batch >
// 0, even n >= 2 and contiguous tensors.  Returns cudaGetLastError() after
// the launches (a refused launch included: on the general path the tiles
// exceed the 48 KB of static shared memory above n = 1536), or
// cudaErrorInvalidValue for a plan this kernel cannot run.
extern "C" int mesh_bwd_launch(const void* y, const void* g, const void* coef,
                               const void* parity, void* partial, void* dcoef,
                               void* dx, int batch, int n, int n_cols, int reg,
                               int rows, int n_blocks, long long smem,
                               void* stream) {
  const int tiles = mesh_sweep::tile_count(batch, rows);
  if (n_blocks < 1 || n_blocks > tiles
      || (n_blocks > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);  // a slice left unwritten
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* yy = static_cast<const float2*>(y);
  const auto* gg = static_cast<const float2*>(g);
  const auto* cf = static_cast<const float*>(coef);
  const auto* par = static_cast<const int*>(parity);
  auto* dxx = static_cast<float2*>(dx);
  const size_t sm = static_cast<size_t>(smem);
  int err = 0;
  if (reg) {
    if (rows < 32 || rows > mesh_sweep::kRegRowsMax || rows % 32 != 0
        || sm < reg_shared_bytes(n, n_cols, rows / 32)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    float* out = static_cast<float*>(n_blocks == 1 ? dcoef : partial);
    switch (n) {
      case 2: err = launch_reg<2>(yy, gg, cf, par, out, dxx, batch, n_cols,
                                  rows, n_blocks, sm, s); break;
      case 4: err = launch_reg<4>(yy, gg, cf, par, out, dxx, batch, n_cols,
                                  rows, n_blocks, sm, s); break;
      case 8: err = launch_reg<8>(yy, gg, cf, par, out, dxx, batch, n_cols,
                                  rows, n_blocks, sm, s); break;
      case 16: err = launch_reg<16>(yy, gg, cf, par, out, dxx, batch, n_cols,
                                    rows, n_blocks, sm, s); break;
      case 32: err = launch_reg<32>(yy, gg, cf, par, out, dxx, batch, n_cols,
                                    rows, n_blocks, sm, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0 || n_blocks == 1) return err;
  } else {
    if (rows != mesh_sweep::rows_per_tile(n)
        || sm != mesh_sweep::reverse_shared_bytes(n)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    mesh_bwd_kernel<<<n_blocks, kThreads, sm, s>>>(
        yy, gg, cf, par, static_cast<float*>(partial), dxx, batch, n, n_cols,
        rows, tiles);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  const int total = n_cols * 8 * (n / 2);
  mesh_sweep::reduce_partials<<<(total + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dcoef),
      n_blocks, total);
  return static_cast<int>(cudaGetLastError());
}
