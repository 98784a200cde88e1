// Backward (VJP) of the fused analog linear layer, B5: replaces the JAX
// package's Pallas TPU kernel repro/kernels/givens_mesh.py:
// rfnn_linear_bwd_kernel (via rfnn_linear_bwd_pallas_call).
//
// Forward (rfnn_fwd.cu): v = V x, u = U (g1 * v), out = |g2 * u|.  Given the
// saved stage boundaries v and u (complex64 [B, n], both before their gain)
// and the cotangent gout = dL/d out (float32 [B, n]), this computes
//
//   dcv [Cv, 8, P], dcu [Cu, 8, P]   the coefficient gradients (as B2)
//   dg [8, P]                        the real-plane gains gradient, rows
//                                    0-3 g1, 4-7 g2 (even re, even im,
//                                    odd re, odd im)
//   dx                               dL/dRe x + i dL/dIm x, complex64 [B, n]
//
// Per row tile, in one block:
//   1. the |.| backward: gz = gout * z / |z| with z = g2 * u, and exactly 0
//      where |z| = 0 (as the JAX kernel: no NaN from a zero input row);
//   2. g2: dg rows 4-7 += conj(u) gz; the cotangent at u is conj(g2) gz;
//   3. U's reversed sweep from the saved post-U boundary u (mesh_sweep.cuh:
//      reverse_sweep, the per-cell inverse and adjoint computed in-kernel as
//      in B2), which leaves the cotangent gh at U's input;
//   4. g1: dg rows 0-3 += conj(v) gh; the cotangent at v is conj(g1) gh;
//   5. V's reversed sweep from the saved post-V boundary v, leaving dx.
// V's sweep starts from its own saved boundary, never from U's input divided
// by g1: a programmed rank-deficient matrix has exact zeros in g1.
//
// Determinism: no float atomics.  Each block sums its rows' terms, tile by
// tile in a fixed order, into its own slice partial[block] = [dcv | dcu | dg]
// ((Cv + Cu) * 8 P + 8 P floats); a second kernel (mesh_sweep.cuh:
// reduce_partials) sums the slices in block order into one buffer that the
// wrapper splits.  The block count depends only on B, n and the card.
//
// Bound: per row, read v, u, gout and write dx (28 n bytes) against ~88
// flops per pair and column of both meshes (as B2): at the paper's n = 8
// both are far under a launch's own latency.

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::cmul;
using mesh_sweep::cmulc;
using mesh_sweep::kThreads;

__global__ void __launch_bounds__(kThreads)
rfnn_bwd_kernel(const float2* __restrict__ sv, const float2* __restrict__ su,
                const float* __restrict__ gout,
                const float* __restrict__ coef_v, const int* __restrict__ par_v,
                int cols_v, const float* __restrict__ coef_u,
                const int* __restrict__ par_u, int cols_u,
                const float* __restrict__ gains, float* __restrict__ partial,
                float2* __restrict__ dx, int batch, int n, int rows_per_tile,
                int n_tiles) {
  extern __shared__ float2 smem[];
  const int p = n / 2;
  const int m = 8 * p;  // gradient entries per column
  float2* st = smem;                                   // [R][n] state
  float2* gt = smem + rows_per_tile * n;               // [R][n] cotangent
  float* terms = reinterpret_cast<float*>(gt + rows_per_tile * n);  // [R][m]
  const long long slice = static_cast<long long>(cols_v + cols_u) * m + m;
  float* part_v = partial + blockIdx.x * slice;
  float* part_u = part_v + static_cast<long long>(cols_v) * m;
  float* part_g = part_u + static_cast<long long>(cols_u) * m;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows_per_tile;
    const long long left = batch - row0;
    const int rows = left < rows_per_tile ? static_cast<int>(left)
                                          : rows_per_tile;
    const long long base = row0 * n;
    const int count = rows * n;

    // 1-2: |.| backward and the post gain g2
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int r = i / n, k = i - r * n;
      const int s = k >> 1, o = k & 1;
      const float2 u = su[base + i];
      const float2 g2 = make_float2(__ldg(gains + (4 + 2 * o) * p + s),
                                    __ldg(gains + (5 + 2 * o) * p + s));
      const float2 z = cmul(u, g2);
      const float mag = sqrtf(z.x * z.x + z.y * z.y);
      const float w = mag > 0.f ? __ldg(gout + base + i) / mag : 0.f;
      const float2 gz = make_float2(w * z.x, w * z.y);
      const float2 d = cmulc(u, gz);
      terms[r * m + (2 * o) * p + s] = d.x;
      terms[r * m + (2 * o + 1) * p + s] = d.y;
      st[i] = u;
      gt[i] = cmulc(g2, gz);
    }
    __syncthreads();
    mesh_sweep::sum_rows(terms, rows, m, 4 * p, p, p, part_g + 4 * p, first);
    __syncthreads();

    // 3: U's reversed sweep from the saved post-U boundary
    mesh_sweep::reverse_sweep(st, gt, terms, coef_u, par_u, cols_u, rows, n,
                              part_u, first);

    // 4: the mid gain g1, from the saved post-V boundary
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int r = i / n, k = i - r * n;
      const int s = k >> 1, o = k & 1;
      const float2 v = sv[base + i];
      const float2 gh = gt[i];
      const float2 g1 = make_float2(__ldg(gains + (2 * o) * p + s),
                                    __ldg(gains + (2 * o + 1) * p + s));
      const float2 d = cmulc(v, gh);
      terms[r * m + (2 * o) * p + s] = d.x;
      terms[r * m + (2 * o + 1) * p + s] = d.y;
      st[i] = v;
      gt[i] = cmulc(g1, gh);
    }
    __syncthreads();
    mesh_sweep::sum_rows(terms, rows, m, 4 * p, p, p, part_g, first);
    __syncthreads();

    // 5: V's reversed sweep from the saved post-V boundary
    mesh_sweep::reverse_sweep(st, gt, terms, coef_v, par_v, cols_v, rows, n,
                              part_v, first);
    for (int i = threadIdx.x; i < count; i += blockDim.x) dx[base + i] = gt[i];
    __syncthreads();
    first = false;
  }
}

}  // namespace

// The number of blocks rfnn_bwd_launch expects (the first dimension of its
// `partial` scratch): the row tiles of the batch, capped at one wave of
// resident blocks on the current device.  Returns -(CUDA error) on failure.
// The caller guarantees batch > 0 and even n >= 2.
extern "C" int rfnn_bwd_blocks(int batch, int n) {
  const int tiles = mesh_sweep::tile_count(batch, mesh_sweep::rows_per_tile(n));
  return mesh_sweep::wave_blocks(rfnn_bwd_kernel, tiles,
                                 mesh_sweep::reverse_shared_bytes(n));
}

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  `partial` is float32 scratch of
// [n_blocks, (cols_v + cols_u + 1) * 8 * n/2] with n_blocks from
// rfnn_bwd_blocks; `grads` receives the block-order sum of the slices,
// [dcv | dcu | dg].  The caller guarantees batch > 0, even n >= 2 and
// contiguous tensors.  Returns cudaGetLastError() after both launches (a
// refused launch included: the tiles exceed the 48 KB of static shared
// memory above n = 1536).
extern "C" int rfnn_bwd_launch(const void* sv, const void* su,
                               const void* gout, const void* coef_v,
                               const void* par_v, int cols_v,
                               const void* coef_u, const void* par_u,
                               int cols_u, const void* gains, void* partial,
                               void* grads, void* dx, int batch, int n,
                               int n_blocks, void* stream) {
  const int rows = mesh_sweep::rows_per_tile(n);
  const int tiles = mesh_sweep::tile_count(batch, rows);
  if (n_blocks < 1 || n_blocks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);  // a slice left unwritten
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = mesh_sweep::reverse_shared_bytes(n);
  rfnn_bwd_kernel<<<n_blocks, kThreads, smem, s>>>(
      static_cast<const float2*>(sv), static_cast<const float2*>(su),
      static_cast<const float*>(gout), static_cast<const float*>(coef_v),
      static_cast<const int*>(par_v), cols_v,
      static_cast<const float*>(coef_u), static_cast<const int*>(par_u),
      cols_u, static_cast<const float*>(gains), static_cast<float*>(partial),
      static_cast<float2*>(dx), batch, n, rows, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = (cols_v + cols_u + 1) * 8 * (n / 2);
  mesh_sweep::reduce_partials<<<(total + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(grads), n_blocks,
      total);
  return static_cast<int>(cudaGetLastError());
}
