// Forward of the fused analog linear layer (paper Eq. 31, Fig. 11): the
// V-mesh, the mid gain g1, the U-mesh, the post gain g2 and the detector's
// magnitude, for complex64 rows x [B, n]:
//
//   v = V x,   u = U (g1 * v),   out = |g2 * u|        out: float32 [B, n]
//
// V and U are meshes of arbitrary complex 2x2 cells in the [C, 8, P] float32
// coefficient layout with int32 [C] parities (see mesh_fwd.cu); Cv may differ
// from Cu (a Reck program has more columns than a Clements rectangle).  The
// gains keep the JAX package's float32 [8, P] layout: rows 0-3 are g1
// (even re, even im, odd re, odd im), rows 4-7 g2, so channel 2s + o takes
// g1 = (gains[2o][s], gains[2o + 1][s]) and g2 = (gains[4 + 2o][s],
// gains[5 + 2o][s]).  `out` is in channel order: the even and odd magnitudes
// interleaved, as the JAX package's jnp.stack([oe, oo], -1).reshape(-1, n).
//
// One template, two kernels:
//   kSaveStages = false  B3, replaces repro/kernels/givens_mesh.py:
//                        rfnn_linear_kernel (inference; writes only `out`);
//   kSaveStages = true   B4, replaces givens_mesh.py: rfnn_linear_fwd_kernel
//                        (training forward; also writes the post-V and post-U
//                        stage boundaries v and u, complex64 [B, n], both
//                        taken before their gain: the residuals of B5).
//
// Design, as B1 (mesh_fwd.cu): one block stages a tile of R = 128 / P rows
// as float2[R][n] in shared memory, sweeps V's columns and then U's with a
// barrier per column (mesh_sweep.cuh: forward_sweep), coefficients through
// __ldg; the gains are applied elementwise in between.  The ragged last tile
// is masked to the rows that exist.
//
// Bound: per row the kernel reads x (8 n bytes) and writes out (4 n), plus
// 16 n for the two boundaries in B4, for 28 flops per pair and column of
// both meshes: about 2.3 n flop/byte for B3 over two Clements meshes, under
// the H100's float32 ridge of 20 flop/byte up to n ~ 8.  At the paper's
// n = 8 a launch is bound by launch latency: the bytes of B = 65536 rows
// take 1.9 us (B3).

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::cmul;
using mesh_sweep::kThreads;

template <bool kSaveStages>
__global__ void __launch_bounds__(kThreads)
rfnn_fwd_kernel(const float2* __restrict__ x, float* __restrict__ out,
                float2* __restrict__ sv, float2* __restrict__ su,
                const float* __restrict__ coef_v, const int* __restrict__ par_v,
                int cols_v, const float* __restrict__ coef_u,
                const int* __restrict__ par_u, int cols_u,
                const float* __restrict__ gains, int batch, int n,
                int rows_per_block) {
  extern __shared__ float2 tile[];  // [rows_per_block][n]
  const int p = n / 2;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long left = batch - row0;
  const int rows = left < rows_per_block ? static_cast<int>(left)
                                         : rows_per_block;
  const long long base = row0 * n;
  const int count = rows * n;

  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = x[base + i];
  __syncthreads();
  mesh_sweep::forward_sweep(tile, coef_v, par_v, cols_v, rows, n);

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int k = i % n;
    const int s = k >> 1, o = k & 1;
    const float2 v = tile[i];
    if (kSaveStages) sv[base + i] = v;
    const float2 g1 = make_float2(__ldg(gains + (2 * o) * p + s),
                                  __ldg(gains + (2 * o + 1) * p + s));
    tile[i] = cmul(v, g1);
  }
  __syncthreads();
  mesh_sweep::forward_sweep(tile, coef_u, par_u, cols_u, rows, n);

  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int k = i % n;
    const int s = k >> 1, o = k & 1;
    const float2 u = tile[i];
    if (kSaveStages) su[base + i] = u;
    const float2 g2 = make_float2(__ldg(gains + (4 + 2 * o) * p + s),
                                  __ldg(gains + (5 + 2 * o) * p + s));
    const float2 z = cmul(u, g2);
    out[base + i] = sqrtf(z.x * z.x + z.y * z.y);
  }
}

template <bool kSaveStages>
int launch(const void* x, void* out, void* sv, void* su, const void* coef_v,
           const void* par_v, int cols_v, const void* coef_u,
           const void* par_u, int cols_u, const void* gains, int batch, int n,
           void* stream) {
  const int rows = mesh_sweep::rows_per_tile(n);
  const size_t smem = static_cast<size_t>(rows) * n * sizeof(float2);
  rfnn_fwd_kernel<kSaveStages>
      <<<mesh_sweep::tile_count(batch, rows), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float2*>(x), static_cast<float*>(out),
          static_cast<float2*>(sv), static_cast<float2*>(su),
          static_cast<const float*>(coef_v), static_cast<const int*>(par_v),
          cols_v, static_cast<const float*>(coef_u),
          static_cast<const int*>(par_u), cols_u,
          static_cast<const float*>(gains), batch, n, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  The caller guarantees batch > 0,
// even n >= 2 and contiguous tensors.  Each returns cudaGetLastError(),
// which also reports a refused launch (a tile above the 48 KB of static
// shared memory, n > 6144).

// B3: out only.
extern "C" int rfnn_fwd_launch(const void* x, void* out, const void* coef_v,
                               const void* par_v, int cols_v,
                               const void* coef_u, const void* par_u,
                               int cols_u, const void* gains, int batch,
                               int n, void* stream) {
  return launch<false>(x, out, nullptr, nullptr, coef_v, par_v, cols_v,
                       coef_u, par_u, cols_u, gains, batch, n, stream);
}

// B4: out and the stage boundaries sv (post-V) and su (post-U).
extern "C" int rfnn_fwd_res_launch(const void* x, void* out, void* sv,
                                   void* su, const void* coef_v,
                                   const void* par_v, int cols_v,
                                   const void* coef_u, const void* par_u,
                                   int cols_u, const void* gains, int batch,
                                   int n, void* stream) {
  return launch<true>(x, out, sv, su, coef_v, par_v, cols_v, coef_u, par_u,
                      cols_u, gains, batch, n, stream);
}
