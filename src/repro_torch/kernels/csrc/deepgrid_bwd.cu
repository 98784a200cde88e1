// Backward (VJP) of the deep tile grid, B8: replaces the JAX package's
// Pallas TPU kernel repro/kernels/givens_mesh.py: deepgrid_bwd_kernel (via
// deepgrid_bwd_pallas_call).
//
// Forward (deepgrid_fwd.cu), per layer l and tile (o, i):
// s = g0 * in_i, v = V s, u = U (g1 * v), z = g2 * u, row_o = sum_i z_(o,i);
// layer l > 0 takes in_i = |row_i| of layer l - 1.  From the input x
// (complex64 [B, Ti n]), the saved stage boundaries sv, su (complex64
// [L, B, To, Ti, n], both before their gain) and the cotangent gout of the
// output (float32 magnitudes, or complex64 rows, [B, To n]) this computes
//
//   dcv, dcu [L, To, Ti, C, 8, P]   the coefficient gradients
//   dg [L, To, Ti, 12, P]           the gains gradient (rows 0-3 g0, 4-7 g1,
//                                   8-11 g2; even re, even im, odd re,
//                                   odd im)
//   dx                              dL/dRe x + i dL/dIm x, complex64
//                                   [B, Ti n]
//
// Per row tile, in one block, layers in reverse:
//   0. the readout: with detect_last the |.| backward gz = gout z / |z| of
//      the last layer's rows z (rebuilt from su and g2, no sweep), exactly 0
//      where |z| = 0; else gz = gout.  The combine is a sum, so every tile of
//      row o sees gz_o;
//   1. g2: dg rows 8-11 += conj(u) gz; the cotangent at u is conj(g2) gz;
//   2. U's reversed sweep from the saved post-U boundary, all tiles
//      together (mesh_sweep.cuh: grid_reverse_sweep);
//   3. g1: dg rows 4-7 += conj(v) gh; the cotangent at v is conj(g1) gh;
//   4. V's reversed sweep from the saved post-V boundary;
//   5. g0: dg rows 0-3 += conj(in) gs, with in rebuilt as x (l = 0) or
//      |row| of layer l - 1 from its saved post-U and g2 (no sweep);
//   6. the combine's transpose: input tile i's cotangent is the sum over the
//      To rows, in ascending order, of its tiles' cotangents.  At l > 0 only
//      its real part crosses the boundary (the input's imaginary part is 0),
//      through the |.| backward of layer l - 1's rows: that is gz for l - 1.
//      At l = 0 it is dx.
// A parked tile (g2 = 0) and a zero row give exact zeros, never NaN.
//
// Threads map over (row, tile, pair slot), as in the forward.  Shared memory
// per row: the state and cotangent of every tile (float2[To Ti][n] each), the
// gradient terms (float[To Ti][8 P]), the row cotangents gz and the previous
// layer's rows (float2[max(To, Ti) n] each): 9 KiB at 64 x 64.  512 threads
// take R = 512 / (To Ti P) rows (1 to 64) per block.
//
// Determinism: no float atomics.  Each block sums its rows' terms, tile by
// tile in a fixed order, into its own slice partial[block] = [dcv | dcu | dg]
// (L To Ti (2 C 8 P + 12 P) floats: 0.55 MB at 64 x 64, L = 4, Clements); a
// second kernel (mesh_sweep.cuh: reduce_partials) sums the slices in block
// order.  The block count is the batch's row tiles, capped at one wave of
// resident blocks and at 128 MiB of slices; a block walks its row tiles with
// a grid stride.  The count depends only on B, the shapes and the card.
//
// Bound: about three times the forward's operations (the inverse rebuild,
// the adjoint and the conjugate products per cell) against x, sv, su, gout
// and dx: operation-bound at 64 x 64, L = 4.

#include "mesh_sweep.cuh"

namespace {

using mesh_sweep::cadd;
using mesh_sweep::cmul;
using mesh_sweep::cmulc;
using mesh_sweep::gain_at;

constexpr int kBwdThreads = 512;
constexpr int kMaxRows = 64;
constexpr size_t kMaxShared = 232448;           // what a block may use
constexpr size_t kPartialBudget = 128ull << 20;  // bytes of gradient slices

// Row o's combined output z of a layer: sum over its Ti tiles, in order, of
// g2 * u, from the layer's saved post-U boundary of this row (`u_row`,
// float2[To Ti][n]) and its gains `g`.
__device__ __forceinline__ float2 row_z(const float2* __restrict__ u_row,
                                        const float* __restrict__ g, int o,
                                        int ti, int k, int n) {
  const int p = n / 2;
  const int t0 = o * ti;
  float2 z = cmul(u_row[t0 * n + k], gain_at(g, t0, 8, k, p));
  for (int j = 1; j < ti; ++j) {
    z = cadd(z, cmul(u_row[(t0 + j) * n + k], gain_at(g, t0 + j, 8, k, p)));
  }
  return z;
}

// The |.| backward: the real cotangent d of |z| carried to z, 0 at |z| = 0.
__device__ __forceinline__ float2 detect_bwd(float2 z, float d) {
  const float mag = sqrtf(z.x * z.x + z.y * z.y);
  const float w = mag > 0.f ? d / mag : 0.f;
  return make_float2(w * z.x, w * z.y);
}

// conj(a) * b into the 4 gain rows (even re, even im, odd re, odd im) of a
// tile's [8 P] terms.
__device__ __forceinline__ void gain_terms(float* tr, float2 a, float2 b,
                                           int k, int p) {
  const int s = k >> 1, o = k & 1;
  const float2 d = cmulc(a, b);
  tr[(2 * o) * p + s] = d.x;
  tr[(2 * o + 1) * p + s] = d.y;
}

template <bool kDetectLast>
__global__ void __launch_bounds__(kBwdThreads)
deepgrid_bwd_kernel(const float2* __restrict__ x, const float2* __restrict__ sv,
                    const float2* __restrict__ su,
                    const void* __restrict__ gout,
                    const float* __restrict__ coef_v,
                    const int* __restrict__ par_v,
                    const float* __restrict__ coef_u,
                    const int* __restrict__ par_u,
                    const float* __restrict__ gains,
                    float* __restrict__ partial, float2* __restrict__ dx,
                    int batch, int n, int n_layers, int to, int ti, int n_cols,
                    int rows_per_tile, int n_tiles) {
  extern __shared__ float2 smem[];
  const int p = n / 2;
  const int m = 8 * p;
  const int tiles = to * ti;
  const int tn = tiles * n;
  const int row_w = (to > ti ? to : ti) * n;
  float2* st = smem;                                   // [R][tiles][n]
  float2* gt = st + rows_per_tile * tn;                // [R][tiles][n]
  float2* gz = gt + rows_per_tile * tn;                // [R][row_w]
  float2* zp = gz + rows_per_tile * row_w;             // [R][row_w]
  float* terms = reinterpret_cast<float*>(zp + rows_per_tile * row_w);
  //                                                      [R][tiles][8 P]
  const long long coef_layer = static_cast<long long>(tiles) * n_cols * m;
  const int par_layer = tiles * n_cols;
  const int gain_layer = tiles * 12 * p;
  const long long slice = n_layers * (2 * coef_layer + gain_layer);
  float* part_v = partial + blockIdx.x * slice;
  float* part_u = part_v + n_layers * coef_layer;
  float* part_g = part_u + n_layers * coef_layer;
  const int in_w = ti * n, out_w = to * n;

  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * rows_per_tile;
    const long long left = batch - row0;
    const int rows = left < rows_per_tile ? static_cast<int>(left)
                                          : rows_per_tile;

    // 0: the readout's cotangent at the last layer's rows
    {
      const int l = n_layers - 1;
      const float* g = gains + l * gain_layer;
      const float2* u_blk = su + (static_cast<long long>(l) * batch + row0) * tn;
      for (int i = threadIdx.x; i < rows * out_w; i += blockDim.x) {
        const int r = i / out_w;
        const int q = i - r * out_w;
        const long long at = row0 * out_w + i;
        if (kDetectLast) {
          const int o = q / n, k = q - o * n;
          const float2 z = row_z(u_blk + r * tn, g, o, ti, k, n);
          gz[r * row_w + q] = detect_bwd(z, static_cast<const float*>(gout)[at]);
        } else {
          gz[r * row_w + q] = static_cast<const float2*>(gout)[at];
        }
      }
    }
    __syncthreads();

    for (int l = n_layers - 1; l >= 0; --l) {
      const float* g = gains + l * gain_layer;
      const long long stage = (static_cast<long long>(l) * batch + row0) * tn;
      float* dg_l = part_g + l * gain_layer;
      // layer l's input rows: layer l - 1's combined rows (To == Ti)
      if (l > 0) {
        const float* gp = gains + (l - 1) * gain_layer;
        const float2* u_prev = su + stage - static_cast<long long>(batch) * tn;
        for (int i = threadIdx.x; i < rows * in_w; i += blockDim.x) {
          const int r = i / in_w;
          const int q = i - r * in_w;
          const int o = q / n, k = q - o * n;
          zp[r * row_w + q] = row_z(u_prev + r * tn, gp, o, ti, k, n);
        }
      }
      // 1: g2, from the saved post-U boundary (every tile of row o sees gz_o)
      for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
        const int r = i / tn;
        const int q = i - r * tn;
        const int t = q / n, k = q - t * n;
        const float2 u = su[stage + i];
        const float2 gzo = gz[r * row_w + (t / ti) * n + k];
        gain_terms(terms + (r * tiles + t) * m, u, gzo, k, p);
        st[i] = u;
        gt[i] = cmulc(gain_at(g, t, 8, k, p), gzo);
      }
      __syncthreads();
      mesh_sweep::grid_sum_rows(terms, rows, tiles, m, 4 * p, dg_l + 8 * p,
                                12 * p, first, nullptr, 0, p);
      __syncthreads();
      // 2: U's reversed sweep
      mesh_sweep::grid_reverse_sweep(st, gt, terms, coef_u + l * coef_layer,
                                     par_u + l * par_layer, n_cols, rows,
                                     tiles, n, part_u + l * coef_layer, first);
      // 3: g1, from the saved post-V boundary
      for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
        const int r = i / tn;
        const int q = i - r * tn;
        const int t = q / n, k = q - t * n;
        const float2 v = sv[stage + i];
        const float2 gh = gt[i];
        gain_terms(terms + (r * tiles + t) * m, v, gh, k, p);
        st[i] = v;
        gt[i] = cmulc(gain_at(g, t, 4, k, p), gh);
      }
      __syncthreads();
      mesh_sweep::grid_sum_rows(terms, rows, tiles, m, 4 * p, dg_l + 4 * p,
                                12 * p, first, nullptr, 0, p);
      __syncthreads();
      // 4: V's reversed sweep
      mesh_sweep::grid_reverse_sweep(st, gt, terms, coef_v + l * coef_layer,
                                     par_v + l * par_layer, n_cols, rows,
                                     tiles, n, part_v + l * coef_layer, first);
      // 5: g0, on the layer's input tiles
      for (int i = threadIdx.x; i < rows * tn; i += blockDim.x) {
        const int r = i / tn;
        const int q = i - r * tn;
        const int t = q / n, k = q - t * n;
        const int at = (t % ti) * n + k;
        float2 in;
        if (l == 0) {
          in = x[(row0 + r) * in_w + at];
        } else {
          const float2 z = zp[r * row_w + at];
          in = make_float2(sqrtf(z.x * z.x + z.y * z.y), 0.f);
        }
        const float2 gs = gt[i];
        gain_terms(terms + (r * tiles + t) * m, in, gs, k, p);
        gt[i] = cmulc(gain_at(g, t, 0, k, p), gs);
      }
      __syncthreads();
      mesh_sweep::grid_sum_rows(terms, rows, tiles, m, 4 * p, dg_l, 12 * p,
                                first, nullptr, 0, p);
      // 6: the combine's transpose, then the boundary or dx
      for (int i = threadIdx.x; i < rows * in_w; i += blockDim.x) {
        const int r = i / in_w;
        const int q = i - r * in_w;
        const float2* gq = gt + r * tn + q;   // tile (0, q / n), channel q % n
        float2 d = gq[0];
        for (int o = 1; o < to; ++o) d = cadd(d, gq[o * in_w]);
        if (l > 0) {
          gz[r * row_w + q] = detect_bwd(zp[r * row_w + q], d.x);
        } else {
          dx[(row0 + r) * in_w + q] = d;
        }
      }
      __syncthreads();
    }
    first = false;
  }
}

inline int rows_per_tile(int n, int tiles) {
  const int r = kBwdThreads / (tiles * (n / 2));
  return r < 1 ? 1 : (r > kMaxRows ? kMaxRows : r);
}

inline size_t shared_bytes(int n, int to, int ti, int rows) {
  const size_t tn = static_cast<size_t>(to) * ti * n;
  const size_t row_w = static_cast<size_t>(to > ti ? to : ti) * n;
  // st, gt and the terms (4 floats a channel), then gz and zp
  return static_cast<size_t>(rows) * (tn * 2 * sizeof(float2)
                                      + tn * 4 * sizeof(float)
                                      + row_w * 2 * sizeof(float2));
}

inline size_t slice_floats(int n, int n_layers, int to, int ti, int n_cols) {
  const size_t p = n / 2;
  return static_cast<size_t>(n_layers) * to * ti * (2 * n_cols * 8 * p
                                                     + 12 * p);
}

template <bool kDetectLast>
int prepare(size_t smem) {
  if (smem > kMaxShared) return -static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        deepgrid_bwd_kernel<kDetectLast>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  return 0;
}

template <bool kDetectLast>
int blocks(int batch, int n, int n_layers, int to, int ti, int n_cols) {
  const int rows = rows_per_tile(n, to * ti);
  const size_t smem = shared_bytes(n, to, ti, rows);
  const int err = prepare<kDetectLast>(smem);
  if (err < 0) return err;
  const int tiles = mesh_sweep::tile_count(batch, rows);
  int b = mesh_sweep::wave_blocks(deepgrid_bwd_kernel<kDetectLast>, tiles,
                                  smem, kBwdThreads);
  if (b < 0) return b;
  const size_t slice = slice_floats(n, n_layers, to, ti, n_cols)
                       * sizeof(float);
  const size_t budget = kPartialBudget / slice;
  if (budget < static_cast<size_t>(b)) b = budget < 1 ? 1 : static_cast<int>(budget);
  return b;
}

template <bool kDetectLast>
int launch(const void* x, const void* sv, const void* su, const void* gout,
           const void* coef_v, const void* par_v, const void* coef_u,
           const void* par_u, const void* gains, void* partial, void* grads,
           void* dx, int batch, int n, int n_layers, int to, int ti,
           int n_cols, int n_blocks, cudaStream_t s) {
  const int rows = rows_per_tile(n, to * ti);
  const int tiles = mesh_sweep::tile_count(batch, rows);
  if (n_blocks < 1 || n_blocks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);  // a slice left unwritten
  }
  const size_t smem = shared_bytes(n, to, ti, rows);
  const int err = prepare<kDetectLast>(smem);
  if (err < 0) return -err;
  deepgrid_bwd_kernel<kDetectLast><<<n_blocks, kBwdThreads, smem, s>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(sv),
      static_cast<const float2*>(su), gout, static_cast<const float*>(coef_v),
      static_cast<const int*>(par_v), static_cast<const float*>(coef_u),
      static_cast<const int*>(par_u), static_cast<const float*>(gains),
      static_cast<float*>(partial), static_cast<float2*>(dx), batch, n,
      n_layers, to, ti, n_cols, rows, tiles);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  const int total = static_cast<int>(slice_floats(n, n_layers, to, ti,
                                                  n_cols));
  mesh_sweep::reduce_partials<<<(total + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(grads),
      n_blocks, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of blocks deepgrid_bwd_launch expects (the first dimension of
// its `partial` scratch).  Returns -(CUDA error) on failure, and
// -cudaErrorInvalidValue when a block's rows would not fit in shared memory.
// The caller guarantees batch > 0 and even n >= 2.
extern "C" int deepgrid_bwd_blocks(int batch, int n, int n_layers, int to,
                                   int ti, int n_cols, int detect_last) {
  return detect_last ? blocks<true>(batch, n, n_layers, to, ti, n_cols)
                     : blocks<false>(batch, n, n_layers, to, ti, n_cols);
}

// Plain C entry point (loaded with ctypes).  All pointers are device
// pointers; `stream` is a cudaStream_t.  `gout` is float32 [B, To n] when
// detect_last, else complex64.  `partial` is float32 scratch of
// [n_blocks, L To Ti (2 C 8 P + 12 P)] with n_blocks from
// deepgrid_bwd_blocks; `grads` receives the block-order sum of the slices,
// [dcv | dcu | dg].  The caller guarantees batch > 0, even n >= 2, To == Ti
// when L > 1 and contiguous tensors.  Returns cudaGetLastError() after both
// launches.
extern "C" int deepgrid_bwd_launch(const void* x, const void* sv,
                                   const void* su, const void* gout,
                                   const void* coef_v, const void* par_v,
                                   const void* coef_u, const void* par_u,
                                   const void* gains, void* partial,
                                   void* grads, void* dx, int batch, int n,
                                   int n_layers, int to, int ti, int n_cols,
                                   int detect_last, int n_blocks,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return detect_last
      ? launch<true>(x, sv, su, gout, coef_v, par_v, coef_u, par_u, gains,
                     partial, grads, dx, batch, n, n_layers, to, ti, n_cols,
                     n_blocks, s)
      : launch<false>(x, sv, su, gout, coef_v, par_v, coef_u, par_u, gains,
                      partial, grads, dx, batch, n, n_layers, to, ti, n_cols,
                      n_blocks, s);
}
