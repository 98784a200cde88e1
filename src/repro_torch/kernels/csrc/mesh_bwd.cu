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
// Determinism: no float atomics.  Each block walks its row tiles in a fixed
// order and, per column, sums the per-row gradient terms over its rows in
// row order into its own slice partial[block, C, 8, P] (a plain store on its
// first tile, then read-add-store by the same thread).  A second kernel
// sums the slices in block order.  The block count depends only on B, n and
// the card (one wave of resident blocks), so two calls on the same inputs
// give the same bits.
//
// Bound: per row, read y and g and write dx (24 n bytes) against ~88 flops
// per pair and column (inverse and adjoint 2x2 products and four conjugate
// products): about 3.7 n flop/byte for a Clements mesh (C = n), below the
// H100's float32 ridge of 20 flop/byte up to n ~ 5, above it beyond.  At
// the paper's n = 8 both bounds are far under a launch's own latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kDetEps = 1e-12f;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 cneg(float2 a) {
  return make_float2(-a.x, -a.y);
}

int rows_per_block(int n) {
  const int r = kThreads / (n / 2);
  return r < 1 ? 1 : r;
}

size_t shared_bytes(int n) {
  // state and cotangent tiles (float2 [R][n] each), gradient terms float [R][4n]
  return static_cast<size_t>(rows_per_block(n)) * n * 32;
}

__global__ void __launch_bounds__(kThreads)
mesh_bwd_kernel(const float2* __restrict__ y, const float2* __restrict__ g,
                const float* __restrict__ coef, const int* __restrict__ parity,
                float* __restrict__ partial, float2* __restrict__ dx,
                int batch, int n, int n_cols, int rows_per_tile, int n_tiles) {
  extern __shared__ float2 smem[];
  const int p = n / 2;
  const int m = 8 * p;  // gradient entries per column
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

    for (int k = 0; k < n_cols; ++k) {
      const int c = n_cols - 1 - k;
      const int par = __ldg(parity + c);
      const int slots = par ? p - 1 : p;  // 0 for n = 2, parity 1
      const float* cc = coef + static_cast<long long>(c) * m;
      const int work = rows * slots;
      for (int i = threadIdx.x; i < work; i += blockDim.x) {
        const int r = i / slots;
        const int s = i - r * slots;
        const float2 t00 = make_float2(__ldg(cc + 0 * p + s), __ldg(cc + 1 * p + s));
        const float2 t01 = make_float2(__ldg(cc + 2 * p + s), __ldg(cc + 3 * p + s));
        const float2 t10 = make_float2(__ldg(cc + 4 * p + s), __ldg(cc + 5 * p + s));
        const float2 t11 = make_float2(__ldg(cc + 6 * p + s), __ldg(cc + 7 * p + s));
        // inverse: adj(t) / det(t), 1 / det = conj(det) / max(|det|^2, eps)
        const float2 det = cadd(cmul(t00, t11), cneg(cmul(t01, t10)));
        const float d2 = fmaxf(det.x * det.x + det.y * det.y, kDetEps);
        const float2 inv_det = make_float2(det.x / d2, -det.y / d2);
        const float2 i00 = cmul(t11, inv_det);
        const float2 i01 = cneg(cmul(t01, inv_det));
        const float2 i10 = cneg(cmul(t10, inv_det));
        const float2 i11 = cmul(t00, inv_det);

        const int top = r * n + 2 * s + par;  // the pair (top, top + 1)
        const float2 a = st[top], b = st[top + 1];
        const float2 ga = gt[top], gb = gt[top + 1];
        const float2 a_in = cadd(cmul(i00, a), cmul(i01, b));
        const float2 b_in = cadd(cmul(i10, a), cmul(i11, b));

        float* tr = terms + r * m;
        const float2 d00 = cmulc(a_in, ga), d01 = cmulc(b_in, ga);
        const float2 d10 = cmulc(a_in, gb), d11 = cmulc(b_in, gb);
        tr[0 * p + s] = d00.x;
        tr[1 * p + s] = d00.y;
        tr[2 * p + s] = d01.x;
        tr[3 * p + s] = d01.y;
        tr[4 * p + s] = d10.x;
        tr[5 * p + s] = d10.y;
        tr[6 * p + s] = d11.x;
        tr[7 * p + s] = d11.y;

        st[top] = a_in;
        st[top + 1] = b_in;
        gt[top] = cadd(cmulc(t00, ga), cmulc(t10, gb));      // (t^H g)_a
        gt[top + 1] = cadd(cmulc(t01, ga), cmulc(t11, gb));  // (t^H g)_b
      }
      __syncthreads();
      // column sum over this tile's rows, in row order; one writer per entry
      for (int j = threadIdx.x; j < m; j += blockDim.x) {
        float sum = 0.f;
        if (j % p < slots) {
          for (int r = 0; r < rows; ++r) sum += terms[r * m + j];
        }
        float* dst = part + static_cast<long long>(c) * m + j;
        *dst = first ? sum : *dst + sum;
      }
      __syncthreads();
    }

    for (int i = threadIdx.x; i < count; i += blockDim.x) dx[base + i] = gt[i];
    __syncthreads();
    first = false;
  }
}

// dcoef[j] = sum over blocks b, in order, of partial[b, j]: threadIdx.x picks
// the entry (coalesced), threadIdx.y a fixed stride of blocks, then the 8
// strided sums are added in order.
__global__ void mesh_bwd_reduce(const float* __restrict__ partial,
                                float* __restrict__ dcoef, int n_blocks,
                                int total) {
  __shared__ float red[8][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float sum = 0.f;
  if (j < total) {
    for (int b = threadIdx.y; b < n_blocks; b += 8) {
      sum += partial[static_cast<long long>(b) * total + j];
    }
  }
  red[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && j < total) {
    float s = red[0][threadIdx.x];
    for (int q = 1; q < 8; ++q) s += red[q][threadIdx.x];
    dcoef[j] = s;
  }
}

}  // namespace

// The number of blocks mesh_bwd_launch expects (the first dimension of its
// `partial` scratch): the row tiles of the batch, capped at one wave of
// resident blocks on the current device.  Returns -(CUDA error) on failure.
// The caller guarantees batch > 0 and even n >= 2.
extern "C" int mesh_bwd_blocks(int batch, int n) {
  const int rows = rows_per_block(n);
  const int tiles = static_cast<int>((static_cast<long long>(batch) + rows - 1)
                                     / rows);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mesh_bwd_kernel, kThreads, shared_bytes(n));
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int wave = sms * per_sm > 0 ? sms * per_sm : 1;
  return tiles < wave ? tiles : wave;
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
  const int rows = rows_per_block(n);
  const int tiles = static_cast<int>((static_cast<long long>(batch) + rows - 1)
                                     / rows);
  if (n_blocks < 1 || n_blocks > tiles) {
    return static_cast<int>(cudaErrorInvalidValue);  // a slice left unwritten
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mesh_bwd_kernel<<<n_blocks, kThreads, shared_bytes(n), s>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(g),
      static_cast<const float*>(coef), static_cast<const int*>(parity),
      static_cast<float*>(partial), static_cast<float2*>(dx), batch, n, n_cols,
      rows, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_cols * 8 * (n / 2);
  mesh_bwd_reduce<<<(total + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dcoef), n_blocks,
      total);
  return static_cast<int>(cudaGetLastError());
}
