// The fused AdamW update of the port's optimizer (optim/adamw.py): global-
// norm clipping, bias-corrected moments and decoupled weight decay in one
// read of p, g, m, v and one write of p, m, v a leaf.  It replaces no TPU
// kernel: the JAX package's AdamW (repro/optim/adamw.py) is plain jnp, whose
// elementwise chain XLA fuses by itself.  In PyTorch's eager mode the same
// chain was about 14 float32 passes a leaf (242 launches a step at the
// granite-3-2b train cell), so this kernel was added to do the update in one.
//
// Bound: device memory.  With clipping, g is read once for the global norm,
// then p, g, m, v are read and p, m, v written: 32 bytes a float32 param
// with float32 moments, 28 without clipping.  At the granite-3-2b train
// cell's 1.317 B params that is 42.2 GB, 12.6 ms at 3.35 TB/s.  The design
// moves each byte once and keeps every scalar on the card:
//
//   adamw_sqnorm_kernel    (clipping only) one launch a leaf: each thread
//                          sums g^2 over a fixed strided set of 4-element
//                          vectors, then a fixed tree over the block writes
//                          one float32 partial a block.  No atomics, so the
//                          same inputs give the same bits on every run.
//   adamw_finalize_kernel  one block: the partials summed in double in a
//                          fixed order; writes gnorm and the scalar block
//                          (scale, 1 - b1^step, 1 - b2^step), the biases
//                          from the device step count, so nothing waits for
//                          the host.
//   adamw_update_kernel    one launch a leaf, a grid-stride loop over
//                          4-element vectors (16-byte loads and stores for
//                          float32; 8 bytes for bfloat16) sized to a few
//                          blocks an SM, and a scalar tail; the four
//                          scalars come from shared memory at each use, so
//                          nothing spills to local memory.
//
// Arithmetic: the plain version's formula and order (kernels/adamw_fused.py
// update_plain), each operation with a round-to-nearest intrinsic, so nvcc
// contracts nothing into an FMA that PyTorch's separate kernels do not have:
//   g * scale; m b1 + (1 - b1) g; v b2 + ((1 - b2) g) g;
//   (m / bc1) / (sqrt(v / bc2) + eps) [+ wd p]; p - lr delta;
//   scale = min((1 / max(gnorm, 1e-9)) clip, 1), as Tensor.__rtruediv__.
// Without clipping the result is the plain version's on the card bit for
// bit (powf is what PyTorch's pow calls); with it, the norm's summation
// order is the one difference.  p is float32 or bfloat16, g float32 or
// bfloat16 (grad compression), m and v float32 or bfloat16 (moment dtype),
// each bfloat16 store rounded to nearest even, as Tensor.to.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // every launch; kernels/adamw_fused.py _THREADS

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f(float x, bf16* out) {
  *out = __float2bfloat16_rn(x);
}

// Element 4i .. 4i + 3 as float: one 16-byte load for float32, 8 bytes for
// bfloat16 (element 4i in the low half of the first word).
__device__ __forceinline__ void load4(const float* __restrict__ a, int64_t i,
                                      float (&x)[4]) {
  const float4 v = reinterpret_cast<const float4*>(a)[i];
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const bf16* __restrict__ a, int64_t i,
                                      float (&x)[4]) {
  const uint2 v = reinterpret_cast<const uint2*>(a)[i];
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &v.x, sizeof(lo));
  memcpy(&hi, &v.y, sizeof(hi));
  const float2 flo = __bfloat1622float2(lo);
  const float2 fhi = __bfloat1622float2(hi);
  x[0] = flo.x;
  x[1] = flo.y;
  x[2] = fhi.x;
  x[3] = fhi.y;
}

__device__ __forceinline__ void store4(float* __restrict__ a, int64_t i,
                                       const float (&x)[4]) {
  reinterpret_cast<float4*>(a)[i] = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(bf16* __restrict__ a, int64_t i,
                                       const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 v;
  memcpy(&v.x, &lo, sizeof(lo));
  memcpy(&v.y, &hi, sizeof(hi));
  reinterpret_cast<uint2*>(a)[i] = v;
}

// The block's sum in thread 0, by a fixed tree: shuffles within each warp,
// then the warps' sums within warp 0.  `shared` holds kThreads / 32 values.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* shared) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kThreads / 32 ? shared[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads)
    adamw_sqnorm_kernel(const TG* __restrict__ g, int64_t n, int vec,
                        float* __restrict__ partial) {
  __shared__ float shared[kThreads / 32];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nv = vec ? n / 4 : 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t i = t; i < nv; i += stride) {
    float x[4];
    load4(g, i, x);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(x[k], x[k]));
  }
  for (int64_t i = 4 * nv + t; i < n; i += stride) {
    const float x = to_f(g[i]);
    acc[0] = __fadd_rn(acc[0], __fmul_rn(x, x));
  }
  const float s = block_sum(
      __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])),
      shared);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// scalars[0..2] = scale, bc1, bc2 (the update kernel reads them).
__global__ void __launch_bounds__(kThreads)
    adamw_finalize_kernel(const float* __restrict__ partial, int n_partial,
                          const int* __restrict__ step, float b1, float b2,
                          float clip, int clipping, float* __restrict__ gnorm,
                          float* __restrict__ scalars) {
  __shared__ double shared[kThreads / 32];
  double s = 0.0;
  for (int i = threadIdx.x; i < n_partial; i += kThreads) s += partial[i];
  s = block_sum(s, shared);
  if (threadIdx.x != 0) return;
  const float stepf = static_cast<float>(*step);
  float norm = 0.f, scale = 1.f;
  if (clipping) {
    norm = __fsqrt_rn(static_cast<float>(s));
    const float den = norm < 1e-9f ? 1e-9f : norm;  // NaN stays NaN
    scale = __fmul_rn(__fdiv_rn(1.f, den), clip);
    scale = scale > 1.f ? 1.f : scale;
  }
  *gnorm = norm;
  scalars[0] = scale;
  scalars[1] = __fsub_rn(1.f, powf(b1, stepf));
  scalars[2] = __fsub_rn(1.f, powf(b2, stepf));
}

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd;  // omb = 1 - b, rounded once
  int clipping, decay;
};

__device__ __forceinline__ void adamw_elem(float& p, float g, float& m,
                                           float& v, float scale, float bc1,
                                           float bc2, float lr, Hyper h) {
  if (h.clipping) g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float delta = __fdiv_rn(__fdiv_rn(m, bc1),
                          __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  if (h.decay) delta = __fadd_rn(delta, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, delta));
}

template <typename TP, typename TG, typename TM>
__global__ void __launch_bounds__(kThreads) adamw_update_kernel(
    const TP* __restrict__ p, const TG* __restrict__ g,
    const TM* __restrict__ m, const TM* __restrict__ v, TP* __restrict__ p_out,
    TM* __restrict__ m_out, TM* __restrict__ v_out, int64_t n, int vec,
    const float* __restrict__ scalars, const float* __restrict__ lr_dev,
    Hyper h) {
  // scale, bc1, bc2 and lr, staged once a block and read at each use:
  // held in registers across the loop, ptxas spilled them to local memory
  // around the IEEE division's slow-path calls (a local load an element)
  __shared__ float staged[4];
  if (threadIdx.x == 0) {
    staged[0] = scalars[0];
    staged[1] = scalars[1];
    staged[2] = scalars[2];
    staged[3] = lr_dev != nullptr ? *lr_dev : h.lr;
  }
  __syncthreads();
  const volatile float* sc = staged;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t nv = vec ? n / 4 : 0;
  for (int64_t i = t; i < nv; i += stride) {
    float pf[4], gf[4], mf[4], vf[4];
    load4(p, i, pf);
    load4(g, i, gf);
    load4(m, i, mf);
    load4(v, i, vf);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      adamw_elem(pf[k], gf[k], mf[k], vf[k], sc[0], sc[1], sc[2], sc[3], h);
    store4(p_out, i, pf);
    store4(m_out, i, mf);
    store4(v_out, i, vf);
  }
  for (int64_t i = 4 * nv + t; i < n; i += stride) {
    float pf = to_f(p[i]), mf = to_f(m[i]), vf = to_f(v[i]);
    adamw_elem(pf, to_f(g[i]), mf, vf, sc[0], sc[1], sc[2], sc[3], h);
    from_f(pf, p_out + i);
    from_f(mf, m_out + i);
    from_f(vf, v_out + i);
  }
}

struct UpdateCall {
  const void *p, *g, *m, *v;
  void *p_out, *m_out, *v_out;
  int64_t n;
  int vec, blocks;
  const float* scalars;
  const float* lr_dev;
  Hyper h;
  cudaStream_t stream;
};

template <typename TP, typename TG, typename TM>
void run_update(const UpdateCall& c) {
  adamw_update_kernel<TP, TG, TM><<<c.blocks, kThreads, 0, c.stream>>>(
      static_cast<const TP*>(c.p), static_cast<const TG*>(c.g),
      static_cast<const TM*>(c.m), static_cast<const TM*>(c.v),
      static_cast<TP*>(c.p_out), static_cast<TM*>(c.m_out),
      static_cast<TM*>(c.v_out), c.n, c.vec, c.scalars, c.lr_dev, c.h);
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// One leaf's partial sums of g^2: `blocks` floats from `partial`.
int adamw_sqnorm_launch(const void* g, long long n, int g_bf16,
                        float* partial, int blocks, void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned(g, g_bf16 ? 8 : 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    adamw_sqnorm_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(g), n, vec, partial);
  else
    adamw_sqnorm_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), n, vec, partial);
  return static_cast<int>(cudaGetLastError());
}

// gnorm (0 without clipping) and scalars[0..2] = scale, bc1, bc2 for the
// int32 step count at `step`; `partial` may be null when n_partial is 0.
int adamw_finalize_launch(const float* partial, int n_partial,
                          const int* step, float b1, float b2, float clip,
                          int clipping, float* gnorm, float* scalars,
                          void* stream) {
  if (n_partial < 0) return static_cast<int>(cudaErrorInvalidValue);
  adamw_finalize_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, n_partial, step, b1, b2, clip, clipping, gnorm, scalars);
  return static_cast<int>(cudaGetLastError());
}

// One leaf's update; `lr_dev` (a float32 on the card) overrides `lr` when
// not null.  The 4-element vector body runs when all seven pointers are
// aligned to a vector, else the scalar loop takes every element.
int adamw_update_launch(const void* p, const void* g, const void* m,
                        const void* v, void* p_out, void* m_out, void* v_out,
                        long long n, int p_bf16, int g_bf16, int mv_bf16,
                        const float* scalars, const float* lr_dev, float lr,
                        float b1, float omb1, float b2, float omb2, float eps,
                        float wd, int clipping, int decay, int blocks,
                        void* stream) {
  if (n < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  UpdateCall c;
  c.p = p;
  c.g = g;
  c.m = m;
  c.v = v;
  c.p_out = p_out;
  c.m_out = m_out;
  c.v_out = v_out;
  c.n = n;
  c.vec = aligned(p, p_bf16 ? 8 : 16) && aligned(p_out, p_bf16 ? 8 : 16) &&
          aligned(g, g_bf16 ? 8 : 16) && aligned(m, mv_bf16 ? 8 : 16) &&
          aligned(v, mv_bf16 ? 8 : 16) && aligned(m_out, mv_bf16 ? 8 : 16) &&
          aligned(v_out, mv_bf16 ? 8 : 16);
  c.blocks = blocks;
  c.scalars = scalars;
  c.lr_dev = lr_dev;
  c.h = Hyper{lr, b1, omb1, b2, omb2, eps, wd, clipping, decay};
  c.stream = static_cast<cudaStream_t>(stream);
  switch (p_bf16 * 4 + g_bf16 * 2 + mv_bf16) {
    case 0: run_update<float, float, float>(c); break;
    case 1: run_update<float, float, bf16>(c); break;
    case 2: run_update<float, bf16, float>(c); break;
    case 3: run_update<float, bf16, bf16>(c); break;
    case 4: run_update<bf16, float, float>(c); break;
    case 5: run_update<bf16, float, bf16>(c); break;
    case 6: run_update<bf16, bf16, float>(c); break;
    case 7: run_update<bf16, bf16, bf16>(c); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
