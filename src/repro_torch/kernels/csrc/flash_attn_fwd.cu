// Kernel B9: forward softmax attention with an online softmax (flash
// attention), o = softmax(q k^T * scale) v, causal or not (scale 1/sqrt(hd)
// unless the caller gives another: Granite's attention_multiplier), for q and o
// [B, H, Sq, hd] and k, v [B, H, Skv, hd] (KV heads already expanded to H),
// each given by its batch, head and sequence strides with the last dim
// contiguous, float32 or bfloat16 in and out.  Replaces the JAX package's
// Pallas TPU kernel repro/kernels/flash_attention.py: _kernel (its
// pl.pallas_call).
//
// The math is the TPU kernel's, in float32 whatever the input type: scores
// s = (q . k) * scale, masked scores (causal, key > query) set to -1e30
// before the row max, a running row max m and row sum l, p = exp(s - m_new)
// kept in float32 into the PV product, the accumulator rescaled by
// exp(m - m_new), and the finish acc / max(l, 1e-30) rounded once to the
// output type.  Keys past the sequence score -inf and add exactly nothing,
// so a causal row is bit-identical whatever the keys after it hold.
//
// Bound: 4 B H Sq Skv hd flops (half of it causal) against reading q, k, v
// and writing o once.  At TinyLlama's prefill (B 8, H 32, S 1024, hd 64,
// bf16, causal) the bytes are 134 MB (0.040 ms at 3.35 TB/s) and the flops
// 34 GFLOP (0.035 ms at the bf16 tensor cores' 989 TFLOP/s): both floors
// are close, so the kernel has to read each byte about once and keep the
// tensor cores fed.
//
// bfloat16 (the LM's prefill type): the tensor cores, mma.sync.m16n8k16 with
// bf16 operands and float32 accumulators.  A block of 4 warps owns 64 query
// rows of one (batch, head), 16 rows a warp (8 warps and 128 rows measured
// slower at hd 64 and no faster at hd 128).  The
// query tile is copied to shared memory once and each warp keeps its A
// fragments in registers (ldmatrix; re-read from shared memory per key tile
// at padded head dims above 128, where the output accumulators need the
// registers).  Key and value tiles of 64 keys (32 at padded head dims above
// 128) stream through two shared-memory buffers with 16-byte cp.async: the
// copy of tile j + 1 runs while tile j is computed, so each k/v byte is read
// from device memory (or L2) once per query tile.  Shared rows are padded by
// 8 elements (16 bytes), so the 8 row addresses of each ldmatrix hit 8
// distinct 4-bank groups.  Head dims are padded with zeros to 16, 32, 64,
// 96, 128, 192 or 256 in shared memory: zeros add nothing to q . k, and the
// padded output columns are never stored.  S = Q K^T: ldmatrix of K rows
// gives the B fragments directly; a bf16 x bf16 product is exact in float32,
// so this is JAX's float32 dot summed in another order, and the scale is
// applied in float32 after it.  The row max and sum reduce over the 4 lanes
// of a quad (each lane holds 2 of every 8 keys of rows g and g + 8); exp is
// __expf (ex2.approx, a few float32 ulp), far inside a bf16 step.  PV: p
// stays float32, split as p = p_hi + p_lo, both bf16, and two MMAs add
// p_hi v and p_lo v into the float32 accumulator (v is bf16, so each product
// is exact); what the split drops is below 2^-16 of p.  The S accumulator
// fragments re-pack as PV's A fragments without shuffles, and V's B
// fragments come from ldmatrix.trans.  Causal: key tiles strictly above the
// block's last row are never loaded, a warp skips the tiles strictly above
// its own rows (all their p are exactly 0), and the diagonal tile is masked
// per element (other tiles skip the mask).  Blocks are ordered longest
// causal row first.  Inputs whose rows or strides are not 16-byte aligned
// (or hd % 8 != 0) take per-element loads into the same tiles.
//
// float32: bf16 tensor cores cannot hold float32's 2e-5 bound, so float32
// keeps the CUDA-core body (a dispatch on type): one block of 8 warps per
// 64-row query tile, each warp owning 8 rows with the head dims over the
// lanes; q and each k/v tile staged in shared memory as float32 (the key
// tile with an odd row stride); scores, max, sum and p v as float32 FMAs.
// Shared-memory bandwidth, not device memory, sets its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kRowsPerTile = 64;   // query rows per block, both bodies

// Everything a launch needs; strides in elements, indexed [batch, head, seq].
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];
  int heads, bh, seq_q, seq_kv, hd, causal, n_qtiles, vec;
  float scale;
};

// The (batch, head) and query tile of this block: tiles with the longest
// causal rows first, all (batch, head)s of a tile together.
__device__ __forceinline__ void block_coords(const FlashArgs& a, int& b,
                                             int& h, int& qt) {
  const int bh = blockIdx.x % a.bh;
  qt = a.n_qtiles - 1 - blockIdx.x / a.bh;
  b = bh / a.heads;
  h = bh - b * a.heads;
}

template <typename T>
__device__ __forceinline__ const T* at(const void* p, const long long* s,
                                       int b, int h) {
  return static_cast<const T*>(p) + b * s[0] + h * s[1];
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) = hi + lo with hi = bf16(x), lo = bf16(x - hi); x0 in the low half.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [r0, r0 + kRows) of a [n_rows, hd] operand (row stride ss) into a
// shared tile [kRows][kHd + 8], zeros past n_rows and past hd.
template <int kRows, int kHd, int kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ss, int r0, int n_rows,
                                          int hd, bool vec) {
  constexpr int kLd = kHd + 8;
  constexpr int kChunks = kHd / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int d0 = (i - r * kChunks) * 8;
    bf16* d = dst + r * kLd + d0;
    const bool row_ok = r0 + r < n_rows;
    const bf16* s = src + (r0 + r) * ss + d0;
    if (vec) {
      const bool ok = row_ok && d0 < hd;
      cp_async16(d, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = row_ok && d0 + e < hd ? s[e] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void store_pair(bf16* p, int col, int hd, float x0,
                                           float x1, bool vec) {
  if (col >= hd) return;
  if (vec) {  // col even, hd % 8 == 0: a 4-byte aligned pair
    *reinterpret_cast<__nv_bfloat162*>(p + col) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[col] = __float2bfloat16(x0);
    if (col + 1 < hd) p[col + 1] = __float2bfloat16(x1);
  }
}

constexpr int kWarpsTc = kRowsPerTile / 16;  // 16 query rows a warp
constexpr int kThreadsTc = 32 * kWarpsTc;

template <int kHd, int kBlockN>
__host__ __device__ constexpr int tc_smem_bytes() {
  return (kRowsPerTile + 4 * kBlockN) * (kHd + 8) * 2;
}

template <int kHd, int kBlockN>
__global__ void __launch_bounds__(kThreadsTc)
flash_fwd_bf16_kernel(const FlashArgs a) {
  constexpr int kThreads = kThreadsTc;
  constexpr int kBlockM = kRowsPerTile;
  constexpr int kLd = kHd + 8;          // shared row stride, elements
  constexpr int kKSteps = kHd / 16;     // k-steps of Q K^T
  constexpr int kNT = kBlockN / 8;      // 8-key column tiles of S
  constexpr int kDT = kHd / 8;          // 8-dim column tiles of O
  constexpr bool kQRegs = kHd <= 128;   // Q's A fragments live in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kBlockM][kLd]
  bf16* ks = qs + kBlockM * kLd;                 // [2][kBlockN][kLd]
  bf16* vs = ks + 2 * kBlockN * kLd;             // [2][kBlockN][kLd]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // this lane's rows g and g + 8 of the warp's 16
  const int tig = lane & 3; // and its columns 2 tig, 2 tig + 1 of every 8
  int b, h, qt;
  block_coords(a, b, h, qt);
  const bf16* qp = at<bf16>(a.q, a.qs, b, h);
  const bf16* kp = at<bf16>(a.k, a.ks, b, h);
  const bf16* vp = at<bf16>(a.v, a.vs, b, h);
  bf16* op = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];
  const bool vec = a.vec != 0;
  const int q0 = qt * kBlockM;
  const int q_rows = min(kBlockM, a.seq_q - q0);
  // causal: keys past the block's last query row are masked for every row
  const int kv_end = a.causal ? min(a.seq_kv, q0 + q_rows) : a.seq_kv;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  load_tile<kBlockM, kHd, kThreads>(qs, qp, a.qs[2], q0, a.seq_q, a.hd, vec);
  load_tile<kBlockN, kHd, kThreads>(ks, kp, a.ks[2], 0, a.seq_kv, a.hd, vec);
  load_tile<kBlockN, kHd, kThreads>(vs, vp, a.vs[2], 0, a.seq_kv, a.hd, vec);
  cp_async_commit();

  const int row0 = warp * 16;              // the warp's rows in the tile
  const int qpos0 = q0 + row0 + g;         // this lane's two query rows
  const int qpos1 = qpos0 + 8;
  const int warp_last = q0 + row0 + 15;
  // ldmatrix addresses: lane l serves row l % 8 of 8x8 matrix l / 8
  const int lm_row = lane & 7;
  const int lm_hi = (lane >> 3) & 1;       // matrices 1 and 3
  const int lm_top = lane >> 4;            // matrices 2 and 3
  const bf16* q_frag = qs + (row0 + lm_hi * 8 + lm_row) * kLd + lm_top * 8;

  uint32_t qf[kQRegs ? kKSteps : 1][4];
  float o_acc[kDT][4];
#pragma unroll
  for (int t = 0; t < kDT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) o_acc[t][c] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {  // the next tile's copy overlaps this tile
      const int nb = (buf ^ 1) * kBlockN * kLd;
      load_tile<kBlockN, kHd, kThreads>(ks + nb, kp, a.ks[2], (j + 1) * kBlockN,
                                        a.seq_kv, a.hd, vec);
      load_tile<kBlockN, kHd, kThreads>(vs + nb, vp, a.vs[2], (j + 1) * kBlockN,
                                        a.seq_kv, a.hd, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and at j = 0 the query tile) is in place
    if (kQRegs && j == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? kKSteps : 0); ++kk)
        ldmatrix_x4(qf[kk], q_frag + kk * 16);
    }
    const int k0 = j * kBlockN;
    if (!a.causal || k0 <= warp_last) {
      const bf16* kb = ks + buf * kBlockN * kLd;
      const bf16* vb = vs + buf * kBlockN * kLd;
      float s[kNT][4];
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[t][c] = 0.f;
      // S = Q K^T: matrices (keys +0, dims +0), (+0, +8), (+8, +0), (+8, +8)
      const bf16* k_frag = kb + (lm_top * 8 + lm_row) * kLd + lm_hi * 8;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t af[4];
        if (kQRegs) {
#pragma unroll
          for (int c = 0; c < 4; ++c) af[c] = qf[kQRegs ? kk : 0][c];
        } else {
          ldmatrix_x4(af, q_frag + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bfr[4];
          ldmatrix_x4(bfr, k_frag + np * 16 * kLd + kk * 16);
          mma_bf16(s[2 * np], af, bfr[0], bfr[1]);
          mma_bf16(s[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
      // scale, mask before the row max (only tiles that reach past the
      // sequence or past the warp's first row need it), online softmax
      const bool masked = k0 + kBlockN > a.seq_kv ||
                          (a.causal && k0 + kBlockN - 1 > q0 + row0);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[t][c] * a.scale;
          if (masked) {
            const int key = k0 + t * 8 + 2 * tig + (c & 1);
            if (key >= a.seq_kv) {
              x = -INFINITY;  // no such key: contributes exactly nothing
            } else if (a.causal && key > (c < 2 ? qpos0 : qpos1)) {
              x = kMasked;
            }
          }
          s[t][c] = x;
          if (c < 2) {
            mx0 = fmaxf(mx0, x);
          } else {
            mx1 = fmaxf(mx1, x);
          }
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float corr0 = __expf(m0 - mn0);
      const float corr1 = __expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        s[t][0] = __expf(s[t][0] - mn0);
        s[t][1] = __expf(s[t][1] - mn0);
        s[t][2] = __expf(s[t][2] - mn1);
        s[t][3] = __expf(s[t][3] - mn1);
        ps0 += s[t][0] + s[t][1];
        ps1 += s[t][2] + s[t][3];
      }
      l0 = l0 * corr0 + ps0;  // this lane's share; the quad sums at the end
      l1 = l1 * corr1 + ps1;
#pragma unroll
      for (int t = 0; t < kDT; ++t) {
        o_acc[t][0] *= corr0;
        o_acc[t][1] *= corr0;
        o_acc[t][2] *= corr1;
        o_acc[t][3] *= corr1;
      }
      // O += P V with P = P_hi + P_lo; matrices (keys +0, dims +0),
      // (+8, +0), (+0, +8), (+8, +8), transposed
      const bf16* v_frag = vb + (lm_hi * 8 + lm_row) * kLd + lm_top * 8;
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc) {
        uint32_t ahi[4], alo[4];
        split_bf16(s[2 * kc][0], s[2 * kc][1], ahi[0], alo[0]);
        split_bf16(s[2 * kc][2], s[2 * kc][3], ahi[1], alo[1]);
        split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], ahi[2], alo[2]);
        split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], ahi[3], alo[3]);
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          uint32_t bfr[4];
          ldmatrix_x4_trans(bfr, v_frag + kc * 16 * kLd + dp * 16);
          mma_bf16(o_acc[2 * dp], ahi, bfr[0], bfr[1]);
          mma_bf16(o_acc[2 * dp], alo, bfr[0], bfr[1]);
          mma_bf16(o_acc[2 * dp + 1], ahi, bfr[2], bfr[3]);
          mma_bf16(o_acc[2 * dp + 1], alo, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it refills
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f);
  const float d1 = fmaxf(quad_sum(l1), 1e-30f);
  bf16* out0 = op + qpos0 * a.os[2];
  bf16* out1 = op + qpos1 * a.os[2];
#pragma unroll
  for (int t = 0; t < kDT; ++t) {
    const int col = t * 8 + 2 * tig;
    if (qpos0 < a.seq_q)
      store_pair(out0, col, a.hd, o_acc[t][0] / d0, o_acc[t][1] / d0, vec);
    if (qpos1 < a.seq_q)
      store_pair(out1, col, a.hd, o_acc[t][2] / d1, o_acc[t][3] / d1, vec);
  }
}

template <int kHd, int kBlockN>
int launch_bf16(const FlashArgs& a, cudaStream_t stream) {
  auto kernel = flash_fwd_bf16_kernel<kHd, kBlockN>;
  constexpr int smem = tc_smem_bytes<kHd, kBlockN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.n_qtiles * a.bh, kThreadsTc, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Padded head dims 16, 32, 64, 96, 128 (64-key tiles) and 192, 256 (32).
int dispatch_bf16(const FlashArgs& a, cudaStream_t stream) {
  if (a.hd <= 16) return launch_bf16<16, 64>(a, stream);
  if (a.hd <= 32) return launch_bf16<32, 64>(a, stream);
  if (a.hd <= 64) return launch_bf16<64, 64>(a, stream);
  if (a.hd <= 96) return launch_bf16<96, 64>(a, stream);
  if (a.hd <= 128) return launch_bf16<128, 64>(a, stream);
  if (a.hd <= 192) return launch_bf16<192, 32>(a, stream);
  return launch_bf16<256, 32>(a, stream);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarpsF32 = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kThreadsF32 = 32 * kWarpsF32;
static_assert(kWarpsF32 * kRowsPerWarp == kRowsPerTile, "64-row query tiles");

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared floats of one block: the query tile, the key tile (odd row
// stride), the value tile and the per-warp p buffers.
__host__ __device__ inline int smem_floats(int hd, int block_k) {
  return kRowsPerTile * hd + block_k * (hd | 1) + block_k * hd +
         kWarpsF32 * kRowsPerWarp * block_k;
}

// kSlots = ceil(hd / 32) head dims per lane; kKeys keys per lane in a tile.
template <int kSlots, int kKeys>
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32_kernel(const FlashArgs a) {
  constexpr int kBlockK = 32 * kKeys;
  extern __shared__ float smem[];
  const int hd = a.hd;
  const int ks = hd | 1;
  float* qs = smem;                   // [kRowsPerTile][hd]
  float* kt = qs + kRowsPerTile * hd; // [kBlockK][ks]
  float* vt = kt + kBlockK * ks;      // [kBlockK][hd]
  float* pb = vt + kBlockK * hd;      // [kWarpsF32][kRowsPerWarp][kBlockK]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int b, h, qt;
  block_coords(a, b, h, qt);
  const float* qp = at<float>(a.q, a.qs, b, h);
  const float* kp = at<float>(a.k, a.ks, b, h);
  const float* vp = at<float>(a.v, a.vs, b, h);
  float* op = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];
  const int q0 = qt * kRowsPerTile;
  const int q_rows = min(kRowsPerTile, a.seq_q - q0);
  const int row0 = warp * kRowsPerWarp;  // this warp's rows in the tile
  float* pw = pb + warp * kRowsPerWarp * kBlockK;

  for (int i = threadIdx.x; i < kRowsPerTile * hd; i += kThreadsF32) {
    const int r = i / hd;
    qs[i] = r < q_rows ? qp[(q0 + r) * a.qs[2] + (i - r * hd)] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kSlots];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < kSlots; ++t) acc[r][t] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = a.causal ? min(a.seq_kv, q0 + q_rows) : a.seq_kv;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    const int k_rows = min(kBlockK, a.seq_kv - k0);
    __syncthreads();  // the last tile's readers are done; Q is in place
    for (int i = threadIdx.x; i < kBlockK * hd; i += kThreadsF32) {
      const int j = i / hd;
      const int d = i - j * hd;
      float kv = 0.f, vv = 0.f;
      if (j < k_rows) {
        kv = kp[(k0 + j) * a.ks[2] + d];
        vv = vp[(k0 + j) * a.vs[2] + d];
      }
      kt[j * ks + d] = kv;
      vt[i] = vv;
    }
    __syncthreads();

    float s[kRowsPerWarp][kKeys];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int c = 0; c < kKeys; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float kd[kKeys];
#pragma unroll
      for (int c = 0; c < kKeys; ++c) kd[c] = kt[(lane + 32 * c) * ks + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qd = qs[(row0 + r) * hd + d];
#pragma unroll
        for (int c = 0; c < kKeys; ++c) s[r][c] = fmaf(qd, kd[c], s[r][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int q_pos = q0 + row0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const int key = k0 + lane + 32 * c;
        float x;
        if (key >= a.seq_kv) {
          x = -INFINITY;  // no such key: contributes exactly nothing
        } else if (a.causal && key > q_pos) {
          x = kMasked;
        } else {
          x = s[r][c] * a.scale;
        }
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kKeys; ++c) {
        const float p = expf(s[r][c] - m_new);
        pw[r * kBlockK + lane + 32 * c] = p;
        psum += p;
      }
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < kSlots; ++t) acc[r][t] *= corr;
    }
    __syncwarp();
    for (int j = 0; j < k_rows; ++j) {
      float vj[kSlots];
#pragma unroll
      for (int t = 0; t < kSlots; ++t) {
        const int d = lane + 32 * t;
        vj[t] = d < hd ? vt[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pw[r * kBlockK + j];
#pragma unroll
        for (int t = 0; t < kSlots; ++t) acc[r][t] = fmaf(p, vj[t], acc[r][t]);
      }
    }
    __syncwarp();  // p is read before the next tile overwrites it
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int q_pos = q0 + row0 + r;
    if (q_pos >= a.seq_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* out = op + q_pos * a.os[2];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) out[d] = acc[r][t] / denom;
    }
  }
}

template <int kSlots>
int launch_f32(const FlashArgs& a, cudaStream_t stream) {
  constexpr int kKeys = kSlots <= 2 ? 2 : 1;
  auto kernel = flash_fwd_f32_kernel<kSlots, kKeys>;
  const size_t smem = sizeof(float) * smem_floats(a.hd, 32 * kKeys);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.n_qtiles * a.bh, kThreadsF32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const FlashArgs& a, cudaStream_t stream) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch_f32<1>(a, stream);
    case 2: return launch_f32<2>(a, stream);
    case 3: return launch_f32<3>(a, stream);
    case 4: return launch_f32<4>(a, stream);
    case 5: return launch_f32<5>(a, stream);
    case 6: return launch_f32<6>(a, stream);
    case 7: return launch_f32<7>(a, stream);
    case 8: return launch_f32<8>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  q, k, v, o are device pointers
// to [b, heads, seq, hd] tensors with the last dim contiguous; strides holds
// the batch, head and sequence strides (elements) of q, k, v and o in that
// order (12 values).  All float32 (bf16 = 0) or all bfloat16 (bf16 = 1).
// Returns cudaErrorInvalidValue unless b, heads, seq_q, seq_kv > 0,
// 1 <= hd <= 256 and the grid, ceil(seq_q / 64) * b * heads blocks, is below
// 2^31 (the caller keeps b * heads an int); else cudaGetLastError() after
// the launch (or the error of raising the kernel's shared-memory limit).
// scale > 0 multiplies the scores; scale <= 0 takes 1/sqrt(hd).
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int b,
                                     int heads, int seq_q, int seq_kv, int hd,
                                     int causal, int bf16, float scale,
                                     void* stream) {
  if (hd < 1 || hd > 256 || b < 1 || heads < 1 || seq_q < 1 || seq_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.heads = heads;
  a.bh = b * heads;
  a.seq_q = seq_q;
  a.seq_kv = seq_kv;
  a.hd = hd;
  a.causal = causal;
  a.n_qtiles = (seq_q + kRowsPerTile - 1) / kRowsPerTile;
  a.scale = scale > 0.f
                ? scale
                : static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  bool vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
             aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 8 == 0;
  a.vec = vec;
  if (static_cast<long long>(a.n_qtiles) * a.bh >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bf16(a, s) : dispatch_f32(a, s);
}
