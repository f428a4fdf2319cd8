// Flash attention, forward and backward, for Hopper (sm_90a): causal over a
// whole sequence, or over one chunk pair of the zigzag ring, causal or not.
//
// Replaces the JAX package's TPU kernels in dtc_tpu/ops/flash_attention.py:
// _fwd_kernel_packed (forward, whole KV in one tile) and _bwd_kernel_packed
// (fused single-tile backward); it walks KV tiles at any T, so it also covers
// what _fwd_kernel_packed_multi and _bwd_kernel_packed_multi compute, and its
// backward is the same split as _dq_kernel_packed / _dkv_kernel_packed (the
// TPU's backward past T 4096, where full-T dk/dv scratches outgrow VMEM;
// here shared memory is O(tile) at every T). The transpose-layout family
// (_fwd_kernel_single, _fwd_kernel, _bwd_kernel_single, _dq_kernel,
// _dkv_kernel) computes the same function on (B, H, T, D) tensors for head
// dims and head counts the TPU's 128-lane groups do not fit; these kernels
// take the packed layout at any H and every head dim that is a multiple of 16
// up to 128, so they replace that family too. With causal = 0 and float32
// gradients the same kernels are the zigzag ring's block kernels,
// _block_fwd_kernel and _block_bwd_kernel (rows 15-16 of PERF.md's table):
// attention over one (tc x tc) chunk pair, the diagonal pair causal and every
// other pair not; the backward takes the ring's merged lse and out (delta =
// rowsum(dO * O) from them, in the dq kernel) and writes float32 dq, dk, dv
// whatever the inputs' dtype.
//
// Layout: q, k, v, out, dout are packed (B, T, H*D) in one dtype (float32 or
// bfloat16); dq, dk, dv are packed in that dtype or float32; lse and delta
// are (B, H, T) float32.
//
// What it computes, per (batch row, head), with the TPU kernels' rounding
// points: q is scaled by D^-0.5 in q's dtype (the scale itself rounded to that
// dtype); scores are float32; keys past T never count, and with causal = 1
// the mask keeps key <= query; p is cast to v's dtype before the float32 P*V
// sum, out = acc / l in q's dtype, lse = m + log(l). The backward recomputes
// p = exp(s - lse), delta = rowsum(dO * O) in float32, dp = dO V^T,
// ds = p (dp - delta), dq = (ds in k's dtype) K * scale, dk = (ds in q's
// dtype)^T (q scaled), dv = (p in dO's dtype)^T dO.
//
// Bound. At the flagship (B 8, T 512, H 16, D 32, bfloat16) both directions
// are bound by bytes on paper: the forward must move q, k, v, out and lse,
// 17,039,360 B, 5.09 us at 3.35 TB/s, against 2.15 GFLOP of causal products,
// 2.18 us at the bf16 tensor-core peak; the backward 33,816,576 B (10.1 us)
// against 5.38 GFLOP (5.44 us). The work grows with T^2 and the bytes with T,
// so at long context (B 2, T 8192) both directions are bound by operations:
// 137 GFLOP forward (0.139 ms), 344 GFLOP backward (0.347 ms); at D 32 the
// forward's 1.07 G exponentials of the causal score matrix (16 a clock an SM
// on the special-function units, ~0.3 ms) weigh more than its products.
// The dq kernel alone moves q, k, v, out, dO and lse in, dq and delta out,
// and does three of the backward's five products (S, dP, dS K): 25,690,112
// B (7.67 us) against 3.23 GFLOP (3.26 us) at the flagship, bound by bytes;
// 206 GFLOP (0.208 ms) against 103 MB (0.031 ms) at T 8192, bound by
// operations, with its 1.07 G exponentials ~0.3 ms on the SFUs.
//
// The source builds two libraries (ops/_build.py), so that their instances
// compile at once:
//
// DTC_FLASH_TC 0 ("flash_attention"): CUDA cores, float32: the forward,
// the dq kernel and the dk/dv kernel. One block of 128 threads per
// (64-row tile, head, batch row); blocks never share an output element, so
// there are no atomics and two runs give the same bits. The forward takes two
// passes over the KV tiles up to the diagonal (tiles above it are skipped;
// without the causal mask, over every tile, the last one's keys past T
// masked): the first finds each row's max and sum, the second forms p against
// the row's final max. The backward is the FA2 split: a dq kernel (one block
// per q tile, walking KV tiles up to the diagonal) that also writes delta for
// its rows, then a dk/dv kernel (one block per KV tile, walking q tiles from
// the diagonal on, or all of them) that reads it. Tiles are staged in shared
// memory as float32 with one column of padding; each thread owns a 4 x 8
// piece of the 64 x 64 score tile (rows tr + 16 i, columns tc + 8 j) and the
// matching 4 x D/8 piece of the output tile, and every product is a plain
// float32 FMA loop over shared memory (TF32 would break the float32 limit of
// 1e-5). The largest, the dk/dv kernel at D 128, takes 165,376 B of shared
// memory.
//
// DTC_FLASH_TC 1 ("flash_attention_tc"): tensor cores, bfloat16. The
// forward, the dq kernel and the dk/dv kernel (the two backward kernels
// with bf16 or float32 gradients). A block is one consumer
// warpgroup (128 threads) and one producer warp. One thread of the producer
// issues TMA loads (cp.async.bulk.tensor, 3-D tensor maps over (B, T, H*D)
// encoded on the host for each launch; rows past T arrive as zeros) into a
// ring of 2-4 shared-memory stages, each with a "full" and an "empty"
// mbarrier; the consumer runs every product as wgmma m64nNk16 with float32
// accumulators in registers. A 64 x D tile lies in shared memory as D / W
// boxes of 64 rows of W bf16, W the widest swizzle atom that divides D (64
// at 128B: D 64, 128; 32 at 64B: D 32, 96; 16 at 32B: D 16, 48, 80, 112),
// each row swizzled as TMA writes it. The same tile serves wgmma as a K-major
// operand (D the contraction: a descriptor a 16-wide slice, inside one box)
// and as an MN-major one (the tile's rows the contraction: a descriptor a
// box of W columns and 16 rows, read transposed by wgmma), so nothing is
// copied or transposed. q is scaled in place in shared memory after its load
// (elementwise, so the swizzle does not matter), then fenced for the async
// proxy. Every exponential is 2^(x log2 e): one multiply-add and one ex2 on
// the special-function unit (with expf's range reduction the forward took a
// third longer at T 8192, the dk/dv kernel a quarter); the argument's rounding
// moves p by ~1e-6 of itself, far under a bf16 ulp.
// - Forward: a block per (64-row q tile, head, batch row), the longest rows
//   first. S = Q K^T (A = Q, B = K, both K-major), then a one-pass softmax with
//   an online rescale, as _fwd_kernel_packed_multi (rows 6 and 11) does past
//   one tile: m and the thread's share of l in registers, acc *= exp(m_old -
//   m_new), p = exp(s - m_new) summed unrounded into l and rounded to bf16 for
//   O += P V, where P is the float32 S fragment packed to the bf16 A fragment
//   in registers and V is the MN-major B. Tiles above the diagonal are
//   skipped; only the diagonal tile (causal) or the last one past T (not
//   causal) is masked. The products of the next tile's S are issued before the
//   last P V has finished.
// - dk/dv: a block per 64-key tile, walking q tiles from the diagonal on (all
//   of them without the causal mask). K and V load once; each stage holds Q,
//   dO and the q rows' lse and delta. The producer warp keeps S - 1 stages'
//   loads in flight and hands a stage over only once its 32 lanes have scaled
//   its q in place and stored its rows' lse (times log2 e) and delta, so the
//   consumer's loop holds no scaling and no barrier of its own (scaling in the
//   consumer's loop, with lse and delta read a float at a time, cost 15% at T
//   8192). S^T = K Q_s^T and dP^T = V dO^T (A = K or V, B = Q or dO, all
//   K-major), P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) in
//   registers, then dV += P^T dO and dK += dS^T Q_s with P^T and dS^T as bf16
//   A fragments and the same staged dO and Q tiles read MN-major. dK and dV
//   are written once from the float32 accumulators. No atomics: two runs give
//   the same bits.
// - dq: a block per (64-row q tile, head, batch row), the longest rows first,
//   walking KV tiles up to the diagonal (all of them without the causal
//   mask), launched before the dk/dv kernel, which reads the delta it writes.
//   The producer loads Q, dO and O once, then keeps K and V stages in flight
//   as the forward's does. The consumer scales q in place and forms its rows'
//   delta = rowsum(dO * O) from the staged dO and O tiles (two threads a row,
//   a chunk of 8 bf16 at a time; equal offsets of two tiles with one swizzle
//   hold equal elements), writes it out and keeps its two rows' delta and lse
//   (times log2 e) in registers. Each stage: S = Q_s K^T and dP = dO V^T (all
//   K-major), P = exp(S - lse) masked on the diagonal tile (or the last tile
//   past T: there K and V are zeros but p is not), dS = P (dP - delta) in
//   registers, then dQ += dS K with dS as bf16 A fragments (k's dtype) and
//   the same staged K tile read MN-major. dQ is scaled by D^-0.5 in float32
//   and written once. No atomics (a fused backward summing dq over key tiles
//   with atomics would give other bits run to run): two runs give the same
//   bits.
// A mbarrier wait that never completes traps (an error the launch's caller
// sees) instead of holding the card. The caller's plan (ops/flash_attention.py
// flash_plan) names the swizzle, box count and stage count, and a launch
// whose plan differs from the instance's geometry is refused.
//
// Plain C interface (ctypes): each entry point launches on the given stream,
// never synchronises, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape, plan or operand it does not take).

#ifndef DTC_FLASH_TC
#define DTC_FLASH_TC 0
#endif

#if DTC_FLASH_TC
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#endif
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Raise a kernel's dynamic shared-memory cap once per device, at its first
// launch there (a CUDA graph capture then records launches only). ``done``
// belongs to the calling launcher instance: kernels of different head dims
// share one function type, so a flag here would be shared between them.
template <typename K>
cudaError_t allow_smem(K* kern, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ((done >> dev) & 1ull)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

bool bad_shape(int B, int n, int H) { return B < 1 || n < 1 || H < 1 || H > 65535 || B > 65535; }

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key rows per tile

inline dim3 grid(int B, int n, int H) { return dim3((n + kBQ - 1) / kBQ, H, B); }

#if !DTC_FLASH_TC

constexpr int kThreads = 128;
constexpr int kPS = kBK + 1;  // padded row stride of the score tiles

// The kernels keep the dtype-generic rounding points of the TPU kernels;
// only float32 has instances here (bfloat16 takes the tensor-core library).
template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// Round to T and back (identity for float32).
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// acc[i][j] += sum_k A(r0 + 16 i, k) * B(k, c0 + 8 j), with
// A(r, k) = A[r * A_RS + k * A_KS] and B(k, c) = B[k * B_KS + c * B_CS].
template <int NI, int NJ, int KD, int A_RS, int A_KS, int B_KS, int B_CS>
__device__ __forceinline__ void tile_mma(float (&acc)[NI][NJ], const float* A,
                                         const float* Bm, int r0, int c0) {
#pragma unroll 4
  for (int kk = 0; kk < KD; ++kk) {
    float a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = A[(r0 + 16 * i) * A_RS + kk * A_KS];
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = Bm[kk * B_KS + (c0 + 8 * j) * B_CS];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Stage rows [row0, row0 + ROWS) of one head of a packed (T, H*D) tensor into
// shared memory as float32 (row stride D + 1), zero past T. With SCALE the
// values are q scaled in q's dtype: round_t(x * mul).
template <typename T, int D, int ROWS, bool SCALE>
__device__ __forceinline__ void load_tile(float* s, const T* g, int HD, int row0,
                                          int n_rows, float mul) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int t = row0 + r;
    float x = 0.f;
    if (t < n_rows) {
      x = to_f<T>(g[static_cast<size_t>(t) * HD + d]);
      if (SCALE) x = round_t<T>(x * mul);
    }
    s[r * (D + 1) + d] = x;
  }
}

// Does query row `row` see key `key`? With `causal`, the keys <= row (for a
// row < n these are all < n; rows past n are never written); without it,
// every key short of the zero-filled rest of the last tile (key < n).
__device__ __forceinline__ bool visible(int key, int row, int n, int causal) {
  return causal ? key <= row : key < n;
}

// Sum over the 8 threads that share a score row (consecutive lanes).
__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}
__device__ __forceinline__ float row_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return v;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                 int n, int H, float scale_q, int causal) {
  constexpr int DS = D + 1;
  constexpr int NJ = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DS;
  float* sV = sK + kBK * DS;
  float* sP = sV + kBK * DS;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows start first
  const int kt_last = causal ? qt : gridDim.x - 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = static_cast<size_t>(b) * n * HD + static_cast<size_t>(h) * D;
  const int q0 = qt * kBQ;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;

  load_tile<T, D, kBQ, true>(sQ, q + base, HD, q0, n, scale_q);

  // Pass 1: each row's max and sum of exp over the visible keys.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int kt = 0; kt <= kt_last; ++kt) {
    __syncthreads();
    load_tile<T, D, kBK, false>(sK, k + base, HD, kt * kBK, n, 0.f);
    __syncthreads();
    float s[4][8] = {};
    tile_mma<4, 8, D, DS, 1, 1, DS>(s, sQ, sK, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (visible(kt * kBK + tc + 8 * j, row, n, causal)) tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max8(tmax));
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (visible(kt * kBK + tc + 8 * j, row, n, causal)) part += expf(s[i][j] - m_new);
      }
      l[i] = l[i] * expf(m[i] - m_new) + row_sum8(part);
      m[i] = m_new;
    }
  }

  // Pass 2: p against the row's final max, rounded to v's dtype, times V.
  float o[4][NJ] = {};
  for (int kt = 0; kt <= kt_last; ++kt) {
    __syncthreads();
    load_tile<T, D, kBK, false>(sK, k + base, HD, kt * kBK, n, 0.f);
    load_tile<T, D, kBK, false>(sV, v + base, HD, kt * kBK, n, 0.f);
    __syncthreads();
    float s[4][8] = {};
    tile_mma<4, 8, D, DS, 1, 1, DS>(s, sQ, sK, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 8 * j;
        const float p = visible(kt * kBK + c, q0 + r, n, causal) ? expf(s[i][j] - m[i]) : 0.f;
        sP[r * kPS + c] = round_t<T>(p);
      }
    }
    __syncthreads();
    tile_mma<4, NJ, kBK, kPS, 1, DS, 1>(o, sP, sV, tr, tc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= n) continue;
    const float inv = 1.f / l[i];
    T* orow = out + base + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tc + 8 * j] = from_f<T>(o[i][j] * inv);
    if (tc == 0) lse[(static_cast<size_t>(b) * H + h) * n + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward: dq (+ delta), then dk/dv
// ---------------------------------------------------------------------------

// TG: the gradients' type, T or (for the ring's blocks) float32.
template <typename T, typename TG, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, TG* __restrict__ dq, int n, int H,
                    float scale_q, float scale, int causal) {
  constexpr int DS = D + 1;
  constexpr int NJ = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kBQ * DS;
  float* sK = sDO + kBQ * DS;
  float* sV = sK + kBK * DS;
  float* sS = sV + kBK * DS;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = static_cast<size_t>(b) * n * HD + static_cast<size_t>(h) * D;
  const size_t sbase = (static_cast<size_t>(b) * H + h) * n;
  const int q0 = qt * kBQ;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;

  load_tile<T, D, kBQ, true>(sQ, q + base, HD, q0, n, scale_q);
  load_tile<T, D, kBQ, false>(sDO, dout + base, HD, q0, n, 0.f);
  __syncthreads();

  // delta = rowsum(dO * O) for this tile's rows, kept here and written out
  // for the dk/dv kernel.
  float dl[4], ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i, row = q0 + r;
    float part = 0.f;
    if (row < n) {
      const T* orow = out + base + static_cast<size_t>(row) * HD;
#pragma unroll
      for (int j = 0; j < NJ; ++j) part += sDO[r * DS + tc + 8 * j] * to_f<T>(orow[tc + 8 * j]);
    }
    dl[i] = row_sum8(part);
    ls[i] = row < n ? lse[sbase + row] : 0.f;
    if (row < n && tc == 0) delta[sbase + row] = dl[i];
  }

  float acc[4][NJ] = {};
  const int kt_last = causal ? qt : gridDim.x - 1;
  for (int kt = 0; kt <= kt_last; ++kt) {
    __syncthreads();
    load_tile<T, D, kBK, false>(sK, k + base, HD, kt * kBK, n, 0.f);
    load_tile<T, D, kBK, false>(sV, v + base, HD, kt * kBK, n, 0.f);
    __syncthreads();
    float s[4][8] = {}, dp[4][8] = {};
    tile_mma<4, 8, D, DS, 1, 1, DS>(s, sQ, sK, tr, tc);
    tile_mma<4, 8, D, DS, 1, 1, DS>(dp, sDO, sV, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 8 * j;
        const bool valid = row < n && visible(kt * kBK + c, row, n, causal);
        const float p = valid ? expf(s[i][j] - ls[i]) : 0.f;
        sS[r * kPS + c] = round_t<T>(p * (dp[i][j] - dl[i]));  // ds in k's dtype
      }
    }
    __syncthreads();
    tile_mma<4, NJ, kBK, kPS, 1, DS, 1>(acc, sS, sK, tr, tc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= n) continue;
    TG* drow = dq + base + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) drow[tc + 8 * j] = from_f<TG>(acc[i][j] * scale);
  }
}

template <typename T, typename TG, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     TG* __restrict__ dk, TG* __restrict__ dv, int n, int H, float scale_q,
                     int causal) {
  constexpr int DS = D + 1;
  constexpr int NJ = D / 8;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBK * DS;
  float* sQ = sV + kBK * DS;
  float* sDO = sQ + kBQ * DS;
  float* sP = sDO + kBQ * DS;
  float* sS = sP + kBQ * kPS;

  const int kt = blockIdx.x;
  const int nq = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int HD = H * D;
  const size_t base = static_cast<size_t>(b) * n * HD + static_cast<size_t>(h) * D;
  const size_t sbase = (static_cast<size_t>(b) * H + h) * n;
  const int k0 = kt * kBK;
  const int tr = threadIdx.x >> 3, tc = threadIdx.x & 7;

  load_tile<T, D, kBK, false>(sK, k + base, HD, k0, n, 0.f);
  load_tile<T, D, kBK, false>(sV, v + base, HD, k0, n, 0.f);

  float dk_acc[4][NJ] = {}, dv_acc[4][NJ] = {};
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_tile<T, D, kBQ, true>(sQ, q + base, HD, q0, n, scale_q);
    load_tile<T, D, kBQ, false>(sDO, dout + base, HD, q0, n, 0.f);
    __syncthreads();
    float s[4][8] = {}, dp[4][8] = {};
    tile_mma<4, 8, D, DS, 1, 1, DS>(s, sQ, sK, tr, tc);
    tile_mma<4, 8, D, DS, 1, 1, DS>(dp, sDO, sV, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i, row = q0 + r;
      const float ls = row < n ? lse[sbase + row] : 0.f;
      const float dl = row < n ? delta[sbase + row] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tc + 8 * j;
        const bool valid = row < n && visible(k0 + c, row, n, causal);
        const float p = valid ? expf(s[i][j] - ls) : 0.f;
        sP[r * kPS + c] = round_t<T>(p);                      // p in dO's dtype
        sS[r * kPS + c] = round_t<T>(p * (dp[i][j] - dl));    // ds in q's dtype
      }
    }
    __syncthreads();
    // Rows of dk/dv are keys: A(key, qrow) = tile[qrow][key].
    tile_mma<4, NJ, kBQ, 1, kPS, DS, 1>(dk_acc, sS, sQ, tr, tc);
    tile_mma<4, NJ, kBQ, 1, kPS, DS, 1>(dv_acc, sP, sDO, tr, tc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tr + 16 * i;
    if (key >= n) continue;
    TG* krow = dk + base + static_cast<size_t>(key) * HD;
    TG* vrow = dv + base + static_cast<size_t>(key) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      krow[tc + 8 * j] = from_f<TG>(dk_acc[i][j]);
      vrow[tc + 8 * j] = from_f<TG>(dv_acc[i][j]);
    }
  }
}


// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * kPS);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * kPS);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBQ * kPS);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int n, int H, float scale_q, int causal, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, D>;
  static unsigned long long done = 0;  // one bit per device
  cudaError_t e = allow_smem(kern, fwd_smem<D>(), done);
  if (e != cudaSuccess) return e;
  kern<<<grid(B, n, H), kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, n, H, scale_q, causal);
  return cudaGetLastError();
}

template <typename T, typename TG, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, int B, int n,
                   int H, float scale_q, float scale, int causal, cudaStream_t st) {
  auto kern = flash_bwd_dq_kernel<T, TG, D>;
  static unsigned long long done = 0;  // one bit per device
  cudaError_t e = allow_smem(kern, dq_smem<D>(), done);
  if (e != cudaSuccess) return e;
  kern<<<grid(B, n, H), kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), lse, delta,
      static_cast<TG*>(dq), n, H, scale_q, scale, causal);
  return cudaGetLastError();
}

template <typename T, typename TG, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int B, int n,
                    int H, float scale_q, int causal, cudaStream_t st) {
  auto kern = flash_bwd_dkv_kernel<T, TG, D>;
  static unsigned long long done = 0;  // one bit per device
  cudaError_t e = allow_smem(kern, dkv_smem<D>(), done);
  if (e != cudaSuccess) return e;
  kern<<<grid(B, n, H), kThreads, dkv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<TG*>(dk), static_cast<TG*>(dv),
      n, H, scale_q, causal);
  return cudaGetLastError();
}

// The head dims of every instance.
#define DTC_DIMS(CASE, ...)                                              \
  CASE(__VA_ARGS__, 16) CASE(__VA_ARGS__, 32) CASE(__VA_ARGS__, 48)      \
  CASE(__VA_ARGS__, 64) CASE(__VA_ARGS__, 80) CASE(__VA_ARGS__, 96)      \
  CASE(__VA_ARGS__, 112) CASE(__VA_ARGS__, 128)
// (input, gradient) dtype pairs, code dtype * 2 + gdtype (0 float32, 1
// bfloat16): only float32 / float32 (0) has instances here; bfloat16
// inputs, with bf16 or (the ring's blocks) float32 gradients, take the
// tensor-core library.
#define DTC_GCASE(CALL, CODE, ELEM, GELEM, DIM)                     \
  case (CODE) * 1000 + (DIM): {                                    \
    using T = ELEM; using TG = GELEM; constexpr int kD = DIM; return CALL; }

// float32 only: bfloat16 takes the tensor-core library.
cudaError_t fwd_any(const void* q, const void* k, const void* v, void* out, float* lse,
                    int B, int n, int H, int D, float scale_q, int dtype, int causal,
                    cudaStream_t st) {
  switch (dtype * 2 * 1000 + D) {
    DTC_DIMS(DTC_GCASE, (fwd<T, kD>(q, k, v, out, lse, B, n, H, scale_q, causal, st)), 0,
             float, float)
    default: return cudaErrorInvalidValue;
  }
}

// float32 / float32 only: bfloat16 inputs take the tensor-core library.
cudaError_t dq_any(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, int B, int n,
                   int H, int D, float scale_q, float scale, int dtype, int gdtype, int causal,
                   cudaStream_t st) {
  switch ((dtype * 2 + gdtype) * 1000 + D) {
    DTC_DIMS(DTC_GCASE, (bwd_dq<T, TG, kD>(q, k, v, out, dout, lse, delta, dq, B, n, H, scale_q,
                                           scale, causal, st)), 0, float, float)
    default: return cudaErrorInvalidValue;
  }
}

// float32 / float32 only: bfloat16 inputs take the tensor-core library.
cudaError_t dkv_any(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int B, int n,
                    int H, int D, float scale_q, int dtype, int gdtype, int causal,
                    cudaStream_t st) {
  switch ((dtype * 2 + gdtype) * 1000 + D) {
    DTC_DIMS(DTC_GCASE, (bwd_dkv<T, TG, kD>(q, k, v, dout, lse, delta, dk, dv, B, n, H,
                                            scale_q, causal, st)), 0, float, float)
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype / gdtype: 0 float32, 1 bfloat16 (the inputs' and the gradients' types);
// causal: 1 masks key > query, 0 masks only keys past T.
extern "C" int dtc_flash_fwd(const void* q, const void* k, const void* v, void* out,
                             float* lse, int B, int T, int H, int D, float scale_q,
                             int dtype, int causal, void* stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd_any(q, k, v, out, lse, B, T, H, D, scale_q, dtype, causal,
                                  static_cast<cudaStream_t>(stream)));
}

extern "C" int dtc_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* out, const void* dout, const float* lse,
                                float* delta, void* dq, int B, int T, int H, int D,
                                float scale_q, float scale, int dtype, int gdtype,
                                int causal, void* stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dq_any(q, k, v, out, dout, lse, delta, dq, B, T, H, D, scale_q,
                                 scale, dtype, gdtype, causal,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" int dtc_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int B, int T, int H, int D,
                                 float scale_q, int dtype, int gdtype, int causal,
                                 void* stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dkv_any(q, k, v, dout, lse, delta, dk, dv, B, T, H, D, scale_q,
                                  dtype, gdtype, causal, static_cast<cudaStream_t>(stream)));
}

#else  // DTC_FLASH_TC

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128 + 32;  // the consumer warpgroup + the producer warp
// exp(x) = 2^(x log2 e): each exponential one multiply-add and one ex2.
constexpr float kLog2e = 1.4426950408889634f;

// A 64 x D bf16 tile in shared memory: D / kBoxW boxes of 64 rows of kBoxW
// elements (kSwz bytes, the swizzle span), each the image of one TMA box.
template <int D>
struct TcGeo {
  static constexpr int kBoxW = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kSwz = 2 * kBoxW;
  static constexpr int kBoxes = D / kBoxW;
  static constexpr int kBoxBytes = kBQ * kSwz;
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;  // wgmma's code
  // Stages: as many as 64 KB of two-tile stages hold, 2 to 4.
  static constexpr int kStages = 65536 / (2 * kTileBytes) > 4   ? 4
                                 : 65536 / (2 * kTileBytes) < 2 ? 2
                                                                : 65536 / (2 * kTileBytes);
  // Dynamic shared memory (1 KB for alignment): Q + stages of K and V, and
  // the barriers (full, empty, Q).
  static constexpr int kFwdSmem = 1024 + kTileBytes + kStages * 2 * kTileBytes + (2 * 4 + 1) * 8;
  // K, V + stages of Q, dO, lse and delta (64 floats each), and the barriers
  // (landed, full, empty, K/V).
  static constexpr int kDkvStage = 2 * kTileBytes + 2 * kBQ * 4;
  static constexpr int kDkvSmem = 1024 + 2 * kTileBytes + kStages * kDkvStage + (3 * 4 + 1) * 8;
  // Q, dO, O + stages of K and V, the rows' delta and lse (64 floats each),
  // and the barriers (full, empty, Q).
  static constexpr int kDqSmem =
      1024 + 3 * kTileBytes + kStages * 2 * kTileBytes + 2 * kBQ * 4 + (2 * 4 + 1) * 8;
  static_assert(D % 16 == 0 && D <= 128, "head dims: multiples of 16 up to 128");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed. A
// wait that never ends (a load that was never issued) traps, which the
// launch's caller sees as an error, instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

// One 3-D TMA load of the box at (c0 innermost, c1, c2) into dst, completing
// on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row0, row0 + 64) of head h of batch row b: the tile's D / kBoxW boxes.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int h, int row0, int b) {
  using G = TcGeo<D>;
#pragma unroll
  for (int j = 0; j < G::kBoxes; ++j)
    tma_load(dst + j * G::kBoxBytes, map, bar, h * D + j * G::kBoxW, row0, b);
}

// Generic-proxy stores to shared memory made visible to wgmma and TMA (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The consumer warpgroup's own barrier (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving accumulator reads across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The wgmma matrix descriptor of a swizzled operand in shared memory (layout
// 1: 128B, 2: 64B, 3: 32B): start address, and the stride between groups of 8
// rows (K-major: 8 MN rows; MN-major: 8 K rows) in both offset fields, so
// that the leading offset, which the instructions here never cross (a K-major
// slice stays inside one box row, an MN-major instruction inside one box),
// cannot be misread for it.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t stride, uint64_t layout) {
  const uint64_t s = (stride >> 4) & 0x3FFF;
  return ((saddr & 0x3FFFF) >> 4) | (s << 16) | (s << 32) | (layout << 62);
}

// K-major: the 16-wide slice kk of the contraction (D) of a 64-row tile, 32
// bytes along a box row.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  using G = TcGeo<D>;
  const int e = kk * 16;
  return make_desc(tile + (e / G::kBoxW) * G::kBoxBytes + (e % G::kBoxW) * 2, 8 * G::kSwz,
                   G::kLayout);
}

// MN-major: box j (columns j * kBoxW ...) of a 64-row tile whose rows are the
// contraction, rows 16 kk .. 16 kk + 15.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int j, int kk) {
  using G = TcGeo<D>;
  return make_desc(tile + j * G::kBoxBytes + kk * 16 * G::kSwz, 8 * G::kSwz, G::kLayout);
}

// d (64 x 64) = [d +] A (64 x 16) B (64 x 16)^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N) += A (64 x 16, bf16 fragments in registers) B (16 x N), B
// MN-major in shared memory; N = 64, 32 or 16 by d's size.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 64 x 64 float32 accumulator as the bf16 A fragments of the four 16-wide
// slices of its columns (the m64nNk16 accumulator layout is the A fragment
// layout, two columns a register).
__device__ __forceinline__ void to_a_frags(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// q scaled in its dtype in place, round(q * scale_q) with the scale already
// rounded to bf16: elementwise over the tile's bytes, 8 values a thread and
// turn, so the swizzle does not matter.
template <int D, int THREADS>
__device__ __forceinline__ void scale_tile(uint8_t* tile, float mul, int tid) {
  uint4* p = reinterpret_cast<uint4*>(tile);
#pragma unroll
  for (int e = tid; e < TcGeo<D>::kTileBytes / 16; e += THREADS) {
    uint4 v = p[e];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 f = __bfloat1622float2(h[x]);
      h[x] = __floats2bfloat162_rn(f.x * mul, f.y * mul);
    }
    p[e] = v;
  }
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// The accumulator element q of a thread (m64nNk16 layout): its row (0..63)
// and column (0..N-1). r0 = 16 warp + lane / 4, c2 = 2 (lane % 4).
__device__ __forceinline__ int acc_row(int r0, int q) { return r0 + 8 * ((q >> 1) & 1); }
__device__ __forceinline__ int acc_col(int c2, int q) { return 8 * (q >> 2) + c2 + (q & 1); }

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int n, int H, float scale_q, int causal) {
  using G = TcGeo<D>;
  constexpr int S = G::kStages, W = G::kBoxW, NB = G::kBoxes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sKV = sQ + G::kTileBytes;  // stage s: K at s * 2 tiles, V one tile on
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + S * 2 * G::kTileBytes);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows start first
  const int kt_last = causal ? qt : gridDim.x - 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer: Q, then up to S stages of K and V in flight
    if (tid == 128) {
      mbar_expect_tx(qbar, G::kTileBytes);
      tma_tile<D>(sQ, &map_q, qbar, h, q0, b);
      for (int i = 0; i <= kt_last; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(&empty[s], (i / S - 1) & 1);
        uint8_t* st = sKV + s * 2 * G::kTileBytes;
        mbar_expect_tx(&full[s], 2 * G::kTileBytes);
        tma_tile<D>(st, &map_k, &full[s], h, i * kBK, b);
        tma_tile<D>(st + G::kTileBytes, &map_v, &full[s], h, i * kBK, b);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, c2 = (lane % 4) * 2;
  mbar_wait(qbar, 0);
  scale_tile<D, 128>(sQ, scale_q, tid);
  fence_proxy_async();
  consumer_sync();
  const uint32_t q_addr = smem_u32(sQ);

  float o[NB][W / 2];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < W / 2; ++x) o[j][x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns only

  for (int i = 0; i <= kt_last; ++i) {
    const int s = i % S;
    const uint32_t k_addr = smem_u32(sKV + s * 2 * G::kTileBytes);
    const uint32_t v_addr = k_addr + G::kTileBytes;
    mbar_wait(&full[s], (i / S) & 1);
    float sc[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, kmajor_desc<D>(q_addr, kk), kmajor_desc<D>(k_addr, kk), kk > 0);
    wg_commit();
    wg_wait0();  // this S, and the last tile's P V
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(o[j]);
    if (i > 0) mbar_arrive(&empty[(i - 1) % S]);  // the last tile's K and V are read

    const int k0 = i * kBK;
    if ((causal && i == qt) || (!causal && k0 + kBK > n)) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int row = acc_row(r0, x), col = acc_col(c2, x);
        if (causal ? col > row : k0 + col >= n) sc[x] = -INFINITY;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int x = 0; x < 32; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
    float alpha[2];
    float mx2[2];  // the row max times log2 e
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      l[r] *= alpha[r];
      m[r] = mx[r];
      mx2[r] = mx[r] * kLog2e;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      sc[x] = exp2f(fmaf(sc[x], kLog2e, -mx2[(x >> 1) & 1]));
      l[(x >> 1) & 1] += sc[x];
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int x = 0; x < W / 2; ++x) o[j][x] *= alpha[(x >> 1) & 1];
    uint32_t pa[4][4];
    to_a_frags(sc, pa);  // p rounded to v's dtype
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j) wgmma_rs(o[j], pa[kk], mnmajor_desc<D>(v_addr, j, kk));
    wg_commit();
  }
  wg_wait0();
#pragma unroll
  for (int j = 0; j < NB; ++j) fence_regs(o[j]);

  const int HD = H * D;
  const size_t base = static_cast<size_t>(b) * n * HD + static_cast<size_t>(h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < W / 2; x += 2) {
      const int row = q0 + acc_row(r0, x);
      if (row >= n) continue;
      const float lr = l[(x >> 1) & 1];
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(o[j][x] / lr, o[j][x + 1] / lr);
      *reinterpret_cast<__nv_bfloat162*>(out + base + static_cast<size_t>(row) * HD + j * W +
                                         acc_col(c2, x)) = v2;
    }
  if (c2 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      if (row < n) lse[(static_cast<size_t>(b) * H + h) * n + row] = m[r] + logf(l[r]);
    }
  }
}

template <typename TG> __device__ __forceinline__ void store2(TG* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// sum over one 16-byte chunk (8 bf16) of a * b, in float32, onto acc.
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(x[e]), g = __bfloat1622float2(y[e]);
    acc = fmaf(f.x, g.x, acc);
    acc = fmaf(f.y, g.y, acc);
  }
  return acc;
}

// TG: the gradient's type, bf16 or (for the ring's blocks) float32.
template <typename TG, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o,
                   const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                   float* __restrict__ delta, TG* __restrict__ dq, int n, int H, float scale_q,
                   float scale, int causal) {
  using G = TcGeo<D>;
  constexpr int S = G::kStages, W = G::kBoxW, NB = G::kBoxes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sDO = sQ + G::kTileBytes;
  uint8_t* sO = sDO + G::kTileBytes;
  uint8_t* sKV = sO + G::kTileBytes;  // stage s: K at s * 2 tiles, V one tile on
  float* sStat = reinterpret_cast<float*>(sKV + S * 2 * G::kTileBytes);  // delta, lse log2 e
  uint64_t* full = reinterpret_cast<uint64_t*>(sStat + 2 * kBQ);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows start first
  const int kt_last = causal ? qt : gridDim.x - 1;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const size_t sbase = (static_cast<size_t>(b) * H + h) * n;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer: Q, dO and O, then up to S stages of K and V in flight
    if (tid == 128) {
      mbar_expect_tx(qbar, 3 * G::kTileBytes);
      tma_tile<D>(sQ, &map_q, qbar, h, q0, b);
      tma_tile<D>(sDO, &map_do, qbar, h, q0, b);
      tma_tile<D>(sO, &map_o, qbar, h, q0, b);
      for (int i = 0; i <= kt_last; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(&empty[s], (i / S - 1) & 1);
        uint8_t* st = sKV + s * 2 * G::kTileBytes;
        mbar_expect_tx(&full[s], 2 * G::kTileBytes);
        tma_tile<D>(st, &map_k, &full[s], h, i * kBK, b);
        tma_tile<D>(st + G::kTileBytes, &map_v, &full[s], h, i * kBK, b);
      }
    }
    return;
  }

  mbar_wait(qbar, 0);
  scale_tile<D, 128>(sQ, scale_q, tid);
  {
    // delta = rowsum(dO * O) of row tid / 2 by two threads, each over every
    // other 16-byte chunk of the row. Both tiles carry the same swizzle
    // (a permutation of a box row's chunks), so equal offsets pair equal
    // elements and a box row's chunks are the row's.
    constexpr int kRowChunks = D / 8, kBoxChunks = W / 8;
    const int r = tid >> 1;
    float part = 0.f;
#pragma unroll
    for (int c = tid & 1; c < kRowChunks; c += 2) {
      const int at = (c / kBoxChunks) * G::kBoxBytes + r * G::kSwz + (c % kBoxChunks) * 16;
      part = dot8(*reinterpret_cast<const uint4*>(sDO + at),
                  *reinterpret_cast<const uint4*>(sO + at), part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((tid & 1) == 0) {
      const int t = q0 + r;
      sStat[r] = part;
      sStat[kBQ + r] = t < n ? lse[sbase + t] * kLog2e : 0.f;
      if (t < n) delta[sbase + t] = part;
    }
  }
  fence_proxy_async();  // the scaled q, for wgmma
  consumer_sync();

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, c2 = (lane % 4) * 2;
  const float dl[2] = {sStat[r0], sStat[r0 + 8]};
  const float ls[2] = {sStat[kBQ + r0], sStat[kBQ + r0 + 8]};
  const uint32_t q_addr = smem_u32(sQ), do_addr = smem_u32(sDO);

  float acc[NB][W / 2];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < W / 2; ++x) acc[j][x] = 0.f;

  for (int i = 0; i <= kt_last; ++i) {
    const int s = i % S;
    const uint32_t k_addr = smem_u32(sKV + s * 2 * G::kTileBytes);
    const uint32_t v_addr = k_addr + G::kTileBytes;
    mbar_wait(&full[s], (i / S) & 1);
    float sc[32], dp[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = dp[x] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, kmajor_desc<D>(q_addr, kk), kmajor_desc<D>(k_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, kmajor_desc<D>(do_addr, kk), kmajor_desc<D>(v_addr, kk), kk > 0);
    wg_commit();
    wg_wait0();  // these, and the last tile's dQ product
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(acc[j]);
    if (i > 0) mbar_arrive(&empty[(i - 1) % S]);  // the last tile's K and V are read

    // The masked axis is the columns (keys): the diagonal tile under the
    // causal mask, the last tile's keys past n without it (there K and V are
    // zeros, but p = exp(0 - lse) is not).
    const int k0 = i * kBK;
    const bool edge = causal ? i == qt : k0 + kBK > n;
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1, row = acc_row(r0, x), col = acc_col(c2, x);
      const bool valid = !edge || (causal ? col <= row : k0 + col < n);
      const float p = valid ? exp2f(fmaf(sc[x], kLog2e, -ls[r])) : 0.f;
      dp[x] = p * (dp[x] - dl[r]);  // ds, rounded to k's dtype below
    }
    uint32_t da[4][4];
    to_a_frags(dp, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j) wgmma_rs(acc[j], da[kk], mnmajor_desc<D>(k_addr, j, kk));
    wg_commit();
  }
  wg_wait0();
#pragma unroll
  for (int j = 0; j < NB; ++j) fence_regs(acc[j]);

  const int HD = H * D;
  const size_t base = static_cast<size_t>(b) * n * HD + static_cast<size_t>(h) * D;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < W / 2; x += 2) {
      const int row = q0 + acc_row(r0, x);
      if (row >= n) continue;
      store2<TG>(dq + base + static_cast<size_t>(row) * HD + j * W + acc_col(c2, x),
                 acc[j][x] * scale, acc[j][x + 1] * scale);
    }
}

// TG: the gradients' type, bf16 or (for the ring's blocks) float32.
template <typename TG, int D>
__global__ void __launch_bounds__(kTcThreads)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, TG* __restrict__ dk, TG* __restrict__ dv,
                    int n, int H, float scale_q, int causal) {
  using G = TcGeo<D>;
  constexpr int S = G::kStages, W = G::kBoxW, NB = G::kBoxes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + G::kTileBytes;
  uint8_t* sStages = sV + G::kTileBytes;  // stage s: Q, dO, lse[64], delta[64]
  uint64_t* landed = reinterpret_cast<uint64_t*>(sStages + S * G::kDkvStage);
  uint64_t* full = landed + S;
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;

  const int kt = blockIdx.x, nq = gridDim.x;
  const int first = causal ? kt : 0;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBK;
  const size_t sbase = (static_cast<size_t>(b) * H + h) * n;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 128);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: loads S - 1 stages ahead of the stage it hands over
    const int lane = tid - 128, n_it = nq - first;
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * G::kTileBytes);
      tma_tile<D>(sK, &map_k, kvbar, h, k0, b);
      tma_tile<D>(sV, &map_v, kvbar, h, k0, b);
    }
    const auto issue = [&](int i) {  // stage i's Q and dO in flight
      const int s = i % S;
      if (i >= S) mbar_wait(&empty[s], (i / S - 1) & 1);
      uint8_t* st = sStages + s * G::kDkvStage;
      if (lane == 0) {
        mbar_expect_tx(&landed[s], 2 * G::kTileBytes);
        tma_tile<D>(st, &map_q, &landed[s], h, (first + i) * kBQ, b);
        tma_tile<D>(st + G::kTileBytes, &map_do, &landed[s], h, (first + i) * kBQ, b);
      }
    };
    for (int i = 0; i < S - 1 && i < n_it; ++i) issue(i);
    for (int j = 0; j < n_it; ++j) {
      // stage j to the consumer: its rows' lse and delta, and q scaled in place
      const int s = j % S, q0 = (first + j) * kBQ;
      uint8_t* st = sStages + s * G::kDkvStage;
      float* sl = reinterpret_cast<float*>(st + 2 * G::kTileBytes);
      float stats[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = q0 + lane + 32 * r;
        stats[r] = t < n ? lse[sbase + t] * kLog2e : 0.f;
        stats[2 + r] = t < n ? delta[sbase + t] : 0.f;
      }
      mbar_wait(&landed[s], (j / S) & 1);
      scale_tile<D, 32>(st, scale_q, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sl[lane + 32 * r] = stats[r];
        sl[kBQ + lane + 32 * r] = stats[2 + r];
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
      if (j + S - 1 < n_it) issue(j + S - 1);
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4, c2 = (lane % 4) * 2;
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);
  float dk_acc[NB][W / 2], dv_acc[NB][W / 2];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < W / 2; ++x) dk_acc[j][x] = dv_acc[j][x] = 0.f;
  mbar_wait(kvbar, 0);

  for (int i = 0; first + i < nq; ++i) {
    const int s = i % S, qt = first + i, q0 = qt * kBQ;
    uint8_t* st = sStages + s * G::kDkvStage;
    const float* sl = reinterpret_cast<const float*>(st + 2 * G::kTileBytes);
    const uint32_t q_addr = smem_u32(st), do_addr = q_addr + G::kTileBytes;
    mbar_wait(&full[s], (i / S) & 1);

    float sT[32], dpT[32];  // rows: this tile's keys; columns: the stage's q rows
#pragma unroll
    for (int x = 0; x < 32; ++x) sT[x] = dpT[x] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sT, kmajor_desc<D>(k_addr, kk), kmajor_desc<D>(q_addr, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpT, kmajor_desc<D>(v_addr, kk), kmajor_desc<D>(do_addr, kk), kk > 0);
    wg_commit();
    wg_wait0();  // these, and the last stage's dK / dV products
    fence_regs(sT);
    fence_regs(dpT);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fence_regs(dk_acc[j]);
      fence_regs(dv_acc[j]);
    }
    if (i > 0) mbar_arrive(&empty[(i - 1) % S]);  // the last stage is read

    const bool diag = causal && qt == kt, tail = q0 + kBQ > n;
#pragma unroll
    for (int x = 0; x < 32; x += 2) {
      const int key = acc_row(r0, x), col = acc_col(c2, x);  // col even: this and col + 1
      const float2 ls = *reinterpret_cast<const float2*>(sl + col);  // lse log2 e
      const float2 dl = *reinterpret_cast<const float2*>(sl + kBQ + col);
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const bool valid = (!diag || key <= col + y) && (!tail || q0 + col + y < n);
        const float p = valid ? exp2f(fmaf(sT[x + y], kLog2e, -(y ? ls.y : ls.x))) : 0.f;
        dpT[x + y] = p * (dpT[x + y] - (y ? dl.y : dl.x));  // ds, for dK in q's dtype
        sT[x + y] = p;                                       // for dV in dO's dtype
      }
    }
    uint32_t pa[4][4], da[4][4];
    to_a_frags(sT, pa);
    to_a_frags(dpT, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        wgmma_rs(dv_acc[j], pa[kk], mnmajor_desc<D>(do_addr, j, kk));
        wgmma_rs(dk_acc[j], da[kk], mnmajor_desc<D>(q_addr, j, kk));
      }
    wg_commit();
  }
  wg_wait0();
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    fence_regs(dk_acc[j]);
    fence_regs(dv_acc[j]);
  }

  const int HD = H * D;
  const size_t base = static_cast<size_t>(b) * n * HD + static_cast<size_t>(h) * D;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < W / 2; x += 2) {
      const int key = k0 + acc_row(r0, x);
      if (key >= n) continue;
      const size_t at = base + static_cast<size_t>(key) * HD + j * W + acc_col(c2, x);
      store2<TG>(dk + at, dk_acc[j][x], dk_acc[j][x + 1]);
      store2<TG>(dv + at, dv_acc[j][x], dv_acc[j][x + 1]);
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A cu* entry point of the CUDA library by name (CUDA 12 ABI), or nullptr.
void* cu_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
  const cudaError_t rc = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t rc = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) ? p : nullptr;
}

EncodeTiled encode_fn() {
  static const EncodeTiled fn = reinterpret_cast<EncodeTiled>(cu_fn("cuTensorMapEncodeTiled"));
  return fn;
}

// cuTensorMapEncodeTiled, a cu* (not cuda*) call, fails without a context current
// on the calling thread. A runtime launch binds the device's primary context
// only when it runs, so on a thread whose first CUDA work is one of these
// launches (autograd's backward thread when the dq kernel is the backward's
// first op) none is current yet; then cudaSetDevice binds it (CUDA 12).
cudaError_t bind_context() {
  using CtxGetCurrent = CUresult (*)(CUcontext*);
  static const CtxGetCurrent get = reinterpret_cast<CtxGetCurrent>(cu_fn("cuCtxGetCurrent"));
  CUcontext ctx = nullptr;
  if (get != nullptr && get(&ctx) == CUDA_SUCCESS && ctx != nullptr) return cudaSuccess;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? cudaSetDevice(dev) : e;
}

// The tensor map of a packed (B, n, H * D) bf16 tensor for boxes of 64 rows
// of one head's kBoxW columns, swizzled to the box's row; rows past n read as
// zeros. TMA needs a 16-byte-aligned base (the row stride, 2 H D bytes, is a
// multiple of 32).
template <int D>
bool encode(CUtensorMap* map, const void* p, int B, int n, int H) {
  using G = TcGeo<D>;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const cuuint64_t hd = static_cast<cuuint64_t>(H) * D;
  const cuuint64_t dims[3] = {hd, static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {hd * 2, hd * 2 * static_cast<cuuint64_t>(n)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(G::kBoxW), kBQ, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = G::kSwz == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : G::kSwz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A launch's plan (ops/flash_attention.py, flash_plan): the swizzle span in
// bytes, the boxes a tile and the stages. It must be the instance's.
template <int D>
bool plan_is(int swizzle, int boxes, int stages) {
  using G = TcGeo<D>;
  return swizzle == G::kSwz && boxes == G::kBoxes && stages == G::kStages;
}

template <int D>
cudaError_t tc_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int n, int H, float scale_q, int causal, int swizzle, int boxes, int stages,
                   cudaStream_t st) {
  using G = TcGeo<D>;
  if (!plan_is<D>(swizzle, boxes, stages)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e = bind_context();
  if (e != cudaSuccess) return e;
  if (!(encode<D>(&mq, q, B, n, H) && encode<D>(&mk, k, B, n, H) && encode<D>(&mv, v, B, n, H)))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_tc_kernel<D>;
  static unsigned long long done = 0;  // one bit per device
  e = allow_smem(kern, G::kFwdSmem, done);
  if (e != cudaSuccess) return e;
  kern<<<grid(B, n, H), kTcThreads, G::kFwdSmem, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, n, H, scale_q, causal);
  return cudaGetLastError();
}

template <typename TG, int D>
cudaError_t tc_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int B, int n, int H,
                   float scale_q, int causal, int swizzle, int boxes, int stages,
                   cudaStream_t st) {
  using G = TcGeo<D>;
  if (!plan_is<D>(swizzle, boxes, stages)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t e = bind_context();
  if (e != cudaSuccess) return e;
  if (!(encode<D>(&mq, q, B, n, H) && encode<D>(&mk, k, B, n, H) &&
        encode<D>(&mv, v, B, n, H) && encode<D>(&mdo, dout, B, n, H)))
    return cudaErrorInvalidValue;
  auto kern = flash_dkv_tc_kernel<TG, D>;
  static unsigned long long done = 0;  // one bit per device
  e = allow_smem(kern, G::kDkvSmem, done);
  if (e != cudaSuccess) return e;
  kern<<<grid(B, n, H), kTcThreads, G::kDkvSmem, st>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<TG*>(dk), static_cast<TG*>(dv), n, H, scale_q,
      causal);
  return cudaGetLastError();
}

template <typename TG, int D>
cudaError_t tc_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
                  const float* lse, float* delta, void* dq, int B, int n, int H, float scale_q,
                  float scale, int causal, int swizzle, int boxes, int stages, cudaStream_t st) {
  using G = TcGeo<D>;
  if (!plan_is<D>(swizzle, boxes, stages)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo, mdo;
  cudaError_t e = bind_context();
  if (e != cudaSuccess) return e;
  if (!(encode<D>(&mq, q, B, n, H) && encode<D>(&mk, k, B, n, H) &&
        encode<D>(&mv, v, B, n, H) && encode<D>(&mo, out, B, n, H) &&
        encode<D>(&mdo, dout, B, n, H)))
    return cudaErrorInvalidValue;
  auto kern = flash_dq_tc_kernel<TG, D>;
  static unsigned long long done = 0;  // one bit per device
  e = allow_smem(kern, G::kDqSmem, done);
  if (e != cudaSuccess) return e;
  kern<<<grid(B, n, H), kTcThreads, G::kDqSmem, st>>>(
      mq, mk, mv, mo, mdo, lse, delta, static_cast<TG*>(dq), n, H, scale_q, scale, causal);
  return cudaGetLastError();
}

#define DTC_DIMS(CASE, ...)                                              \
  CASE(__VA_ARGS__, 16) CASE(__VA_ARGS__, 32) CASE(__VA_ARGS__, 48)      \
  CASE(__VA_ARGS__, 64) CASE(__VA_ARGS__, 80) CASE(__VA_ARGS__, 96)      \
  CASE(__VA_ARGS__, 112) CASE(__VA_ARGS__, 128)
#define DTC_TCASE(CALL, GCODE, GELEM, DIM) \
  case (GCODE) * 1000 + (DIM): { using TG = GELEM; constexpr int kD = DIM; return CALL; }

}  // namespace

// bfloat16 inputs; gdtype: the gradients' type, 0 float32, 1 bfloat16;
// causal: 1 masks key > query, 0 masks only keys past T; swizzle, boxes,
// stages: the launch's plan.
extern "C" int dtc_flash_tc_fwd(const void* q, const void* k, const void* v, void* out,
                                float* lse, int B, int T, int H, int D, float scale_q,
                                int causal, int swizzle, int boxes, int stages, void* stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (1000 + D) {
    DTC_DIMS(DTC_TCASE, (static_cast<int>(tc_fwd<kD>(q, k, v, out, lse, B, T, H, scale_q,
                                                      causal, swizzle, boxes, stages, st))),
             1, void)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dtc_flash_tc_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dk, void* dv, int B,
                                int T, int H, int D, float scale_q, int gdtype, int causal,
                                int swizzle, int boxes, int stages, void* stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTC_DKV (static_cast<int>(tc_dkv<TG, kD>(q, k, v, dout, lse, delta, dk, dv, B, T, H, \
                                                 scale_q, causal, swizzle, boxes, stages, st)))
  switch (gdtype * 1000 + D) {
    DTC_DIMS(DTC_TCASE, DTC_DKV, 0, float)
    DTC_DIMS(DTC_TCASE, DTC_DKV, 1, __nv_bfloat16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DTC_DKV
}

extern "C" int dtc_flash_tc_dq(const void* q, const void* k, const void* v, const void* out,
                               const void* dout, const float* lse, float* delta, void* dq, int B,
                               int T, int H, int D, float scale_q, float scale, int gdtype,
                               int causal, int swizzle, int boxes, int stages, void* stream) {
  if (bad_shape(B, T, H)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTC_DQ (static_cast<int>(tc_dq<TG, kD>(q, k, v, out, dout, lse, delta, dq, B, T, H, \
                                               scale_q, scale, causal, swizzle, boxes, stages, \
                                               st)))
  switch (gdtype * 1000 + D) {
    DTC_DIMS(DTC_TCASE, DTC_DQ, 0, float)
    DTC_DIMS(DTC_TCASE, DTC_DQ, 1, __nv_bfloat16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DTC_DQ
}

// Dynamic shared memory of a block of the forward (kernel 0), dk/dv
// (kernel 1) or dq (kernel 2) instance at head dim D; 0: no such instance.
extern "C" int dtc_flash_tc_smem_bytes(int kernel, int D) {
#define DTC_SMEM                                                 \
  (kernel == 0 ? TcGeo<kD>::kFwdSmem : kernel == 1 ? TcGeo<kD>::kDkvSmem \
   : kernel == 2 ? TcGeo<kD>::kDqSmem : 0)
  switch (1000 + D) {
    DTC_DIMS(DTC_TCASE, DTC_SMEM, 1, void)
    default: return 0;
  }
#undef DTC_SMEM
}

#endif  // DTC_FLASH_TC

extern "C" const char* dtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
