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
// the mask keeps key <= query; the forward
// is a one-pass softmax per row, p cast to v's dtype before the float32 P*V
// sum, out = acc / l in q's dtype, lse = m + log(l). The backward recomputes
// p = exp(s - lse), delta = rowsum(dO * O) in float32, dp = dO V^T,
// ds = p (dp - delta), dq = (ds in k's dtype) K * scale, dk = (ds in q's
// dtype)^T (q scaled), dv = (p in dO's dtype)^T dO.
//
// Design. One block of 128 threads per (64-row tile, head, batch row); blocks
// never share an output element, so there are no atomics and two runs give
// the same bits. The forward takes two passes over the KV tiles up to the
// diagonal (tiles above it are skipped; without the causal mask, over every
// tile, the last one's keys past T masked): the first finds each row's max and
// sum, the second forms p against the row's final max, exactly as the
// single-tile TPU kernel does, so p rounds to v's dtype at the same values as
// the plain version and no running rescale is needed. The backward is the
// FA2 split: a dq kernel (one block per q tile, walking KV tiles up to the
// diagonal) that also writes delta for its rows, then a dk/dv kernel (one
// block per KV tile, walking q tiles from the diagonal on, or all of them) that
// reads it.
// Tiles are staged in shared memory as float32 with one column of padding;
// each thread owns a 4 x 8 piece of the 64 x 64 score tile (rows tr + 16 i,
// columns tc + 8 j) and the matching 4 x D/8 piece of the output tile, and
// every product is a plain float32 FMA loop over shared memory. Any head dim
// that is a multiple of 8 maps onto the threads so; the instances are the
// multiples of 16 up to 128. The largest, D 128, takes 165,376 B of shared
// memory in the dk/dv kernel, under the 227 KB a block may have.
//
// Bound. At the flagship (B 8, T 512, H 16, D 32, bfloat16) both directions
// are bound by bytes on paper: the forward must move q, k, v, out and lse,
// 17,039,360 B, 5.09 us at 3.35 TB/s, against 2.15 GFLOP of causal products,
// 2.18 us at the bf16 tensor-core peak; the backward 33,816,576 B (10.1 us)
// against 5.38 GFLOP (5.44 us). The work grows with T^2 and the bytes with T,
// so at long context (B 2, T 8192) both directions are bound by operations:
// 137 GFLOP forward (0.139 ms), 344 GFLOP backward (0.347 ms). This kernel
// reads each tile once per block that needs it and writes each output once,
// but it does its products on the CUDA cores, not the tensor cores, and the
// forward recomputes q K^T in its second pass, so it is bound by float32 FMA
// issue and shared-memory loads, far above those bounds (PERF.md has its
// times). Tensor-core products (mma/wgmma), TMA staging and a one-pass online
// softmax are later work. A ring block (no causal mask, B 2, tc 1024, H 16,
// D 32, bfloat16) does twice the products of a causal call at that T, on the
// same design.
//
// Plain C interface (ctypes): each entry point launches on the given stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key rows per tile
constexpr int kPS = kBK + 1;  // padded row stride of the score tiles

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

inline dim3 grid(int B, int n, int H) { return dim3((n + kBQ - 1) / kBQ, H, B); }

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

// dtype codes shared with the wrapper: 0 float32, 1 bfloat16.
#define DTC_CASE(DTYPE, ELEM, DIM, CALL) \
  case (DTYPE) * 1000 + (DIM): { using T = ELEM; constexpr int kD = DIM; return CALL; }
#define DTC_CASES(DTYPE, ELEM, CALL)                                   \
  DTC_CASE(DTYPE, ELEM, 16, CALL) DTC_CASE(DTYPE, ELEM, 32, CALL)      \
  DTC_CASE(DTYPE, ELEM, 48, CALL) DTC_CASE(DTYPE, ELEM, 64, CALL)      \
  DTC_CASE(DTYPE, ELEM, 80, CALL) DTC_CASE(DTYPE, ELEM, 96, CALL)      \
  DTC_CASE(DTYPE, ELEM, 112, CALL) DTC_CASE(DTYPE, ELEM, 128, CALL)
#define DTC_DISPATCH(DTYPE, D, CALL)                \
  switch ((DTYPE) * 1000 + (D)) {                   \
    DTC_CASES(0, float, CALL)                       \
    DTC_CASES(1, __nv_bfloat16, CALL)               \
    default: return cudaErrorInvalidValue;          \
  }
// The backward's (input, gradient) dtype pairs, code dtype * 2 + gdtype:
// float32 / float32 (0), bfloat16 / float32 (2, the ring's blocks) and
// bfloat16 / bfloat16 (3).
#define DTC_GCASE(CODE, ELEM, GELEM, DIM, CALL)                     \
  case (CODE) * 1000 + (DIM): {                                    \
    using T = ELEM; using TG = GELEM; constexpr int kD = DIM; return CALL; }
#define DTC_GCASES(CODE, ELEM, GELEM, CALL)                                          \
  DTC_GCASE(CODE, ELEM, GELEM, 16, CALL) DTC_GCASE(CODE, ELEM, GELEM, 32, CALL)      \
  DTC_GCASE(CODE, ELEM, GELEM, 48, CALL) DTC_GCASE(CODE, ELEM, GELEM, 64, CALL)      \
  DTC_GCASE(CODE, ELEM, GELEM, 80, CALL) DTC_GCASE(CODE, ELEM, GELEM, 96, CALL)      \
  DTC_GCASE(CODE, ELEM, GELEM, 112, CALL) DTC_GCASE(CODE, ELEM, GELEM, 128, CALL)
#define DTC_GDISPATCH(DTYPE, GDTYPE, D, CALL)                \
  switch (((DTYPE) * 2 + (GDTYPE)) * 1000 + (D)) {           \
    DTC_GCASES(0, float, float, CALL)                        \
    DTC_GCASES(2, __nv_bfloat16, float, CALL)                \
    DTC_GCASES(3, __nv_bfloat16, __nv_bfloat16, CALL)        \
    default: return cudaErrorInvalidValue;                   \
  }

cudaError_t fwd_any(const void* q, const void* k, const void* v, void* out, float* lse,
                    int B, int n, int H, int D, float scale_q, int dtype, int causal,
                    cudaStream_t st) {
  DTC_DISPATCH(dtype, D, (fwd<T, kD>(q, k, v, out, lse, B, n, H, scale_q, causal, st)))
}

cudaError_t dq_any(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const float* lse, float* delta, void* dq, int B, int n,
                   int H, int D, float scale_q, float scale, int dtype, int gdtype, int causal,
                   cudaStream_t st) {
  DTC_GDISPATCH(dtype, gdtype, D, (bwd_dq<T, TG, kD>(q, k, v, out, dout, lse, delta, dq, B,
                                                     n, H, scale_q, scale, causal, st)))
}

cudaError_t dkv_any(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int B, int n,
                    int H, int D, float scale_q, int dtype, int gdtype, int causal,
                    cudaStream_t st) {
  DTC_GDISPATCH(dtype, gdtype, D, (bwd_dkv<T, TG, kD>(q, k, v, dout, lse, delta, dk, dv, B,
                                                      n, H, scale_q, causal, st)))
}

bool bad_shape(int B, int n, int H) { return B < 1 || n < 1 || H < 1 || H > 65535 || B > 65535; }

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

extern "C" const char* dtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
