// The FSDP ring's two matmul kernels, for Hopper (sm_90a): one ring step of
// the all-gather-matmul, and one ring step of the matmul + streamed
// reduce-scatter of a weight gradient.
//
// Replaces the JAX package's TPU kernels dtc_tpu/ops/overlap_collectives.py
// _overlap_ag_matmul_kernel (row 17) and _overlap_rs_matmul_kernel (row 18).
// Those run the whole ring inside one kernel: remote DMAs (make_async_remote_copy)
// forward the weight chunk or the partial sum to the right neighbour while the
// MXU multiplies. Here a remote copy is a torch.distributed point-to-point
// exchange outside the kernel (ops/overlap_collectives.py): the exchange of
// step s runs on NCCL's stream while this step's kernel runs on the compute
// stream, so one launch is one ring step.
//
// dtc_overlap_ag_step (row 17): out[:, cols] (=|+=) x_s @ W_s in float32, where
// x_s is x or one column block of it (contract mode: the ring step's slice of
// the contraction) and W_s is the weight chunk that step holds, read through
// its two strides, so a transposed chunk (w_t) or a strided view costs no copy.
// Out mode writes one output column block; contract mode writes at step 0 and
// adds to the float32 accumulator after (o = o + part, the TPU kernel's order).
//
// dtc_overlap_rs_step (row 18): stage = acc + a_jᵀ @ b_j in float32 over the
// local token rows, where one of a, b is cut to the gradient block j of this
// step and acc is the accumulator that arrived from the left neighbour (none
// at step 0). The token-row contraction is a loop inside each output tile: no
// atomics, the same bits every run.
//
// Both kernels: bfloat16 or float32 inputs (bf16 products are exact in float32),
// any M, N, K (edges masked), blocks of 256 threads with 4 x 4 outputs a
// thread, operands staged through shared memory in 32-deep slices as float32,
// fused multiply-adds on CUDA cores in ascending k. A block computes a 64 x 64
// output tile, or, where those tiles would leave SMs idle, a 32 x 32 tile with
// the contraction split over four thread groups (tile_product).
//
// Bound: at the flagship (d_model 512, d_ff 2048, 1,024 token rows a rank,
// ring 4) a step multiplies (1024, 128) by (128, 512..2048) or (1024,
// 512..2048) by (.., 128): above the card's ops-per-byte line in bf16, so the
// tensor cores' 989 TFLOP/s bound it. This kernel uses CUDA cores (67 TFLOP/s
// float32 at best) and so sits one to two orders of magnitude from that bound
// (PERF.md); mma.sync / wgmma tiles, and a single launch per ring with
// in-kernel peer-to-peer copies, are later work (ROADMAP.md §B).
//
// Plain C interface (ctypes): each entry point launches on the given stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 32;     // contraction depth of one shared-memory slice
constexpr int kThreads = 256;  // threads of a block
constexpr int kPer = 4;        // 4 x 4 outputs a thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// A block computes one TILE x TILE output tile with SPLIT groups of
// (TILE / 4)^2 threads: group g takes the 32-deep slices g, g + SPLIT, ...
// of the contraction. Two shapes: 64 x 64 by one group, or 32 x 32 by four
// groups (four times the blocks on the same output, for grids that would
// leave SMs idle; the groups' partials are summed in group order, so the
// bits do not change between runs).
//
// acc[r][c] = sum over k < K of A(i, k) * B(k, j) for the thread's outputs
// i = i0 + ty*4 + r, j = j0 + tx*4 + c; with SPLIT > 1 group 0 ends with
// the whole sum and the other groups' acc is partial. A(i, k) = A[i*sai +
// k*sak] and B(k, j) = B[k*sbk + j*sbj]; elements past M, N or K read as
// zero. The loads walk the unit-stride dimension across neighbouring threads.
template <typename T, int TILE, int SPLIT>
__device__ __forceinline__ void tile_product(const T* __restrict__ A, long long sai,
                                             long long sak, const T* __restrict__ B,
                                             long long sbk, long long sbj, int M, int N,
                                             int K, int i0, int j0,
                                             float (&acc)[kPer][kPer]) {
  constexpr int kSide = TILE / kPer;      // threads along a tile edge
  constexpr int kGroup = kSide * kSide;   // threads of a group
  static_assert(kGroup * SPLIT == kThreads, "a block is SPLIT groups");
  static_assert(SPLIT == 1 || kDepth * (TILE + 4) >= TILE * TILE, "the partials fit in As");
  __shared__ float As[SPLIT][kDepth][TILE + 4];
  __shared__ float Bs[SPLIT][kDepth][TILE + 4];
  const int g = threadIdx.x / kGroup, tid = threadIdx.x % kGroup;
  const int tx = tid % kSide, ty = tid / kSide;
  const bool a_k_unit = (sak == 1);
  const bool b_j_unit = (sbj == 1);
  for (int base = 0; base < K; base += SPLIT * kDepth) {  // the same trip count for all
    const int k0 = base + g * kDepth;
#pragma unroll
    for (int r = 0; r < (TILE * kDepth) / kGroup; ++r) {
      const int e = tid + r * kGroup;
      const int ii = a_k_unit ? e / kDepth : e % TILE;
      const int kk = a_k_unit ? e % kDepth : e / TILE;
      const int gi = i0 + ii, gk = k0 + kk;
      As[g][kk][ii] = (gi < M && gk < K) ? to_f(A[gi * sai + gk * sak]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (TILE * kDepth) / kGroup; ++r) {
      const int e = tid + r * kGroup;
      const int jj = b_j_unit ? e % TILE : e / kDepth;
      const int kk = b_j_unit ? e / TILE : e % kDepth;
      const int gj = j0 + jj, gk = k0 + kk;
      Bs[g][kk][jj] = (gj < N && gk < K) ? to_f(B[gk * sbk + gj * sbj]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDepth; ++kk) {
      float a[kPer], b[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) a[r] = As[g][kk][ty * kPer + r];
#pragma unroll
      for (int c = 0; c < kPer; ++c) b[c] = Bs[g][kk][tx * kPer + c];
#pragma unroll
      for (int r = 0; r < kPer; ++r)
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
  if (SPLIT > 1) {  // group 0 adds the others' partials, in group order
    float* part = &As[0][0][0];
#pragma unroll
    for (int r = 0; r < kPer; ++r)
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        part[(g * TILE + ty * kPer + r) * TILE + tx * kPer + c] = acc[r][c];
    __syncthreads();
    if (g == 0) {
#pragma unroll
      for (int r = 0; r < kPer; ++r)
#pragma unroll
        for (int c = 0; c < kPer; ++c)
#pragma unroll
          for (int h = 1; h < SPLIT; ++h)
            acc[r][c] += part[(h * TILE + ty * kPer + r) * TILE + tx * kPer + c];
    }
  }
}

// Row 17: out(i, j) = [out(i, j) +] sum_k x(i, k) * w(k, j).
template <typename T, int TILE, int SPLIT>
__global__ void __launch_bounds__(kThreads)
    overlap_ag_step_kernel(const T* __restrict__ x, long long sxm, long long sxk,
                           const T* __restrict__ w, long long swk, long long swn,
                           float* __restrict__ out, long long ldo, int M, int N, int K,
                           int accumulate) {
  constexpr int kSide = TILE / kPer;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  float acc[kPer][kPer] = {};
  tile_product<T, TILE, SPLIT>(x, sxm, sxk, w, swk, swn, M, N, K, i0, j0, acc);
  if (threadIdx.x >= kSide * kSide) return;  // group 0 holds the sums
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = i0 + ty * kPer + r;
    if (i >= M) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = j0 + tx * kPer + c;
      if (j >= N) continue;
      float* o = out + i * ldo + j;
      *o = accumulate ? *o + acc[r][c] : acc[r][c];
    }
  }
}

// Row 18: out(i, j) = [acc_in(i, j) +] sum_m a(m, i) * b(m, j); out and acc_in
// are contiguous (M, N).
template <typename T, int TILE, int SPLIT>
__global__ void __launch_bounds__(kThreads)
    overlap_rs_step_kernel(const T* __restrict__ a, long long sam, long long sai,
                           const T* __restrict__ b, long long sbm, long long sbn,
                           const float* __restrict__ acc_in, float* __restrict__ out,
                           int M, int N, int K) {
  constexpr int kSide = TILE / kPer;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  float acc[kPer][kPer] = {};
  tile_product<T, TILE, SPLIT>(a, sai, sam, b, sbm, sbn, M, N, K, i0, j0, acc);
  if (threadIdx.x >= kSide * kSide) return;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = i0 + ty * kPer + r;
    if (i >= M) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = j0 + tx * kPer + c;
      if (j >= N) continue;
      const long long o = static_cast<long long>(i) * N + j;
      out[o] = acc_in != nullptr ? acc_in[o] + acc[r][c] : acc[r][c];
    }
  }
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

// The 32 x 32 tiles when 64 x 64 tiles would give fewer blocks than the
// card has SMs (out mode's 1024 x 128 step: 32 blocks on 132 SMs).
bool small_tiles(int M, int N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 1;
  }
  return static_cast<long long>(tiles(M, 64)) * tiles(N, 64) < sms;
}

bool bad_dims(int M, int N, int K) { return M < 1 || N < 1 || K < 1 || tiles(M, 32) > 65535; }

template <typename T>
void launch_ag(const void* x, long long sxm, long long sxk, const void* w, long long swk,
               long long swn, float* out, long long ldo, int M, int N, int K, int accumulate,
               cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  if (small_tiles(M, N))
    overlap_ag_step_kernel<T, 32, 4><<<dim3(tiles(N, 32), tiles(M, 32)), kThreads, 0, st>>>(
        xp, sxm, sxk, wp, swk, swn, out, ldo, M, N, K, accumulate);
  else
    overlap_ag_step_kernel<T, 64, 1><<<dim3(tiles(N, 64), tiles(M, 64)), kThreads, 0, st>>>(
        xp, sxm, sxk, wp, swk, swn, out, ldo, M, N, K, accumulate);
}

template <typename T>
void launch_rs(const void* a, long long sam, long long sai, const void* b, long long sbm,
               long long sbn, const float* acc, float* out, int M, int N, int K,
               cudaStream_t st) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  if (small_tiles(M, N))
    overlap_rs_step_kernel<T, 32, 4><<<dim3(tiles(N, 32), tiles(M, 32)), kThreads, 0, st>>>(
        ap, sam, sai, bp, sbm, sbn, acc, out, M, N, K);
  else
    overlap_rs_step_kernel<T, 64, 1><<<dim3(tiles(N, 64), tiles(M, 64)), kThreads, 0, st>>>(
        ap, sam, sai, bp, sbm, sbn, acc, out, M, N, K);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and w alike).
extern "C" int dtc_overlap_ag_step(const void* x, long long sxm, long long sxk, const void* w,
                                   long long swk, long long swn, void* out, long long ldo,
                                   int M, int N, int K, int accumulate, int dtype,
                                   void* stream) {
  if (bad_dims(M, N, K) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    launch_ag<float>(x, sxm, sxk, w, swk, swn, o, ldo, M, N, K, accumulate, st);
  else
    launch_ag<__nv_bfloat16>(x, sxm, sxk, w, swk, swn, o, ldo, M, N, K, accumulate, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtc_overlap_rs_step(const void* a, long long sam, long long sai, const void* b,
                                   long long sbm, long long sbn, const void* acc_in, void* out,
                                   int M, int N, int K, int dtype, void* stream) {
  if (bad_dims(M, N, K) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* acc = static_cast<const float*>(acc_in);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    launch_rs<float>(a, sam, sai, b, sbm, sbn, acc, o, M, N, K, st);
  else
    launch_rs<__nv_bfloat16>(a, sam, sai, b, sbm, sbn, acc, o, M, N, K, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
