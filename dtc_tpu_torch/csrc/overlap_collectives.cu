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
// at step 0).
//
// What bounds a step at the flagship (d_model 512, d_ff 2048, 1,024 token
// rows a rank, ring 4), and what the design does about it:
// - Contract mode (q/k/v, fc1 forward; out_proj, fc2 dx): (1024, 128) @ (128,
//   512 | 2048), K 128: 32 operations a byte, far under the card's 295.
//   Reading and writing the float32 accumulator, 8 bytes an output, is
//   10-20x the bf16 operand bytes: the bytes bound it. Tiles are as small as
//   fill the card (at least one block an SM), the contraction is never split,
//   and the epilogue reads and writes the accumulator once, 16 bytes a thread.
// - Out mode and dw (out_proj, fc2 forward; q/k/v, fc1 dx; every dw): a
//   contraction of 512-2048 onto 4-64 output tiles, ~100 operations a byte,
//   within 3x of the card's ratio: the tensor cores' operations count as
//   much as the bytes, and a grid of output tiles alone would leave most SMs
//   idle. The contraction is split over the 2-8 blocks of a thread-block
//   cluster, which sum their partial tiles through distributed shared memory
//   in cluster-rank order: one launch, no atomics, the same bits every run.
//
// bfloat16: tensor cores. A block has one consumer warpgroup for its output
// tile (64 x 128, 64 x 64 or 64 x 32, float32 accumulators in registers,
// wgmma.mma_async m64nNk16 with N 64 or 32) and one warp more: the producer
// on the TMA route. The operands go through a ring of up to
// four shared-memory stages, 64 deep in the contraction, each with a "full"
// and an "empty" mbarrier (no more stages than a block has to load: a K-128
// step takes two, which leaves room for two blocks an SM where the
// accumulator's bytes want every load in flight); every operand is staged in
// the major-ness it has in
// device memory (K-major: 128-byte rows swizzled 128B; MN-major: 64-wide atoms
// swizzled 128B, or one 32-wide atom swizzled 64B), and wgmma reads it
// transposed where it is MN-major, so w_t and a_jᵀ cost no copy. bf16 x bf16
// products are exact in float32 and the sums are float32, so the float32
// limit of the plain version holds. The epilogue issues all of a thread's
// loads (partials, accumulator) for four outputs before it stores any. Two
// loaders fill the same stages:
// - TMA (route 1): one thread of the producer warp issues
//   cp.async.bulk.tensor loads through tensor maps encoded on the host for
//   each launch (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the library links only the runtime), up to
//   four stages in flight; past M, N and K the hardware fills zeros. It needs
//   a 16-byte-aligned base, a unit stride along the staged rows and a row
//   stride that is a multiple of 16 bytes: every step at the flagship.
// - Per-thread (route 2), for views TMA cannot take (column blocks of 50 or
//   75 elements, rows of 7 or 20): every thread of the block reads elements
//   through the two strides and stores them, zero-filled past M, N and K, at
//   the swizzled places TMA would, two stages double-buffered under the
//   products. cp.async cannot take these sources either: its smallest copy
//   is 4 bytes, and such a view's elements are only 2-byte aligned.
// The caller (ops/overlap_collectives.py, step_plan) chooses the route, the
// tile and the split before the launch; nothing here retries another route.
//
// float32 (route 0): CUDA cores, as before (TF32 would break the 1e-5 float32
// limit): blocks of 256 threads with 4 x 4 outputs a thread, operands staged
// through shared memory in 32-deep slices, fused multiply-adds in ascending
// k; a 64 x 64 output tile, or a 32 x 32 tile with the contraction split over
// four thread groups of one block (summed in group order).
//
// Plain C interface (ctypes): each entry point launches on the given stream,
// never synchronises, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a plan or operands it does not take).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

// ---------------------------------------------------------------------------
// float32: CUDA-core tiles
// ---------------------------------------------------------------------------

constexpr int kDepth = 32;     // contraction depth of one shared-memory slice
constexpr int kThreads = 256;  // threads of a block
constexpr int kPer = 4;        // 4 x 4 outputs a thread

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
template <int TILE, int SPLIT>
__device__ __forceinline__ void tile_product(const float* __restrict__ A, long long sai,
                                             long long sak, const float* __restrict__ B,
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
      As[g][kk][ii] = (gi < M && gk < K) ? A[gi * sai + gk * sak] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < (TILE * kDepth) / kGroup; ++r) {
      const int e = tid + r * kGroup;
      const int jj = b_j_unit ? e % TILE : e / kDepth;
      const int kk = b_j_unit ? e / TILE : e % kDepth;
      const int gj = j0 + jj, gk = k0 + kk;
      Bs[g][kk][jj] = (gj < N && gk < K) ? B[gk * sbk + gj * sbj] : 0.f;
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
template <int TILE, int SPLIT>
__global__ void __launch_bounds__(kThreads)
    overlap_ag_step_kernel(const float* __restrict__ x, long long sxm, long long sxk,
                           const float* __restrict__ w, long long swk, long long swn,
                           float* __restrict__ out, long long ldo, int M, int N, int K,
                           int accumulate) {
  constexpr int kSide = TILE / kPer;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  float acc[kPer][kPer] = {};
  tile_product<TILE, SPLIT>(x, sxm, sxk, w, swk, swn, M, N, K, i0, j0, acc);
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
template <int TILE, int SPLIT>
__global__ void __launch_bounds__(kThreads)
    overlap_rs_step_kernel(const float* __restrict__ a, long long sam, long long sai,
                           const float* __restrict__ b, long long sbm, long long sbn,
                           const float* __restrict__ acc_in, float* __restrict__ out,
                           int M, int N, int K) {
  constexpr int kSide = TILE / kPer;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  float acc[kPer][kPer] = {};
  tile_product<TILE, SPLIT>(a, sai, sam, b, sbm, sbn, M, N, K, i0, j0, acc);
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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), operands staged by TMA or by every thread
// ---------------------------------------------------------------------------

constexpr int kMaxStages = 4;      // the ring of shared-memory stages, at most
constexpr int kBK = 64;            // contraction depth of a stage: 128 bytes of bf16
constexpr int kRowBytes = kBK * 2;
constexpr int kAtomBytes = 64 * kRowBytes;  // one MN-major 128B-swizzled atom: 64 x 64

// A bf16 operand in device memory: element (mn, k) at p[mn * s_mn + k * s_k].
struct Operand {
  const uint16_t* p;
  long long s_mn, s_k;
};

// Where a step's float32 result goes: out(i, j) = [src(i, j) +] part(i, j);
// src may be out itself (contract mode's accumulate). vec: both are 16-byte
// aligned a row (base and leading dimension), so whole float4s move.
struct Epilogue {
  float* out;
  long long ldo;
  const float* src;
  long long lds;
  int vec;
};

// A block's output tile is kTM x TN: one consumer warpgroup, whose wgmma
// instructions take 64 rows (m64nNk16), and one warp more.
constexpr int kTM = 64;

template <int TN>
struct TcShape {
  static constexpr int kThreads = 128 + 32;            // the warpgroup + the producer warp
  static constexpr int kNI = TN >= 64 ? 64 : 32;       // columns of one wgmma
  static constexpr int kABytes = kTM * kRowBytes;
  static constexpr int kStageBytes = kABytes + TN * kRowBytes;
  static constexpr int kRedLd = TN + 4;                // floats a row of the partial tile
  static constexpr int kRedBytes = kTM * kRedLd * 4;
  // Dynamic shared memory of a block with `stages` stages (1 KB for alignment).
  static constexpr int smem(int stages) {
    return 1024 + stages * kStageBytes + kRedBytes + 2 * kMaxStages * 8;
  }
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

// One 2-D TMA load of the box at coordinates (c0 innermost, c1) into dst,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy stores to shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across a wgmma wait.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// The wgmma matrix descriptor of a 128B- (layout 1) or 64B-swizzled (layout
// 2) operand in shared memory: start address, and the stride between groups
// of 8 rows (K-major: 8 MN rows; MN-major: 8 K rows) in both offset fields,
// so that the leading offset, which the instructions here never cross (one
// 64- or 32-wide atom an instruction), cannot be misread for it.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t stride, uint64_t layout) {
  const uint64_t s = (stride >> 4) & 0x3FFF;
  return ((saddr & 0x3FFFF) >> 4) | (s << 16) | (s << 32) | (layout << 62);
}

// The descriptor of the 16-deep slice kk of a stage's operand tile (R rows
// along MN), for the instruction whose MN rows start at row0 (a multiple of
// 64, or 0). K-major: rows of 128 bytes, 8-row groups 1,024 bytes apart, a
// slice 32 bytes along the row. MN-major, R >= 64: atoms of 64 MN x 64 K
// rows of 128 bytes, a slice 16 rows down the atom. MN-major, R 32: one atom
// of 64-byte rows swizzled 64B.
template <bool MN, int R>
__device__ __forceinline__ uint64_t operand_desc(uint32_t base, int kk, int row0) {
  if (!MN) return make_desc(base + row0 * kRowBytes + kk * 32, 1024, 1);
  if (R >= 64) return make_desc(base + (row0 / 64) * kAtomBytes + kk * 16 * kRowBytes, 1024, 1);
  return make_desc(base + kk * 16 * 64, 512, 2);
}

// Byte offset of element (mn, k) of a stage's operand tile, swizzled as TMA
// writes it (the 16-byte chunk index XOR the row within its 8-row group; the
// tile's base is 1,024-byte aligned).
template <bool MN, int R>
__device__ __forceinline__ uint32_t stage_offset(int mn, int k) {
  if (!MN) {
    const uint32_t off = mn * kRowBytes + k * 2;
    return off ^ (((off >> 7) & 7) << 4);
  }
  if (R >= 64) {
    const uint32_t off = (mn / 64) * kAtomBytes + k * kRowBytes + (mn % 64) * 2;
    return off ^ (((off >> 7) & 7) << 4);
  }
  const uint32_t off = k * 64 + mn * 2;
  return off ^ (((off >> 7) & 3) << 4);
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


template <int NI, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[NI / 2], uint64_t da, uint64_t db) {
  if constexpr (NI == 64)
    wgmma_n64<TA, TB>(d, da, db);
  else
    wgmma_n32<TA, TB>(d, da, db);
}

// The products of one stage into the consumer warpgroup's accumulators: the
// 64 rows of A against all TN columns of B, four 16-deep slices.
template <int TN, bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_stage(float (&acc)[TN / TcShape<TN>::kNI]
                                                      [TcShape<TN>::kNI / 2],
                                          uint32_t stage) {
  constexpr int NI = TcShape<TN>::kNI;
  const uint32_t sb = stage + TcShape<TN>::kABytes;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = operand_desc<A_MN, kTM>(stage, kk, 0);
#pragma unroll
    for (int j = 0; j < TN / NI; ++j)
      wgmma<NI, A_MN, B_MN>(acc[j], da, operand_desc<B_MN, TN>(sb, kk, j * NI));
  }
}

// TMA: one stage's tile of an operand (R rows along MN from mn0, 64 deep from
// k0). K-major: one box {64 k, R rows}; MN-major: boxes {64 mn, 64 k} a 64-wide
// atom, or one box {32 mn, 64 k}.
template <bool MN, int R>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int mn0, int k0) {
  if (!MN) {
    tma_load(dst, map, bar, k0, mn0);
  } else if (R >= 64) {
#pragma unroll
    for (int j = 0; j < R / 64; ++j) tma_load(dst + j * kAtomBytes, map, bar, mn0 + 64 * j, k0);
  } else {
    tma_load(dst, map, bar, mn0, k0);
  }
}

// Per-thread loader: the same tile, element by element through the strides,
// zero past n_mn rows and K; neighbouring threads walk the staged
// contiguous dimension.
template <bool MN, int R>
__device__ __forceinline__ void thread_tile(uint8_t* dst, const Operand& o, int mn0, int k0,
                                            int n_mn, int K, int tid, int nthreads) {
  for (int e = tid; e < R * kBK; e += nthreads) {
    const int mn = MN ? e % R : e / kBK, k = MN ? e / R : e % kBK;
    const int gmn = mn0 + mn, gk = k0 + k;
    const uint16_t v = (gmn < n_mn && gk < K) ? o.p[gmn * o.s_mn + gk * o.s_k] : uint16_t(0);
    *reinterpret_cast<uint16_t*>(dst + stage_offset<MN, R>(mn, k)) = v;
  }
}

// One ring step's product, a kTM x TN output tile a cluster of `split` blocks
// (the cluster's x extent): block rank r of the cluster takes the 64-deep
// stages [r * nk / split, (r + 1) * nk / split) of the contraction through a
// ring of `stages` shared-memory stages (no more than it has stages to load,
// so that short contractions leave room for more blocks an SM), the cluster
// sums the blocks' partial tiles in rank order, and each block writes
// kTM / split of the tile's rows through the epilogue.
template <int TN, bool A_MN, bool B_MN, bool TMA>
__global__ void __launch_bounds__(TcShape<TN>::kThreads)
    overlap_tc_step_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b, const Operand a,
                           const Operand b, const Epilogue ep, const int M, const int N,
                           const int K, const int stages) {
  using S = TcShape<TN>;
  constexpr int NI = S::kNI;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // swizzle atoms: 1 KB aligned
  float* red = reinterpret_cast<float*>(smem + stages * S::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * S::kStageBytes + S::kRedBytes);
  uint64_t* empty = full + kMaxStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int m0 = blockIdx.y * kTM, n0 = (blockIdx.x / split) * TN;
  const int nk = (K + kBK - 1) / kBK;
  const int kb = rank * nk / split, ke = (rank + 1) * nk / split;
  const int tid = threadIdx.x;
  const bool consumer = tid < 128;

  float acc[TN / NI][NI / 2];
#pragma unroll
  for (int j = 0; j < TN / NI; ++j)
#pragma unroll
    for (int q = 0; q < NI / 2; ++q) acc[j][q] = 0.f;

  if constexpr (TMA) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 128);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (!consumer) {
      if (tid == 128) {  // the producer: keeps up to `stages` loads in flight
        for (int i = 0; i < ke - kb; ++i) {
          const int s = i % stages;
          if (i >= stages) mbar_wait(&empty[s], (i / stages - 1) & 1);
          uint8_t* st = smem + s * S::kStageBytes;
          mbar_expect_tx(&full[s], S::kStageBytes);
          tma_tile<A_MN, kTM>(st, &map_a, &full[s], m0, (kb + i) * kBK);
          tma_tile<B_MN, TN>(st + S::kABytes, &map_b, &full[s], n0, (kb + i) * kBK);
        }
      }
    } else {
      for (int i = 0; i < ke - kb; ++i) {
        const int s = i % stages;
        mbar_wait(&full[s], (i / stages) & 1);
        mma_stage<TN, A_MN, B_MN>(acc, smem_u32(smem + s * S::kStageBytes));
        wg_commit();
        wg_wait<1>();  // the stage before this one is read: hand it back
        if (i > 0) mbar_arrive(&empty[(i - 1) % stages]);
      }
      wg_wait<0>();
    }
  } else {
    const int n_it = ke - kb;
    const auto load = [&](int slot, int it) {
      uint8_t* st = smem + slot * S::kStageBytes;
      thread_tile<A_MN, kTM>(st, a, m0, it * kBK, M, K, tid, S::kThreads);
      thread_tile<B_MN, TN>(st + S::kABytes, b, n0, it * kBK, N, K, tid, S::kThreads);
    };
    if (n_it > 0) load(0, kb);
    fence_proxy_async();
    __syncthreads();
    for (int i = 0; i < n_it; ++i) {
      if (consumer) {
        mma_stage<TN, A_MN, B_MN>(acc, smem_u32(smem + (i & 1) * S::kStageBytes));
        wg_commit();
      }
      if (i + 1 < n_it) load((i + 1) & 1, kb + i + 1);  // under the products in flight
      if (consumer) wg_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
  }

  if (consumer) {  // the partial tile to shared memory (the m64nNk16 accumulator layout)
    const int row = (tid / 32) * 16 + (tid % 32) / 4, col = (tid % 4) * 2;
#pragma unroll
    for (int j = 0; j < TN / NI; ++j)
#pragma unroll
      for (int q = 0; q < NI / 2; q += 2) {
        fence_reg(acc[j][q]);
        fence_reg(acc[j][q + 1]);
        const int r = row + 8 * ((q / 2) % 2), c = j * NI + (q / 4) * 8 + col;
        *reinterpret_cast<float2*>(red + r * S::kRedLd + c) = make_float2(acc[j][q], acc[j][q + 1]);
      }
  }
  cluster.sync();

  // This block's kTM / split rows of the tile: the cluster's partials summed in
  // rank order, then the epilogue, four columns an item. A thread takes kU
  // items at once and issues all their loads (the partials, the accumulator
  // it adds to) before any store, so their latencies overlap; each output is
  // one thread's, so loading src ahead of the stores is safe where src is out.
  constexpr int kVec = TN / 4, kU = 4, kMaxSplit = 8;
  const int rows = kTM / split, items = rows * kVec;
  for (int e0 = tid; e0 < items; e0 += kU * S::kThreads) {
    float4 part[kU], prev[kU];
    int at_i[kU], at_j[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * S::kThreads;
      const int r = rank * rows + e / kVec, c = (e % kVec) * 4;
      at_i[u] = m0 + r;
      at_j[u] = e < items ? n0 + c : N;  // N: no item
      part[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      prev[u] = part[u];
      if (at_j[u] >= N || at_i[u] >= M) continue;
      float4 v[kMaxSplit];
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)
        if (q < split)
          v[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(red + r * S::kRedLd + c, q));
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)
        if (q < split)
          part[u] = make_float4(part[u].x + v[q].x, part[u].y + v[q].y, part[u].z + v[q].z,
                                part[u].w + v[q].w);
      if (ep.src != nullptr && ep.vec && at_j[u] + 4 <= N)
        prev[u] = *reinterpret_cast<const float4*>(
            ep.src + static_cast<long long>(at_i[u]) * ep.lds + at_j[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = at_i[u], j = at_j[u];
      if (j >= N || i >= M) continue;
      float4 p = part[u];
      float* o = ep.out + static_cast<long long>(i) * ep.ldo + j;
      if (ep.vec && j + 4 <= N) {
        if (ep.src != nullptr)
          p = make_float4(prev[u].x + p.x, prev[u].y + p.y, prev[u].z + p.z, prev[u].w + p.w);
        *reinterpret_cast<float4*>(o) = p;
      } else {
        const float* s = ep.src != nullptr ? ep.src + static_cast<long long>(i) * ep.lds + j
                                           : nullptr;
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (j + x < N) o[x] = s != nullptr ? s[x] + pv[x] : pv[x];
      }
    }
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A step's plan (ops/overlap_collectives.py, step_plan): route 0 CUDA cores
// (float32), 1 tensor cores fed by TMA, 2 tensor cores fed by every thread;
// the output tile; the contraction split (route 0: thread groups of a block;
// routes 1-2: blocks of a cluster); whether A (M x K) and B (K x N) are
// staged MN-major.
struct Plan {
  int route, tile_m, tile_n, split, a_mn, b_mn;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                   : nullptr;
  }();
  return fn;
}

// cuTensorMapEncodeTiled, a cu* (not cuda*) call, fails without a context
// current on the calling thread. A runtime launch binds the device's primary
// context only when it runs, so on a thread whose first CUDA work is a ring
// step (autograd's backward thread, where a ring step can be the backward's
// first op) none is current yet; then cudaSetDevice binds it (CUDA 12). Where
// a context is current, nothing changes.
cudaError_t bind_context() {
  using CtxGetCurrent = CUresult (*)(CUcontext*);
  static const CtxGetCurrent get = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuCtxGetCurrent", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuCtxGetCurrent", &p, cudaEnableDefault, &q);
#endif
    return (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<CtxGetCurrent>(p)
                                                                   : nullptr;
  }();
  CUcontext ctx = nullptr;
  if (get != nullptr && get(&ctx) == CUDA_SUCCESS && ctx != nullptr) return cudaSuccess;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  return e == cudaSuccess ? cudaSetDevice(dev) : e;
}

// What TMA takes: a unit stride along the staged rows, a row stride that is a
// multiple of 16 bytes and no smaller than a row, a 16-byte-aligned base.
bool tma_fits(const Operand& o, bool mn_major, int n_mn, int K) {
  const long long unit = mn_major ? o.s_mn : o.s_k, row = mn_major ? o.s_k : o.s_mn;
  const long long extent = mn_major ? n_mn : K;
  return unit == 1 && row % 8 == 0 && row >= extent && row < (1LL << 39) &&
         reinterpret_cast<uintptr_t>(o.p) % 16 == 0;
}

// The tensor map of an operand for tiles of R rows along MN (n_mn of them).
bool encode(CUtensorMap* map, const Operand& o, bool mn_major, int n_mn, int K, int R) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr || !tma_fits(o, mn_major, n_mn, K)) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(mn_major ? n_mn : K),
                              static_cast<cuuint64_t>(mn_major ? K : n_mn)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>((mn_major ? o.s_k : o.s_mn) * 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(mn_major ? (R >= 64 ? 64 : 32) : kBK),
                             static_cast<cuuint32_t>(mn_major ? kBK : R)};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle sw =
      (mn_major && R < 64) ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<uint16_t*>(o.p), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TN, bool A_MN, bool B_MN, bool TMA>
cudaError_t launch_tc(const Operand& a, const Operand& b, const Epilogue& ep, int M, int N,
                      int K, int split, cudaStream_t st) {
  using S = TcShape<TN>;
  const auto kernel = overlap_tc_step_kernel<TN, A_MN, B_MN, TMA>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::smem(kMaxStages));
  if (attr != cudaSuccess) return attr;
  // stages: no more than a block has to load (the per-thread loader double-buffers)
  const int per_block = tiles(tiles(K, kBK), split);
  const int stages = per_block < (TMA ? kMaxStages : 2) ? per_block : (TMA ? kMaxStages : 2);
  CUtensorMap ma{}, mb{};
  if (TMA) {
    const cudaError_t bound = bind_context();
    if (bound != cudaSuccess) return bound;
    if (!(encode(&ma, a, A_MN, M, K, kTM) && encode(&mb, b, B_MN, N, K, TN)))
      return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles(N, TN) * split, tiles(M, kTM));
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::smem(stages);
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ma, mb, a, b, ep, M, N, K, stages);
}

using TcLaunch = cudaError_t (*)(const Operand&, const Operand&, const Epilogue&, int, int, int,
                                 int, cudaStream_t);

template <int TN>
TcLaunch tc_pick(int a_mn, int b_mn, int tma) {
  static const TcLaunch table[8] = {
      launch_tc<TN, false, false, false>, launch_tc<TN, false, false, true>,
      launch_tc<TN, false, true, false>,  launch_tc<TN, false, true, true>,
      launch_tc<TN, true, false, false>,  launch_tc<TN, true, false, true>,
      launch_tc<TN, true, true, false>,   launch_tc<TN, true, true, true>};
  return table[(a_mn ? 4 : 0) | (b_mn ? 2 : 0) | (tma ? 1 : 0)];
}

TcLaunch tc_launcher(const Plan& p) {
  if (p.split != 1 && p.split != 2 && p.split != 4 && p.split != 8) return nullptr;
  if (p.tile_m != kTM) return nullptr;
  const int tma = p.route == 1;
  if (p.tile_n == 128) return tc_pick<128>(p.a_mn, p.b_mn, tma);
  if (p.tile_n == 64) return tc_pick<64>(p.a_mn, p.b_mn, tma);
  if (p.tile_n == 32) return tc_pick<32>(p.a_mn, p.b_mn, tma);
  return nullptr;
}

// The tensor-core step: A (M x K) and B (K x N) bf16, the epilogue's float32
// out. Returns cudaErrorInvalidValue for a plan it has no instance for, or
// operands the plan's route cannot take.
int tc_step(const Operand& a, const Operand& b, const Epilogue& ep, int M, int N, int K,
            const Plan& p, cudaStream_t st) {
  const TcLaunch launch = tc_launcher(p);
  if (launch == nullptr || (p.route != 1 && p.route != 2)) return cudaErrorInvalidValue;
  const cudaError_t rc = launch(a, b, ep, M, N, K, p.split, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

bool vec_ok(const float* p, long long ld) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0);
}

bool bad_dims(int M, int N, int K) { return M < 1 || N < 1 || K < 1 || tiles(M, 32) > 65535; }

// float32: the 32 x 32 tiles with four groups, or 64 x 64 with one.
bool f32_plan_ok(const Plan& p) {
  return p.route == 0 && p.tile_m == p.tile_n &&
         ((p.tile_m == 32 && p.split == 4) || (p.tile_m == 64 && p.split == 1));
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x and w alike); the plan as in struct Plan.
extern "C" int dtc_overlap_ag_step(const void* x, long long sxm, long long sxk, const void* w,
                                   long long swk, long long swn, void* out, long long ldo,
                                   int M, int N, int K, int accumulate, int dtype, int route,
                                   int tile_m, int tile_n, int split, int a_mn, int b_mn,
                                   void* stream) {
  const Plan p{route, tile_m, tile_n, split, a_mn, b_mn};
  if (bad_dims(M, N, K) || (dtype != 0 && dtype != 1) || ((dtype == 0) != (route == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    const Operand a{static_cast<const uint16_t*>(x), sxm, sxk};
    const Operand b{static_cast<const uint16_t*>(w), swn, swk};
    const float* src = accumulate ? o : nullptr;
    const Epilogue ep{o, ldo, src, ldo, vec_ok(o, ldo) ? 1 : 0};
    return tc_step(a, b, ep, M, N, K, p, st);
  }
  if (!f32_plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  if (tile_m == 32)
    overlap_ag_step_kernel<32, 4><<<dim3(tiles(N, 32), tiles(M, 32)), kThreads, 0, st>>>(
        xp, sxm, sxk, wp, swk, swn, o, ldo, M, N, K, accumulate);
  else
    overlap_ag_step_kernel<64, 1><<<dim3(tiles(N, 64), tiles(M, 64)), kThreads, 0, st>>>(
        xp, sxm, sxk, wp, swk, swn, o, ldo, M, N, K, accumulate);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtc_overlap_rs_step(const void* a, long long sam, long long sai, const void* b,
                                   long long sbm, long long sbn, const void* acc_in, void* out,
                                   int M, int N, int K, int dtype, int route, int tile_m,
                                   int tile_n, int split, int a_mn, int b_mn, void* stream) {
  const Plan p{route, tile_m, tile_n, split, a_mn, b_mn};
  if (bad_dims(M, N, K) || (dtype != 0 && dtype != 1) || ((dtype == 0) != (route == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* acc = static_cast<const float*>(acc_in);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    const Operand ta{static_cast<const uint16_t*>(a), sai, sam};  // A = a_jᵀ: (i, m)
    const Operand tb{static_cast<const uint16_t*>(b), sbn, sbm};
    const Epilogue ep{o, N, acc, N, (vec_ok(o, N) && vec_ok(acc, N)) ? 1 : 0};
    return tc_step(ta, tb, ep, M, N, K, p, st);
  }
  if (!f32_plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  if (tile_m == 32)
    overlap_rs_step_kernel<32, 4><<<dim3(tiles(N, 32), tiles(M, 32)), kThreads, 0, st>>>(
        ap, sam, sai, bp, sbm, sbn, acc, o, M, N, K);
  else
    overlap_rs_step_kernel<64, 1><<<dim3(tiles(N, 64), tiles(M, 64)), kThreads, 0, st>>>(
        ap, sam, sai, bp, sbm, sbn, acc, o, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a tensor-core instance's block with `stages`
// stages (0: no such tile or stage count).
extern "C" int dtc_overlap_tc_smem_bytes(int tile_m, int tile_n, int stages) {
  if (stages < 1 || stages > kMaxStages || tile_m != kTM) return 0;
  if (tile_n == 128) return TcShape<128>::smem(stages);
  if (tile_n == 64) return TcShape<64>::smem(stages);
  if (tile_n == 32) return TcShape<32>::smem(stages);
  return 0;
}

extern "C" const char* dtc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
