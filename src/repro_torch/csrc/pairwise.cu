// Joint-negative pairwise KGE scores (paper §3.3, T1), fp32 on Hopper.
//
//   (G, B, D) o  x  (G, K, D) negs  ->  (G, B, K) out, one (B, K) product per
//   negative group g:
//     dot  : out = o . n
//     l2sq : out = (||o||^2 - 2 o . n) + ||n||^2
//     l1   : out = sum_d |o_d - n_d|
//
// Replaces the TPU kernel src/repro/kernels/kge_score/kge_score.py
// pairwise_pallas (_pairwise_kernel), whose vmap over negative groups and
// tile padding lived in the JAX wrapper. Here the group is a grid dimension
// and the ragged edges are masked in the kernel, so no caller pads.
//
// Both kernels stage chunks of D columns of o and negs in shared memory with
// cp.async (16 bytes a copy when D is a multiple of 4 and both operands sit
// on 16-byte boundaries, else 4), rows padded by 4 floats, so that reads of
// 8 rows at one column offset fall in 8 different bank groups; two stages,
// the next chunk's copies in flight while the current one is computed. Rows
// past B or K and columns past D are staged as zeros.
//
// dot and l2sq (pairwise_mma_kernel). What bounds it: on the training path
// (B=1024, K=256, D=400, two calls a step) one call reads 2.0 MB, writes
// 1.0 MB and does 0.21 GFLOP of products. On an H100 SXM (data sheet: 3.35
// TB/s; 495 TFLOP/s of dense TF32, so 165 TFLOP/s for products taken as
// three TF32 products) that is ~0.9 us of bytes against ~1.3 us of tensor
// work: the kernel is bound by operations, and at this size by filling the
// card and by the conversions around each product. The product runs on the
// tensor cores as mma.sync m16n8k8 in TF32, and keeps fp32 accuracy (the
// 2e-5 gate against the plain version) by 3xTF32: each operand x is split
// into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi into one fp32 accumulator; the dropped
// a_lo.b_lo is 2^-22 of |a||b|. A block computes a 32 x 32 output tile with
// 4 warps of 16 x 16 (one m16 tile, two n8 tiles) from 32-column chunks, so
// the path's 1024 x 256 product is 256 blocks, two an SM. For l2sq the row
// and column norms are fp32 FMA sums over the same staged chunks (4 threads
// a row, interleaved columns) and combine in the epilogue as the
// reference's expansion does (kge_score.py:43-48).
//
// l1 (pairwise_l1_kernel). The tensor cores cannot take |a - b|, and no
// Hopper instruction computes acc + |a - b|: an element pair is a subtract
// and an add with |.| on its operand, two fp32 issue slots. What bounds it:
// 3 operations an element pair at the data sheet's 67 TFLOP/s of fp32 is
// 4.70 us on the training path (1 x 1024 x 256 x 400) and 137.10 us at
// eval's chunk (1 x 512 x 14,951 x 400); the two issue slots, at 132 SMs x
// 128 lanes x 1.98 GHz, are the true floor: 6.27 us and 183.1 us. Device
// memory (3.1 and 55 MB) takes 0.9 and 16 us, but every tile re-stages its
// rows from L2: 4 (1/rows + 1/cols) bytes an element pair. So the kernel is
// bound by issue and, at small tiles, by L2, and the design spends as few
// other instructions and staged bytes as the card's fill allows:
//   - a block of 128 threads (8 rows x 16 columns of threads; a warp is 2
//     rows of 16) keeps MR x MC sums a thread, rows ty + 8 i of o and
//     negatives tx + 16 j, and reads them as float4s along D: per 4
//     columns MR + MC 16-byte shared reads for 16 MR MC element pairs. A
//     warp's read of o touches 2 rows (one 128-byte wavefront, broadcast),
//     of negs 16 rows (two wavefronts);
//   - two tile shapes: wide, 8 x 4 sums a thread, 64 x 64 tiles, 32-column
//     chunks: 0.5 bytes of shared-memory wavefronts and 0.125 staged bytes
//     an element pair (the register-staged kernel before it read 3 bytes
//     of wavefronts); narrow, 4 x 2 sums, 32 x 32 tiles, 64-column chunks
//     (half the barriers; the whole chunk unrolled): 1.0 and 0.25 bytes, and
//     four times the blocks: the path's 1024 x 256 outputs are 64 wide
//     tiles, one block of 4 warps on half the SMs, and 256 narrow ones, two
//     an SM. The plan (plan.cuh's cost model, with the narrow tile's
//     measured cost an element pair) takes narrow tiles where wide ones
//     would leave SMs idle: narrow on the path, wide at eval's chunk;
//   - the columns past D in a chunk are zeros and are skipped.
// pairwise_l1_plan reports the tile a launch takes. Every output is summed
// by one thread in a fixed order, d ascending, with no atomics, so two calls
// give the same bits. |x - x| is +0 and a sum of +0s is +0; a NaN or an inf
// in a row propagates as in the plain version.

#include <cuda_runtime.h>

#include <cstdint>

#include "plan.cuh"

namespace {

enum Mode { kDot = 0, kL2sq = 1, kL1 = 2 };

// ---------------------------------------------------------------------------
// staging, both kernels
// ---------------------------------------------------------------------------
constexpr int kBK = 32;       // D chunk a stage
constexpr int kLd = kBK + 4;  // padded row: conflict-free reads

// cp.async of `bytes` (4 or 16) from global to shared memory; with `pred`
// false it reads nothing and writes zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? BYTES : 0;
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copies of one ROWS x BK chunk at column d0 into `tile` (rows of BK + 4
// floats) by THREADS threads, VEC floats a copy; rows past `rows` and
// columns past D become zeros, which add nothing to any sum.
template <int VEC, int ROWS, int THREADS, int BK>
__device__ __forceinline__ void stage_chunk(float (*tile)[BK + 4],
                                            const float* __restrict__ x,
                                            int row0, int rows, int D, int d0) {
  constexpr int kPerRow = BK / VEC;
  static_assert(ROWS * kPerRow % THREADS == 0, "whole copies per thread");
  constexpr int kCopies = ROWS * kPerRow / THREADS;
#pragma unroll
  for (int u = 0; u < kCopies; ++u) {
    const int e = threadIdx.x + THREADS * u;
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * VEC;
    const bool ok = row0 + r < rows && d0 + c < D;
    const float* src = ok ? x + (size_t)(row0 + r) * D + d0 + c : x;
    cp_async<4 * VEC>(&tile[r][c], src, ok);
  }
}

// ---------------------------------------------------------------------------
// l1: fp32 subtract-and-add loop
// ---------------------------------------------------------------------------
constexpr int kTR = 8;                 // thread rows (o)
constexpr int kTC = 16;                // thread columns (negatives)
constexpr int kL1Threads = kTR * kTC;

// A tile of MR x MC micro-tiles, (8 MR) rows of o x (16 MC) negatives,
// staged in chunks of BK columns.
template <int MR, int MC, int BK>
struct L1Stage {
  static constexpr int kRows = MR * kTR;
  static constexpr int kCols = MC * kTC;
  float o[2][kRows][BK + 4];  // two stages
  float n[2][kCols][BK + 4];
};

template <int MR, int MC, int BK, int VEC>
__global__ void __launch_bounds__(kL1Threads, 512 / kL1Threads)
pairwise_l1_kernel(const float* __restrict__ o, const float* __restrict__ n,
                   float* __restrict__ out, int B, int K, int D) {
  using Stage = L1Stage<MR, MC, BK>;
  constexpr int BM = Stage::kRows;
  constexpr int kL1Cols = Stage::kCols;
  // a small micro-tile runs few warps' worth of sums: unroll a whole chunk
  constexpr int kUnroll = MR * MC <= 8 ? BK / 4 : 2;
  extern __shared__ float4 l1_smem_raw[];
  Stage& sm = *reinterpret_cast<Stage*>(l1_smem_raw);

  const int k0 = blockIdx.x * kL1Cols;
  const int b0 = blockIdx.y * BM;
  const size_t g = blockIdx.z;
  o += g * B * D;
  n += g * K * D;
  out += g * B * K;

  const int tx = threadIdx.x % kTC;
  const int ty = threadIdx.x / kTC;

  float acc[MR][MC];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;
  }

  const int nch = (D + BK - 1) / BK;
  auto stage = [&](int st, int ch) {
    stage_chunk<VEC, BM, kL1Threads, BK>(sm.o[st], o, b0, B, D, ch * BK);
    stage_chunk<VEC, kL1Cols, kL1Threads, BK>(sm.n[st], n, k0, K, D, ch * BK);
  };
  if (nch > 0) stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch & 1;
    cp_async_wait<0>();  // chunk ch has landed
    // every thread's copies have landed, and every thread is done with the
    // other stage, which the next copies overwrite
    __syncthreads();
    if (ch + 1 < nch) stage(st ^ 1, ch + 1);  // in flight while this chunk is computed
    cp_async_commit();

    const float (*so)[BK + 4] = sm.o[st];
    const float (*sn)[BK + 4] = sm.n[st];
    auto step = [&](int c) {  // columns c .. c + 3 of the chunk
      float4 nv[MC];
#pragma unroll
      for (int j = 0; j < MC; ++j)
        nv[j] = *reinterpret_cast<const float4*>(&sn[tx + kTC * j][c]);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const float4 ov = *reinterpret_cast<const float4*>(&so[ty + kTR * i][c]);
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          acc[i][j] += fabsf(ov.x - nv[j].x);
          acc[i][j] += fabsf(ov.y - nv[j].y);
          acc[i][j] += fabsf(ov.z - nv[j].z);
          acc[i][j] += fabsf(ov.w - nv[j].w);
        }
      }
    };
    const int cols = D - ch * BK;  // the staged zeros past D add nothing: skip them
    if (cols >= BK) {
#pragma unroll (kUnroll)
      for (int c = 0; c < BK; c += 4) step(c);
    } else {
#pragma unroll 1
      for (int c = 0; c < cols; c += 4) step(c);
    }
  }

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int row = b0 + ty + kTR * i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < MC; ++j) {
      const int col = k0 + tx + kTC * j;
      if (col < K) out[(size_t)row * K + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dot and l2sq: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;               // 2 x 2 warps of 16 x 16
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kBM = 32;                    // o rows a block
constexpr int kBN = 32;                    // negatives a block
constexpr int kStages = 2;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each exact in TF32 (lo keeps the next 11 bits of x)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) . b (8 x 8, col), TF32 in, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(kMmaThreads)
pairwise_mma_kernel(const float* __restrict__ o, const float* __restrict__ n,
                    float* __restrict__ out, int B, int K, int D) {
  __shared__ __align__(16) float so[kStages][kBM][kLd];
  __shared__ __align__(16) float sn[kStages][kBN][kLd];
  __shared__ float s_o2[kBM], s_n2[kBN];

  const int b0 = blockIdx.y * kBM;
  const int k0 = blockIdx.x * kBN;
  const size_t g = blockIdx.z;
  o += g * B * D;
  n += g * K * D;
  out += g * B * K;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, tg = lane % 4;   // the fragments' row and column
  const int wm = (warp / 2) * 16, wn = (warp % 2) * 16;
  // l2sq norms: 4 threads a row, each every 4th column of a chunk
  const int nr = threadIdx.x / 4, nq = threadIdx.x % 4;

  float acc[2][4] = {};
  float o2 = 0.f, n2 = 0.f;

  const int chunks = (D + kBK - 1) / kBK;
  stage_chunk<VEC, kBM, kMmaThreads, kBK>(so[0], o, b0, B, D, 0);
  stage_chunk<VEC, kBN, kMmaThreads, kBK>(sn[0], n, k0, K, D, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages;
    if (c + 1 < chunks) {  // in flight while this chunk is multiplied
      stage_chunk<VEC, kBM, kMmaThreads, kBK>(so[(c + 1) % kStages], o, b0, B, D,
                                              (c + 1) * kBK);
      stage_chunk<VEC, kBN, kMmaThreads, kBK>(sn[(c + 1) % kStages], n, k0, K, D,
                                              (c + 1) * kBK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: chunk c has landed
    __syncthreads();

    const float (*A)[kLd] = so[st];
    const float (*Bt)[kLd] = sn[st];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(A[wm + gr][kk + tg], ah[0], al[0]);
      split_tf32(A[wm + gr + 8][kk + tg], ah[1], al[1]);
      split_tf32(A[wm + gr][kk + tg + 4], ah[2], al[2]);
      split_tf32(A[wm + gr + 8][kk + tg + 4], ah[3], al[3]);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(Bt[wn + 8 * t + gr][kk + tg], bh0, bl0);
        split_tf32(Bt[wn + 8 * t + gr][kk + tg + 4], bh1, bl1);
        mma_tf32(acc[t], al, bh0, bh1);  // the small terms first
        mma_tf32(acc[t], ah, bl0, bl1);
        mma_tf32(acc[t], ah, bh0, bh1);
      }
    }
    if (MODE == kL2sq) {
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const float a = A[nr][nq + 4 * i], b = Bt[nr][nq + 4 * i];
        o2 = fmaf(a, a, o2);
        n2 = fmaf(b, b, n2);
      }
    }
    __syncthreads();  // before the next copies overwrite this stage
  }

  if (MODE == kL2sq) {
    o2 += __shfl_xor_sync(0xffffffffu, o2, 1);
    o2 += __shfl_xor_sync(0xffffffffu, o2, 2);
    n2 += __shfl_xor_sync(0xffffffffu, n2, 1);
    n2 += __shfl_xor_sync(0xffffffffu, n2, 2);
    if (nq == 0) {
      s_o2[nr] = o2;
      s_n2[nr] = n2;
    }
    __syncthreads();
  }

  // acc[t]: rows wm + gr (+8), columns wn + 8t + 2tg (+1)
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + gr + 8 * h;
      if (b0 + r >= B) continue;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = wn + 8 * t + 2 * tg + x;
        if (k0 + col >= K) continue;
        float v = acc[t][2 * h + x];
        if (MODE == kL2sq) v = (s_o2[r] - 2.f * v) + s_n2[col];
        out[(size_t)(b0 + r) * K + k0 + col] = v;
      }
    }
  }
}

template <int MODE>
void launch_mma(const float* o, const float* negs, float* out, int G, int B,
                int K, int D, cudaStream_t s) {
  const dim3 grid((K + kBN - 1) / kBN, (B + kBM - 1) / kBM, G);
  // 16-byte copies need whole 4-float groups on 16-byte boundaries
  const bool vec = D % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(negs)) % 16 == 0;
  if (vec) {
    pairwise_mma_kernel<MODE, 4><<<grid, kMmaThreads, 0, s>>>(o, negs, out, B, K, D);
  } else {
    pairwise_mma_kernel<MODE, 1><<<grid, kMmaThreads, 0, s>>>(o, negs, out, B, K, D);
  }
}

// ---------------------------------------------------------------------------
// l1: plan and launch
// ---------------------------------------------------------------------------
// Two tile shapes: wide (8 x 4 micro-tiles, 64 x 64 tiles) and narrow (4 x 2
// micro-tiles, 32 x 32 tiles), which makes four times the blocks where wide
// tiles would leave SMs idle, at a higher cost an element pair (more shared
// reads and staged bytes per pair).
constexpr int kWideBK = 32, kNarrowBK = 64;  // chunk widths
// narrow's cost an element pair over wide's, both tiles unsplit at eval's
// chunk, where each fills the card (PERF.md, the variants timed)
constexpr double kNarrowCost = 1.10;
using WideStage = L1Stage<8, 4, kWideBK>;
using NarrowStage = L1Stage<4, 2, kNarrowBK>;

template <int MR, int MC, int BK>
void l1_allow_smem() {
  constexpr int bytes = sizeof(L1Stage<MR, MC, BK>);
  cudaFuncSetAttribute(pairwise_l1_kernel<MR, MC, BK, 4>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncSetAttribute(pairwise_l1_kernel<MR, MC, BK, 1>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The blocks an SM holds of each tile shape, read once a device (which also
// lifts each variant's dynamic shared-memory limit).
const int* l1_blocks() {
  static std::once_flag once[plan::kMaxDevices];
  static int blocks[plan::kMaxDevices][2];  // [device][wide]
  const int slot = plan::once_per_device(once, [](int, int s) {
    l1_allow_smem<8, 4, kWideBK>();
    l1_allow_smem<4, 2, kNarrowBK>();
    blocks[s][0] = plan::blocks_per_sm(pairwise_l1_kernel<4, 2, kNarrowBK, 4>,
                                       kL1Threads, sizeof(NarrowStage));
    blocks[s][1] = plan::blocks_per_sm(pairwise_l1_kernel<8, 4, kWideBK, 4>,
                                       kL1Threads, sizeof(WideStage));
  });
  return blocks[slot];
}

// Tile rows (64: wide, 32: narrow): the least cost (plan.cuh, unsplit), a
// tile's work counted in element pairs of a column.
int plan_l1(int G, int B, int K, int D) {
  const int* blocks = l1_blocks();
  const int sms = plan::sm_count();
  double best = -1;
  int rows = 64;
  for (int wide = 1; wide >= 0; --wide) {
    const int h = wide ? 64 : 32;  // rows and columns of a tile
    const int bk = wide ? kWideBK : kNarrowBK;
    const long long tiles = (long long)G * ((B + h - 1) / h) * ((K + h - 1) / h);
    const double c = plan::cost(sms, tiles, (D + bk - 1) / bk, 1, blocks[wide],
                                kL1Threads / 32,
                                (double)h * h * bk * (wide ? 1.0 : kNarrowCost));
    if (best < 0 || c < best) {
      best = c;
      rows = h;
    }
  }
  return rows;
}

template <int MR, int MC, int BK, int VEC>
void launch_l1(const float* o, const float* negs, float* out, int G, int B, int K,
               int D, cudaStream_t s) {
  using Stage = L1Stage<MR, MC, BK>;
  const dim3 grid((K + Stage::kCols - 1) / Stage::kCols,
                  (B + Stage::kRows - 1) / Stage::kRows, G);
  pairwise_l1_kernel<MR, MC, BK, VEC><<<grid, kL1Threads, sizeof(Stage), s>>>(
      o, negs, out, B, K, D);
}

void launch_l1_planned(const float* o, const float* negs, float* out, int G, int B,
                       int K, int D, cudaStream_t s) {
  const int rows = plan_l1(G, B, K, D);
  // 16-byte copies need whole 4-float groups on 16-byte boundaries
  const bool vec = D % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(o) | reinterpret_cast<uintptr_t>(negs)) % 16 == 0;
  if (rows == 64 && vec) {
    launch_l1<8, 4, kWideBK, 4>(o, negs, out, G, B, K, D, s);
  } else if (rows == 64) {
    launch_l1<8, 4, kWideBK, 1>(o, negs, out, G, B, K, D, s);
  } else if (vec) {
    launch_l1<4, 2, kNarrowBK, 4>(o, negs, out, G, B, K, D, s);
  } else {
    launch_l1<4, 2, kNarrowBK, 1>(o, negs, out, G, B, K, D, s);
  }
}

}  // namespace

// The tile height (rows of o; the tile is as many negatives wide) that the
// l1 launch picks for this call on the current device.
extern "C" int pairwise_l1_plan(int G, int B, int K, int D) {
  return plan_l1(G, B, K, D);
}

// Launch on `stream`; returns the launch's error (0 = launched).
extern "C" int pairwise_launch(const float* o, const float* negs, float* out,
                               int G, int B, int K, int D, int mode,
                               void* stream) {
  if (G <= 0 || B <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDot:
      launch_mma<kDot>(o, negs, out, G, B, K, D, s);
      break;
    case kL2sq:
      launch_mma<kL2sq>(o, negs, out, G, B, K, D, s);
      break;
    case kL1:
      launch_l1_planned(o, negs, out, G, B, K, D, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
