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
// What bounds it: on the training path (B=1024, K=256, D=400, two calls a
// step) one call reads 2.0 MB, writes 1.0 MB and does 0.21 GFLOP. At the
// data-sheet rates of an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without
// tensor cores) that is ~0.9 us of bytes against ~3.1 us of arithmetic: the
// kernel is bound by fp32 operations, and at this size by filling the card
// and hiding the latency of each D chunk's loads. Tensor cores are not used:
// TF32 would miss the 2e-5 parity with the plain version, and a wgmma
// version is later work.
//
// Design: a block computes one 32 x 64 output tile of one group, so the
// path's 1024 x 256 product is 128 blocks on the card's 132 SMs (a 64 x 64
// tile left half of them idle). It stages 32 x 32 and 64 x 32 chunks of o
// and negs along D in shared memory (coalesced along D, stored transposed
// with one pad column so neither the stores nor the broadcast reads
// conflict). The next chunk's global loads are issued into registers before
// the current chunk is computed, so their latency hides behind the FMAs.
// Each of the 256 threads keeps a 2 x 4 register micro-tile (rows ty + 16 i,
// columns tx + 16 j) of fp32 FMA accumulators. For l2sq the row and column
// norms accumulate in the same D loop and combine in the epilogue as the
// reference's expansion does (kge_score.py:43-48); for l1 the |o - n| sum
// never materialises (B, K, D). The mode is a template parameter, so each
// mode compiles to its own loop.

#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;                  // 16 x 16 threads
constexpr int kThreads = kSide * kSide;
constexpr int kMicroRows = 2;              // micro-tile per thread
constexpr int kMicroCols = 4;
constexpr int kTileRows = kSide * kMicroRows;  // 32 o rows per block
constexpr int kTileCols = kSide * kMicroCols;  // 64 negatives per block
constexpr int kTileD = 32;                 // D chunk staged in shared memory
constexpr int kLoadO = kTileRows * kTileD / kThreads;  // staged per thread
constexpr int kLoadN = kTileCols * kTileD / kThreads;
static_assert(kTileRows * kTileD % kThreads == 0 &&
              kTileCols * kTileD % kThreads == 0, "whole chunks per thread");

enum Mode { kDot = 0, kL2sq = 1, kL1 = 2 };

// One thread's share of a (rows x kTileD) chunk at d0, read from global
// memory into registers; out-of-range rows and columns read as zero, which
// adds nothing in any mode (|0 - 0| = 0, 0 * x = 0).
template <int LOADS>
__device__ __forceinline__ void load_chunk(const float* __restrict__ x,
                                           int row0, int rows, int D, int d0,
                                           float (&reg)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = threadIdx.x + kThreads * u;
    const int r = row0 + e / kTileD;
    const int d = d0 + e % kTileD;
    reg[u] = (r < rows && d < D) ? x[(size_t)r * D + d] : 0.f;
  }
}

template <int LOADS, int WIDTH>
__device__ __forceinline__ void store_chunk(float (*sx)[WIDTH],
                                            const float (&reg)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = threadIdx.x + kThreads * u;
    sx[e % kTileD][e / kTileD] = reg[u];
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const float* __restrict__ o, const float* __restrict__ n,
                float* __restrict__ out, int B, int K, int D) {
  __shared__ float so[kTileD][kTileRows + 1];
  __shared__ float sn[kTileD][kTileCols + 1];

  const int b0 = blockIdx.y * kTileRows;
  const int k0 = blockIdx.x * kTileCols;
  const size_t g = blockIdx.z;
  o += g * B * D;
  n += g * K * D;
  out += g * B * K;

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;

  float acc[kMicroRows][kMicroCols];
  float o2[kMicroRows];
  float n2[kMicroCols];
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
    o2[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMicroCols; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kMicroCols; ++j) n2[j] = 0.f;

  float ro[kLoadO];
  float rn[kLoadN];
  load_chunk(o, b0, B, D, 0, ro);
  load_chunk(n, k0, K, D, 0, rn);
  for (int d0 = 0; d0 < D; d0 += kTileD) {
    store_chunk(so, ro);
    store_chunk(sn, rn);
    __syncthreads();
    if (d0 + kTileD < D) {  // in flight while this chunk is computed
      load_chunk(o, b0, B, D, d0 + kTileD, ro);
      load_chunk(n, k0, K, D, d0 + kTileD, rn);
    }

#pragma unroll 4
    for (int c = 0; c < kTileD; ++c) {
      float a[kMicroRows];
      float b[kMicroCols];
#pragma unroll
      for (int i = 0; i < kMicroRows; ++i) a[i] = so[c][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < kMicroCols; ++j) b[j] = sn[c][tx + kSide * j];
      if (MODE == kL2sq) {
#pragma unroll
        for (int i = 0; i < kMicroRows; ++i) o2[i] = fmaf(a[i], a[i], o2[i]);
#pragma unroll
        for (int j = 0; j < kMicroCols; ++j) n2[j] = fmaf(b[j], b[j], n2[j]);
      }
#pragma unroll
      for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
        for (int j = 0; j < kMicroCols; ++j) {
          if (MODE == kL1) {
            acc[i][j] += fabsf(a[i] - b[j]);
          } else {
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
    const int row = b0 + ty + kSide * i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < kMicroCols; ++j) {
      const int col = k0 + tx + kSide * j;
      if (col >= K) continue;
      float v = acc[i][j];
      if (MODE == kL2sq) v = (o2[i] - 2.f * v) + n2[j];
      out[(size_t)row * K + col] = v;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int pairwise_launch(const float* o, const float* negs, float* out,
                               int G, int B, int K, int D, int mode,
                               void* stream) {
  if (G <= 0 || B <= 0 || K <= 0) return 0;
  const dim3 grid((K + kTileCols - 1) / kTileCols,
                  (B + kTileRows - 1) / kTileRows, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDot:
      pairwise_kernel<kDot><<<grid, kThreads, 0, s>>>(o, negs, out, B, K, D);
      break;
    case kL2sq:
      pairwise_kernel<kL2sq><<<grid, kThreads, 0, s>>>(o, negs, out, B, K, D);
      break;
    case kL1:
      pairwise_kernel<kL1><<<grid, kThreads, 0, s>>>(o, negs, out, B, K, D);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
