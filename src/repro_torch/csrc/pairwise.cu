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
// step) one call reads 2.0 MB, writes 1.0 MB and does 0.21 GFLOP of
// products. On an H100 SXM (data sheet: 3.35 TB/s; 495 TFLOP/s of dense
// TF32, so 165 TFLOP/s for products taken as three TF32 products; 67
// TFLOP/s of fp32 outside the tensor cores) that is ~0.9 us of bytes
// against ~1.3 us of tensor work: the kernel is bound by operations, and at
// this size by filling the card and by the conversions around each product.
//
// dot and l2sq (pairwise_mma_kernel): the product runs on the tensor cores
// as mma.sync m16n8k8 in TF32, and keeps fp32 accuracy (the 2e-5 gate
// against the plain version) by 3xTF32: each operand x is split into
// x_hi = tf32(x) and x_lo = tf32(x - x_hi), and a.b is taken as a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi into one fp32 accumulator; the dropped a_lo.b_lo is
// 2^-22 of |a||b|. A block computes a 32 x 32 output tile with 4 warps of
// 16 x 16 (one m16 tile, two n8 tiles), so the path's 1024 x 256 product is
// 256 blocks, two an SM. It stages 32-column chunks of o and negs in shared
// memory with cp.async (16 bytes a copy when D is a multiple of 4, else 4),
// two stages, so the next chunk's copies fly while the current one is
// multiplied. Rows are padded to 36 floats, so both the fragment reads (8
// rows x 4 columns a warp) and the copies are free of bank conflicts. For
// l2sq the row and column norms are fp32 FMA sums over the same staged
// chunks (4 threads a row, interleaved columns) and combine in the epilogue
// as the reference's expansion does (kge_score.py:43-48).
//
// l1 (pairwise_l1_kernel): the tensor cores cannot take |a - b|. A block
// computes a 32 x 64 tile; 32 x 32 and 64 x 32 chunks along D are staged in
// shared memory (stored transposed with one pad column), the next chunk's
// loads in flight during the current one's work, and each of 256 threads
// keeps a 2 x 4 register micro-tile of fp32 sums; |o - n| never
// materialises (B, K, D).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// l1: fp32 FMA-unit loop
// ---------------------------------------------------------------------------
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

// One thread's share of a (rows x kTileD) chunk at d0, read from global
// memory into registers; out-of-range rows and columns read as zero, which
// adds nothing (|0 - 0| = 0).
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

__global__ void __launch_bounds__(kThreads)
pairwise_l1_kernel(const float* __restrict__ o, const float* __restrict__ n,
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
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
    for (int j = 0; j < kMicroCols; ++j) acc[i][j] = 0.f;
  }

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
#pragma unroll
      for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
        for (int j = 0; j < kMicroCols; ++j) {
          acc[i][j] += fabsf(a[i] - b[j]);
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
      out[(size_t)row * K + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dot and l2sq: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------
enum Mode { kDot = 0, kL2sq = 1, kL1 = 2 };

constexpr int kMmaWarps = 4;               // 2 x 2 warps of 16 x 16
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kBM = 32;                    // o rows a block
constexpr int kBN = 32;                    // negatives a block
constexpr int kBK = 32;                    // D chunk a stage
constexpr int kLd = kBK + 4;               // padded row: conflict-free reads
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

// Copies of one (kBM or kBN) x kBK chunk at d0 into `tile`; rows past
// `rows` and columns past D become zeros, which add nothing to any sum.
template <int VEC>
__device__ __forceinline__ void stage_chunk(float (*tile)[kLd],
                                            const float* __restrict__ x,
                                            int row0, int rows, int D, int d0) {
  constexpr int kPerRow = kBK / VEC;
  constexpr int kCopies = kBM * kPerRow / kMmaThreads;
#pragma unroll
  for (int u = 0; u < kCopies; ++u) {
    const int e = threadIdx.x + kMmaThreads * u;
    const int r = e / kPerRow;
    const int c = (e % kPerRow) * VEC;
    const bool ok = row0 + r < rows && d0 + c < D;
    const float* src = ok ? x + (size_t)(row0 + r) * D + d0 + c : x;
    cp_async<4 * VEC>(&tile[r][c], src, ok);
  }
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(kMmaThreads)
pairwise_mma_kernel(const float* __restrict__ o, const float* __restrict__ n,
                    float* __restrict__ out, int B, int K, int D) {
  static_assert(kBM == kBN, "one staging routine for both operands");
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
  stage_chunk<VEC>(so[0], o, b0, B, D, 0);
  stage_chunk<VEC>(sn[0], n, k0, K, D, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int st = c % kStages;
    if (c + 1 < chunks) {  // in flight while this chunk is multiplied
      stage_chunk<VEC>(so[(c + 1) % kStages], o, b0, B, D, (c + 1) * kBK);
      stage_chunk<VEC>(sn[(c + 1) % kStages], n, k0, K, D, (c + 1) * kBK);
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

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
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
    case kL1: {
      const dim3 grid((K + kTileCols - 1) / kTileCols,
                      (B + kTileRows - 1) / kTileRows, G);
      pairwise_l1_kernel<<<grid, kThreads, 0, s>>>(o, negs, out, B, K, D);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
