// Backward of the joint-negative L1 pairwise reduction (paper §3.3, T1),
// fp32 on Hopper.
//
//   out[r, d] = sum_c w[r, c] * sign(x[r, d] - y[c, d])      per group
//
// Both products of the L1 VJP have this form, for the forward
// s[b, k] = sum_d |o[b, d] - n[k, d]| and its cotangent g (G, B, K):
//   d_o (B, D): x = o, y = n, w = g    (R = B, C = K)
//   d_n (K, D): x = n, y = o, w = g^T  (R = K, C = B), since
//               -sign(o - n) = sign(n - o)
// The d_n launch reads g transposed by stride (template flag TRANS_W),
// without a copy.
//
// Replaces the TPU kernel src/repro/kernels/kge_score/kge_score.py
// l1_bwd_pallas (its two pallas_calls, _l1_do_kernel and _l1_dn_kernel),
// whose tile padding lived in the JAX wrapper and whose negative groups were
// a vmap. Here the group is blockIdx.z and the ragged edges are masked in the
// kernel, so no caller pads. Like the TPU kernel, it never materialises the
// (B, K, D) sign tensor that the plain version builds.
//
// sign(0) is 0, as jnp.sign gives: ties are real on the path (a head and its
// own tail can be one negative row), so the sign is a pair of compares and
// never copysignf, which gives +-1 at 0. The compares are x > y and x < y:
// for any floats they are the signs of the rounded x - y (a difference of
// two unequal finite floats never rounds to 0), and they save the subtract.
//
// What bounds it: on the training path (B = 1024, K = 256, D = 400, one
// group) a launch reads o, n and g (2.9 MB) and writes d_o (1.6 MB) or d_n
// (0.4 MB): ~1.4 us at 3.35 TB/s, against 3 B K D = 0.31 G operations (a
// sign, a product and a sum an element): ~4.7 us at 67 TFLOP/s fp32. It is
// bound by operations and, at this size, by filling 132 SMs.
//
// Design: a block owns a (rows x D-chunk) output tile of one group. Its x
// values stay in registers for the whole reduction, since they do not change
// along c. Chunks of y (kTileC x tile columns) and of w (tile rows x kTileC)
// are staged in shared memory, the next chunk's global loads issued into
// registers while the current one is computed (as in pairwise.cu). Each
// thread accumulates an MR x 4 micro-tile of 4 neighbouring columns in fp32,
// in ascending c: per element two compares and one predicated add (inline
// PTX, so the compiler does not turn them into selects), and one 16-byte
// shared-memory read of y for 4 x MR elements. Reads past an edge give 0: a
// zero w adds nothing, a zero x or y column is never written. Two tile
// shapes: 32 x 64 (MR = 2) when that gives at least one block per SM, else
// 16 x 64 (MR = 1); the path's d_n (256 x 400) is 56 large tiles, 112 small.
// On an H100 SXM at 700 W the path's d_o (1024 x 400) takes 42 us in 224
// large tiles and 49 us in 448 small ones (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;  // 16 x 16 threads
constexpr int kThreads = kSide * kSide;
constexpr int kMD = 4;  // neighbouring columns a thread owns (one float4)
constexpr int kTileC = 32;  // reduction chunk staged in shared memory
constexpr int kSMs = 132;   // H100 SXM

// One thread's share of the y chunk (kTileC x COLS at c0, d0), coalesced
// along d.
template <int COLS, int LOADS>
__device__ __forceinline__ void load_y(const float* __restrict__ y, int C, int D,
                                       int c0, int d0, float (&reg)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = threadIdx.x + kThreads * u;
    const int c = c0 + e / COLS;
    const int d = d0 + e % COLS;
    reg[u] = (c < C && d < D) ? y[(size_t)c * D + d] : 0.f;
  }
}

template <int COLS, int LOADS>
__device__ __forceinline__ void store_y(float (*sy)[COLS], const float (&reg)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = threadIdx.x + kThreads * u;
    sy[e / COLS][e % COLS] = reg[u];
  }
}

// One thread's share of the w chunk (ROWS x kTileC at r0, c0). w[r, c] is
// w[r * C + c], or w[c * R + r] when TRANS_W; the fast thread index walks the
// contiguous one.
template <int ROWS, int LOADS, bool TRANS_W>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int R, int C,
                                       int r0, int c0, float (&reg)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = threadIdx.x + kThreads * u;
    const int r = r0 + (TRANS_W ? e % ROWS : e / kTileC);
    const int c = c0 + (TRANS_W ? e / ROWS : e % kTileC);
    reg[u] = (r < R && c < C)
                 ? (TRANS_W ? w[(size_t)c * R + r] : w[(size_t)r * C + c])
                 : 0.f;
  }
}

template <int ROWS, int LOADS, bool TRANS_W>
__device__ __forceinline__ void store_w(float (*sw)[kTileC + 1],
                                        const float (&reg)[LOADS]) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int e = threadIdx.x + kThreads * u;
    if (TRANS_W) {
      sw[e % ROWS][e / ROWS] = reg[u];
    } else {
      sw[e / kTileC][e % kTileC] = reg[u];
    }
  }
}

// acc += w sign(x - y), with sign(0) = 0: predicated add and subtract.
__device__ __forceinline__ void add_signed(float& acc, float x, float y, float w) {
  asm("{\n\t.reg .pred gt, lt;\n\t"
      "setp.gt.f32 gt, %1, %2;\n\t"
      "setp.lt.f32 lt, %1, %2;\n\t"
      "@gt add.f32 %0, %0, %3;\n\t"
      "@lt sub.f32 %0, %0, %3;\n\t}"
      : "+f"(acc)
      : "f"(x), "f"(y), "f"(w));
}

template <int MR, bool TRANS_W>
__global__ void __launch_bounds__(kThreads)
l1_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ w, float* __restrict__ out,
              int R, int C, int D) {
  constexpr int MD = kMD;
  constexpr int kRows = kSide * MR;
  constexpr int kCols = kSide * MD;
  constexpr int kLoadY = kTileC * kCols / kThreads;
  constexpr int kLoadW = kRows * kTileC / kThreads;
  static_assert(kTileC * kCols % kThreads == 0 && kRows * kTileC % kThreads == 0,
                "whole chunks per thread");
  __shared__ __align__(16) float sy[kTileC][kCols];
  __shared__ float sw[kRows][kTileC + 1];

  const int d0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRows;
  const size_t g = blockIdx.z;
  x += g * R * D;
  y += g * C * D;
  w += g * R * C;
  out += g * R * D;

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;

  float xr[MR][MD];
  float acc[MR][MD];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = r0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < MD; ++j) {
      const int d = d0 + tx * MD + j;
      xr[i][j] = (r < R && d < D) ? x[(size_t)r * D + d] : 0.f;
      acc[i][j] = 0.f;
    }
  }

  float ry[kLoadY];
  float rw[kLoadW];
  load_y<kCols>(y, C, D, 0, d0, ry);
  load_w<kRows, kLoadW, TRANS_W>(w, R, C, r0, 0, rw);
  for (int c0 = 0; c0 < C; c0 += kTileC) {
    store_y<kCols>(sy, ry);
    store_w<kRows, kLoadW, TRANS_W>(sw, rw);
    __syncthreads();
    if (c0 + kTileC < C) {  // in flight while this chunk is computed
      load_y<kCols>(y, C, D, c0 + kTileC, d0, ry);
      load_w<kRows, kLoadW, TRANS_W>(w, R, C, r0, c0 + kTileC, rw);
    }

#pragma unroll 8
    for (int c = 0; c < kTileC; ++c) {
      float wv[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i) wv[i] = sw[ty + kSide * i][c];
      const float4 y4 = *reinterpret_cast<const float4*>(&sy[c][tx * MD]);
      const float yv[MD] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int i = 0; i < MR; ++i) {
#pragma unroll
        for (int j = 0; j < MD; ++j) add_signed(acc[i][j], xr[i][j], yv[j], wv[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int r = r0 + ty + kSide * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < MD; ++j) {
      const int d = d0 + tx * MD + j;
      if (d < D) out[(size_t)r * D + d] = acc[i][j];
    }
  }
}

template <int MR, bool TRANS_W>
void launch(const float* x, const float* y, const float* w, float* out, int G,
            int R, int C, int D, cudaStream_t s) {
  constexpr int kRows = kSide * MR;
  constexpr int kCols = kSide * kMD;
  const dim3 grid((D + kCols - 1) / kCols, (R + kRows - 1) / kRows, G);
  l1_bwd_kernel<MR, TRANS_W><<<grid, kThreads, 0, s>>>(x, y, w, out, R, C, D);
}

template <bool TRANS_W>
void launch_tiled(const float* x, const float* y, const float* w, float* out,
                  int G, int R, int C, int D, cudaStream_t s) {
  const long long large =
      (long long)((D + 63) / 64) * ((R + 31) / 32) * G;  // 32 x 64 tiles
  if (large >= kSMs) {
    launch<2, TRANS_W>(x, y, w, out, G, R, C, D, s);
  } else {
    launch<1, TRANS_W>(x, y, w, out, G, R, C, D, s);
  }
}

}  // namespace

// out (G, R, D) = sum_c w[r, c] sign(x[r] - y[c]) with x (G, R, D),
// y (G, C, D) and w (G, R, C), or w stored (G, C, R) when trans_w. Launch on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int l1_bwd_launch(const float* x, const float* y, const float* w,
                             float* out, int G, int R, int C, int D, int trans_w,
                             void* stream) {
  if (G <= 0 || R <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_w) {
    launch_tiled<true>(x, y, w, out, G, R, C, D, s);
  } else {
    launch_tiled<false>(x, y, w, out, G, R, C, D, s);
  }
  return static_cast<int>(cudaGetLastError());
}
