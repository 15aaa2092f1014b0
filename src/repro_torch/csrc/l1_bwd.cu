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
// l1_bwd_launch computes one of them (d_n reads g transposed by stride,
// template flag TRANS_W, without a copy); l1_bwd_pair_launch computes both
// from one pass over the (b, k, d) compare pairs, as the training path asks.
//
// Replaces the TPU kernel src/repro/kernels/kge_score/kge_score.py
// l1_bwd_pallas (its two pallas_calls, _l1_do_kernel and _l1_dn_kernel),
// whose tile padding lived in the JAX wrapper and whose negative groups were
// a vmap. Here the group is blockIdx.z and the ragged edges are masked in the
// kernel, so no caller pads. Like the TPU kernel, it never materialises the
// (B, K, D) sign tensor that the plain version builds, and it sums over its
// reduction axes in its own code: no atomics, no library call.
//
// sign(0) is 0, as jnp.sign gives: ties are real on the path (a head and its
// own tail can be one negative row), so the sign is two compares, x > y and
// x < y, that write 1.0 or 0.0 (set.f32), and their difference: -1, 0 or +1
// exactly, and 0 at +-0 against -+0. For any floats the compares are the
// signs of the rounded x - y (a difference of two unequal finite floats
// never rounds to 0). A NaN in x or y fails both and adds nothing. The sign
// then goes into one fma, s w + acc: exactly acc + w, acc - w or acc for a
// finite w, what a predicated add gives, and for a non-finite w a NaN where
// its sign is 0, as in the plain version's product.
//
// What bounds it: on the training path (B = 1024, K = 256, D = 400, one
// group) one product reads o, n and g (2.9 MB) and writes d_o (1.6 MB) or
// d_n (0.4 MB): ~1.4 us at 3.35 TB/s, against 3 B K D = 0.31 G operations
// (a sign, a product and a sum an element): ~4.7 us at 67 TFLOP/s fp32. The
// form costs more: four instructions an element (two compares, a subtract,
// an fma), so 132 SMs x 4 schedulers at 1.98 GHz issue one product in no
// less than ~12.5 us; the pair launch takes five for both products (the sign
// once, an fma into each). It is bound by issue, and by how evenly the
// tiles fill the SMs.
//
// Design: a block owns a (ROWS x 64) output tile of one group and a slice of
// the reduction; the S blocks that share a tile form a thread-block cluster
// along grid x (S = 1, 2, 4 or 8). Each block sums its slice of c in
// ascending order: chunks of y (32 x 64) and of w^T (32 x ROWS) are staged in
// shared memory by cp.async, two stages, the next chunk in flight while the
// current one is computed; a d_n block reads its w rows of g contiguously.
// Chunks whose rows are whole float4s (D % 4 == 0 for y; R % 4 == 0 for a
// d_n block's w) are copied 16 bytes at a time. A warp is one row of 32
// threads; each thread owns an 8 x 2 micro-tile (8 rows, 2 neighbouring
// columns): its x values stay in registers for the whole slice, and per c
// two 16-byte shared-memory reads of w (the same for the whole warp) and one
// 8-byte read of y serve 16 elements and 16 independent accumulators. The
// partial tiles are then combined through distributed shared memory: each
// block of the cluster sums its share of the tile's elements over ranks 0,
// 1, ..., S - 1 in that order and writes it. Reads past an edge give 0: a
// zero w adds nothing, a zero x or y column is never written; an empty
// slice adds nothing.
//
// The pair launch is the d_o kernel (ROWS = 64) that also forms, for each c
// (a k) of its slice, -sum over its rows of w sign(x - y): per thread over
// its 8 rows, then across the block's 8 warps in warp order through shared
// memory, into a (G, K, D) partial for its tile of rows of o. A second
// launch sums the B / 64 partials of each d_n element in order. Every sum
// has a fixed order, so two calls give the same bits.
//
// The tile height and S are chosen per call from the card (its SM count and
// each variant's blocks an SM, read once a device) by the cost model of
// plan.cuh, which the l1 mode of pairwise.cu shares: the plan that gives the
// busiest SM the least work, in chunks, with a chunk's worth of cost a
// block for its prologue and combine, and work stretched where the busiest
// SM holds fewer than 8 warps. l1_bwd_plan reports the choice; PERF.md
// holds the plans timed against each other.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "plan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTX = 32;           // threads along d: a warp is one row of threads
constexpr int kMD = 2;            // neighbouring columns a thread owns
constexpr int kCols = kTX * kMD;  // tile width
constexpr int kC4 = kCols / 4;    // float4s in a row of the tile
constexpr int kMR = 8;            // rows a thread owns
constexpr int kTileC = 32;        // reduction chunk staged in shared memory
constexpr int kPairRows = 64;     // tile height of the pair launch
constexpr int kPairWarps = kPairRows / kMR * kTX / 32;
// the pair launch's per-warp sums of one chunk, [kTileC][kPairWarps][kCols]
constexpr size_t kRedBytes = sizeof(float) * kTileC * kPairWarps * kCols;

template <int ROWS>
struct Stage {
  static constexpr int kWS = ROWS + 4;  // a row of w^T, 16-byte aligned
  float y[2][kTileC][kCols];
  float w[2][kTileC][kWS];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}

// 16 bytes, or zeros where !pred; dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// sign(x - y) as a float, 0 at a tie or a NaN.
__device__ __forceinline__ float sign_of(float x, float y) {
  float gt, lt;
  asm("set.gt.f32.f32 %0, %2, %3;\n\t"
      "set.lt.f32.f32 %1, %2, %3;"
      : "=f"(gt), "=f"(lt)
      : "f"(x), "f"(y));
  return gt - lt;
}

// Stage chunk c0 of y (kTileC x kCols at d0) and of w^T (kTileC x ROWS at
// r0) into stage st; the fast thread index walks the contiguous dimension of
// each source, 16 bytes a copy where rows are whole float4s (vec_y: D % 4 ==
// 0; vec_w: w^T's rows, R % 4 == 0), else 4. Past an edge the copy writes 0.
template <int ROWS, bool TRANS_W>
__device__ __forceinline__ void load_chunk(Stage<ROWS>& sm, int st,
                                           const float* __restrict__ y,
                                           const float* __restrict__ w, int R,
                                           int C, int D, int r0, int c0, int d0,
                                           bool vec_y, bool vec_w) {
  constexpr int T = ROWS / kMR * kTX;
  if (vec_y) {
#pragma unroll
    for (int u = 0; u < kTileC * kC4 / T; ++u) {
      const int e = threadIdx.x + T * u;
      const int c = c0 + e / kC4;
      const int d = d0 + e % kC4 * 4;
      const bool in = c < C && d < D;
      cp_async16(&sm.y[st][e / kC4][e % kC4 * 4], in ? y + (size_t)c * D + d : y, in);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kTileC * kCols / T; ++u) {
      const int e = threadIdx.x + T * u;
      const int c = c0 + e / kCols;
      const int d = d0 + e % kCols;
      const bool in = c < C && d < D;
      cp_async4(&sm.y[st][e / kCols][e % kCols], in ? y + (size_t)c * D + d : y, in);
    }
  }
  if (TRANS_W && vec_w) {
#pragma unroll
    for (int u = 0; u < kTileC * ROWS / 4 / T; ++u) {
      const int e = threadIdx.x + T * u;
      const int r = e % (ROWS / 4) * 4;
      const int c = e / (ROWS / 4);
      const bool in = r0 + r < R && c0 + c < C;
      cp_async16(&sm.w[st][c][r], in ? w + (size_t)(c0 + c) * R + r0 + r : w, in);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kTileC * ROWS / T; ++u) {
      const int e = threadIdx.x + T * u;
      const int r = TRANS_W ? e % ROWS : e / kTileC;
      const int c = TRANS_W ? e / ROWS : e % kTileC;
      const bool in = r0 + r < R && c0 + c < C;
      const size_t at =
          TRANS_W ? (size_t)(c0 + c) * R + r0 + r : (size_t)(r0 + r) * C + c0 + c;
      cp_async4(&sm.w[st][c][r], in ? w + at : w, in);
    }
  }
}

// out as above. With PAIR (x = o, y = n, w = g, ROWS = kPairRows) the
// kernel also writes its tile's share of d_n, for every c of its slice, into
// dn_part[blockIdx.y] (G, C, D), using kRedBytes of dynamic shared memory.
template <int ROWS, bool TRANS_W, bool PAIR>
__global__ void __launch_bounds__(ROWS / kMR * kTX)
l1_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ w, float* __restrict__ out,
              float* __restrict__ dn_part, int R, int C, int D) {
  constexpr int T = ROWS / kMR * kTX;
  static_assert(ROWS * kCols <= 2 * kTileC * kCols, "the partial tile fits in y's stages");
  static_assert(kMD == 2 && kMR % 4 == 0, "a thread reads y as float2, w as float4s");
  static_assert(!PAIR || (ROWS == kPairRows && !TRANS_W), "the pair reads w as g");
  __shared__ __align__(16) Stage<ROWS> sm;
  extern __shared__ float4 red[];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int d0 = static_cast<int>(blockIdx.x) / S * kCols;
  const int r0 = blockIdx.y * ROWS;
  const size_t g = blockIdx.z;
  x += g * R * D;
  y += g * C * D;
  w += g * R * C;
  out += g * R * D;
  if (PAIR) dn_part += (blockIdx.y * (size_t)gridDim.z + g) * C * D;

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  float xr[kMR][kMD];
  float acc[kMR][kMD];
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    const int r = r0 + ty * kMR + i;
#pragma unroll
    for (int j = 0; j < kMD; ++j) {
      const int d = d0 + tx * kMD + j;
      xr[i][j] = (r < R && d < D) ? x[(size_t)r * D + d] : 0.f;
      acc[i][j] = 0.f;
    }
  }

  // this block's slice of the reduction: chunks [ch0, ch1), in order
  const int nch = (C + kTileC - 1) / kTileC;
  const int ch0 = rank * nch / S;
  const int ch1 = (rank + 1) * nch / S;
  const bool vec_y = D % 4 == 0 && aligned16(y);
  const bool vec_w = R % 4 == 0 && aligned16(w);
  if (ch0 < ch1)
    load_chunk<ROWS, TRANS_W>(sm, 0, y, w, R, C, D, r0, ch0 * kTileC, d0, vec_y, vec_w);
  cp_async_commit();
  for (int ch = ch0; ch < ch1; ++ch) {
    const int st = (ch - ch0) & 1;
    if (ch + 1 < ch1)  // in flight while this chunk is computed
      load_chunk<ROWS, TRANS_W>(sm, st ^ 1, y, w, R, C, D, r0, (ch + 1) * kTileC, d0,
                                vec_y, vec_w);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
#pragma unroll 16
    for (int c = 0; c < kTileC; ++c) {
      float wv[kMR];
#pragma unroll
      for (int i = 0; i < kMR; i += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(&sm.w[st][c][ty * kMR + i]);
        wv[i] = w4.x;
        wv[i + 1] = w4.y;
        wv[i + 2] = w4.z;
        wv[i + 3] = w4.w;
      }
      const float2 y2 = *reinterpret_cast<const float2*>(&sm.y[st][c][tx * kMD]);
      const float yv[kMD] = {y2.x, y2.y};
      float neg[kMD] = {};
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
#pragma unroll
        for (int j = 0; j < kMD; ++j) {
          const float s = sign_of(xr[i][j], yv[j]);
          acc[i][j] = fmaf(s, wv[i], acc[i][j]);
          if (PAIR) neg[j] = fmaf(s, -wv[i], neg[j]);
        }
      }
      if (PAIR)  // the warp (one row of threads, ty) sums its 8 rows' share
        reinterpret_cast<float2*>(red)[(c * kPairWarps + ty) * kTX + tx] =
            make_float2(neg[0], neg[1]);
    }
    // before this stage is loaded again; in the pair, also before red is read
    __syncthreads();
    if (PAIR) {  // the chunk's d_n share: the warps' sums in warp order
      for (int e = threadIdx.x; e < kTileC * kC4; e += T) {
        const int c = ch * kTileC + e / kC4;
        const int d = d0 + e % kC4 * 4;
        const float4* v = red + e / kC4 * kPairWarps * kC4 + e % kC4;
        float4 s = v[0];
#pragma unroll
        for (int q = 1; q < kPairWarps; ++q) {
          s.x += v[q * kC4].x;
          s.y += v[q * kC4].y;
          s.z += v[q * kC4].z;
          s.w += v[q * kC4].w;
        }
        if (c < C) {
          const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (d + j < D) dn_part[(size_t)c * D + d + j] = sv[j];
        }
      }
      // the next chunk writes red only after the barrier that follows its wait
    }
  }

  if (S == 1) {
#pragma unroll
    for (int i = 0; i < kMR; ++i) {
      const int r = r0 + ty * kMR + i;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < kMD; ++j) {
        const int d = d0 + tx * kMD + j;
        if (d < D) out[(size_t)r * D + d] = acc[i][j];
      }
    }
    return;
  }

  // combine the cluster's partial tiles, in rank order, through DSMEM
  float4* part = reinterpret_cast<float4*>(&sm.y[0][0][0]);  // ROWS x kCols
#pragma unroll
  for (int i = 0; i < kMR; ++i)
    reinterpret_cast<float2*>(part)[(ty * kMR + i) * kTX + tx] =
        make_float2(acc[i][0], acc[i][1]);
  cluster.sync();
  constexpr int kVecs = ROWS * kC4;
  const int lo = rank * kVecs / S;
  const int hi = (rank + 1) * kVecs / S;
  for (int e = lo + threadIdx.x; e < hi; e += T) {
    float4 s = *cluster.map_shared_rank(part + e, 0);
    for (int q = 1; q < S; ++q) {
      const float4 v = *cluster.map_shared_rank(part + e, q);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int r = r0 + e / kC4;
    const int d = d0 + e % kC4 * 4;
    if (r < R) {
      const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (d + j < D) out[(size_t)r * D + d + j] = sv[j];
    }
  }
  cluster.sync();  // no block leaves while another reads its tile
}

// d_n (n elements, n4 float4s if whole) = the sum of its nt partials, in
// order.
__global__ void l1_dn_combine(const float* __restrict__ part, float* __restrict__ d_n,
                              int nt, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (n % 4 == 0 && aligned16(part) && aligned16(d_n)) {
    const size_t n4 = n / 4;
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (size_t e = first; e < n4; e += stride) {
      float4 s = p4[e];
      for (int t = 1; t < nt; ++t) {
        const float4 v = p4[t * n4 + e];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      reinterpret_cast<float4*>(d_n)[e] = s;
    }
    return;
  }
  for (size_t e = first; e < n; e += stride) {
    float s = part[e];
    for (int t = 1; t < nt; ++t) s += part[t * n + e];
    d_n[e] = s;
  }
}

template <int ROWS, bool TRANS_W, bool PAIR = false>
cudaError_t launch(const float* x, const float* y, const float* w, float* out, int G,
                   int R, int C, int D, int split, cudaStream_t s,
                   float* dn_part = nullptr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * ((D + kCols - 1) / kCols), (R + ROWS - 1) / ROWS, G);
  cfg.blockDim = dim3(ROWS / kMR * kTX);
  cfg.dynamicSmemBytes = PAIR ? kRedBytes : 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, l1_bwd_kernel<ROWS, TRANS_W, PAIR>, x, y, w, out,
                            dn_part, R, C, D);
}

// The blocks an SM holds of each variant, read once a device.
struct Card {
  int blocks[2][2] = {};  // [ROWS == 64][TRANS_W]
  int pair_blocks = 0;
};

template <int ROWS, bool TRANS_W, bool PAIR = false>
int blocks_per_sm() {
  return plan::blocks_per_sm(l1_bwd_kernel<ROWS, TRANS_W, PAIR>, ROWS / kMR * kTX,
                             PAIR ? kRedBytes : 0);
}

const Card& card() {
  static std::once_flag once[plan::kMaxDevices];
  static Card cards[plan::kMaxDevices];
  const int slot = plan::once_per_device(once, [](int, int s) {
    Card& c = cards[s];
    cudaFuncSetAttribute(l1_bwd_kernel<kPairRows, false, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRedBytes);
    c.blocks[0][0] = blocks_per_sm<32, false>();
    c.blocks[0][1] = blocks_per_sm<32, true>();
    c.blocks[1][0] = blocks_per_sm<64, false>();
    c.blocks[1][1] = blocks_per_sm<64, true>();
    c.pair_blocks = blocks_per_sm<kPairRows, false, true>();
  });
  return cards[slot];
}

// Tiles of h rows (x kCols columns) over an (R, D) output, G groups.
long long tiles(int G, int R, int D, int h) {
  return (long long)G * ((D + kCols - 1) / kCols) * ((R + h - 1) / h);
}

// Tile height (64, else 32) and split of one launch: the least cost
// (plan.cuh), a tile's work counted in rows.
void plan_launch(int G, int R, int C, int D, bool trans, int* rows, int* split) {
  const Card& cd = card();
  const int sms = plan::sm_count();
  const int nch = (C + kTileC - 1) / kTileC;
  double best = -1;
  for (int big = 1; big >= 0; --big) {
    const int h = big ? 64 : 32;
    double c;
    const int s = plan::best_split(sms, tiles(G, R, D, h), nch, cd.blocks[big][trans],
                                   h / kMR * kTX / 32, h, &c);
    if (best < 0 || c < best) {
      best = c;
      *rows = h;
      *split = s;
    }
  }
}

// Split of the pair launch (tiles of kPairRows rows of o, K split s ways).
int plan_pair(int G, int B, int K, int D) {
  double c;
  return plan::best_split(plan::sm_count(), tiles(G, B, D, kPairRows),
                          (K + kTileC - 1) / kTileC, card().pair_blocks,
                          kPairRows / kMR * kTX / 32, kPairRows, &c);
}

}  // namespace

// The tile height and split l1_bwd_launch picks for this call on the
// current device. Returns 0.
extern "C" int l1_bwd_plan(int G, int R, int C, int D, int trans_w, int* rows,
                           int* split) {
  plan_launch(G, R, C, D, trans_w != 0, rows, split);
  return 0;
}

// The split l1_bwd_pair_launch picks (its tiles are 64 rows of o).
extern "C" int l1_bwd_pair_plan(int G, int B, int K, int D) {
  return plan_pair(G, B, K, D);
}

// out (G, R, D) = sum_c w[r, c] sign(x[r] - y[c]) with x (G, R, D),
// y (G, C, D) and w (G, R, C), or w stored (G, C, R) when trans_w; the tile
// height and split are those l1_bwd_plan reports. Launch on `stream`;
// returns the launch's error (0 = launched).
extern "C" int l1_bwd_launch(const float* x, const float* y, const float* w,
                             float* out, int G, int R, int C, int D, int trans_w,
                             void* stream) {
  if (G <= 0 || R <= 0 || D <= 0) return 0;
  int rows = 0, split = 0;
  plan_launch(G, R, C, D, trans_w != 0, &rows, &split);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows == 64) {
    err = trans_w ? launch<64, true>(x, y, w, out, G, R, C, D, split, s)
                  : launch<64, false>(x, y, w, out, G, R, C, D, split, s);
  } else {
    err = trans_w ? launch<32, true>(x, y, w, out, G, R, C, D, split, s)
                  : launch<32, false>(x, y, w, out, G, R, C, D, split, s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Floats of the scratch l1_bwd_pair_launch needs: d_n's partial sums, one
// (G, K, D) block for each tile of 64 rows of o.
extern "C" long long l1_bwd_pair_scratch(int G, int B, int K, int D) {
  return (long long)((B + kPairRows - 1) / kPairRows) * G * K * D;
}

// Both products from one pass over the (b, k, d) compare pairs: d_o
// (G, B, D), as l1_bwd_launch(o, n, g) computes it, and d_n (G, K, D), whose
// partial sums go to `scratch` (l1_bwd_pair_scratch floats) and are summed in
// order by a second launch; K is split as l1_bwd_pair_plan reports.
// Returns the first launch error (0 = launched).
extern "C" int l1_bwd_pair_launch(const float* o, const float* n, const float* g,
                                  float* d_o, float* d_n, float* scratch, int G, int B,
                                  int K, int D, void* stream) {
  if (G <= 0 || D <= 0 || (B <= 0 && K <= 0)) return 0;
  const int split = plan_pair(G, B, K, D);  // also sets the pair kernel's smem limit
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const cudaError_t err =
        launch<kPairRows, false, true>(o, n, g, d_o, G, B, K, D, split, s, scratch);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t nk = (size_t)G * K * D;
  if (nk > 0) {
    const int nt = (B + kPairRows - 1) / kPairRows;
    if (nt == 0) {
      cudaMemsetAsync(d_n, 0, nk * sizeof(float), s);
    } else {
      const size_t blocks = (nk / 4 + 255) / 256 + 1;
      l1_dn_combine<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
          scratch, d_n, nt, nk);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
