// RESCAL's two products of each triplet's relation matrix, and their
// gradients, fp32 on Hopper.
//
//   forward   ph[i, r] = sum_d h[i, d] M_i[d, r]         (M_i^T h_i)
//             pt[i, d] = sum_r M_i[d, r] t[i, r]         (M_i t_i)
//   backward  dt[i, r] = sum_d dpt[i, d] M_i[d, r]
//             dh[i, d] = sum_r M_i[d, r] dph[i, r]
//             dM_i[d, r] = h[i, d] dph[i, r] + dpt[i, d] t[i, r]
//
// M_i is row i of the (b, D * R) projection workspace, viewed D x R
// row-major: the single-machine step gathers one row a triplet. Both passes
// have one form, a column sum weighted by a vector a over the rows (ph: a =
// h; dt: a = dpt) beside a row dot with a vector v over the columns (pt: v
// = t; dh: v = dph); the backward also writes dM.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA as
// einsums. Through PyTorch on the card those einsums took most of RESCAL's
// FB15k step (PERF.md): a second per-triplet copy of the rows, three
// batched gemvs (h M twice), three outer-product gradients of 1 GB, the
// adds that sum them and an index backward into a zeroed 1 GB tensor.
//
// What bounds it: bytes. At FB15k's RESCAL (b = 1024, D = R = 500) the
// forward reads the 1.02 GB of rows once, 306 us at the 3.35 TB/s of the
// H100 SXM data sheet; the backward reads them again and writes dM, 611
// us. The arithmetic is 4 (forward) and 7 (backward) operations an element
// on the fp32 units, 15 and 27 us at 67 TFLOP/s.
//
// Design: one thread-block cluster of kCluster blocks a triplet; block q of
// the cluster takes rows [q D / C, (q + 1) D / C) of M_i, so 1,024 triplets
// give 8,192 blocks, some ten waves of the card. A warp reads a row as 32
// lanes x VW floats (float4 where R % 4 == 0 and the bases are 16-byte
// aligned, else one float a lane): a column tile. A warp's work item is
// one column tile over one phase of the block's rows (every P-th row,
// P = kWarps / tiles where a row has fewer tiles than the block has warps);
// it keeps kUnroll rows' loads in flight, a's values for the block's rows
// and v's for its columns staged beforehand (shared memory, registers).
// For each row the lanes' products with v are summed across the warp
// (butterfly shuffles) into that row's partial of the tile, and a times
// the row is added into the lane's column sums. Then, each in a fixed
// order: a row's tile partials in tile order (the row is whole in its
// block); a column's row phases in phase order, then the cluster's blocks
// in rank order through distributed shared memory, each block summing its
// share of the columns. So two calls give the same bits. The backward's dM
// is formed with the _rn intrinsics, two products and a sum each rounded
// as the plain version rounds them, so it equals the plain version's bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;             // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kCluster = 8;           // blocks a triplet, one cluster
constexpr int kUnroll = 4;            // rows a warp has in flight

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// VW floats from p[c..c + VW), zeros past R (c < R covers the whole group:
// the vector route needs R % 4 == 0).
template <int VW>
__device__ __forceinline__ void load(const float* __restrict__ p, int c, int R,
                                     float (&x)[VW]) {
  if constexpr (VW == 4) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < R) q = *reinterpret_cast<const float4*>(p + c);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    x[0] = c < R ? p[c] : 0.f;
  }
}

template <int VW>
__device__ __forceinline__ void store(float* __restrict__ p, int c, int R,
                                      const float (&x)[VW]) {
  if (c >= R) return;
  if constexpr (VW == 4)
    *reinterpret_cast<float4*>(p + c) = make_float4(x[0], x[1], x[2], x[3]);
  else
    p[c] = x[0];
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Column tiles a row has, row phases and row-partial slots (S) of a launch.
struct Plan {
  int tiles, phases, slots, rows_max;
  size_t smem;
};

template <int VW, bool kBwd>
Plan plan(int D, int R) {
  Plan p;
  p.tiles = (R + 32 * VW - 1) / (32 * VW);
  p.phases = p.tiles >= kWarps ? 1 : kWarps / p.tiles;
  p.slots = p.tiles < kWarps ? p.tiles : kWarps;
  p.rows_max = (D + kCluster - 1) / kCluster;
  p.smem = sizeof(float) * ((size_t)p.phases * R +
                            (size_t)p.rows_max * (p.slots + (kBwd ? 2 : 1)));
  return p;
}

// Block q of triplet i's cluster (blockIdx.x = i * kCluster + q).
// Forward: a = h, v = t, out_col = ph, out_row = pt. Backward: a = dpt,
// v = dph, out_col = dt, out_row = dh, and dm = h (x) dph + dpt (x) t.
template <int VW, bool kBwd>
__global__ void __launch_bounds__(kThreads)
rescal_proj_kernel(const float* __restrict__ m, const float* __restrict__ a,
                   const float* __restrict__ v, const float* __restrict__ h,
                   const float* __restrict__ t, float* __restrict__ out_col,
                   float* __restrict__ out_row, float* __restrict__ dm, int D, int R) {
  constexpr int TW = 32 * VW;  // columns of a tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t i = blockIdx.x / kCluster;
  const int r0 = (int)((long long)rank * D / kCluster);
  const int nrows = (int)((long long)(rank + 1) * D / kCluster) - r0;
  const int tiles = (R + TW - 1) / TW;
  const int P = tiles >= kWarps ? 1 : kWarps / tiles;
  const int S = tiles < kWarps ? tiles : kWarps;
  const int rows_max = (D + kCluster - 1) / kCluster;

  extern __shared__ __align__(16) float smem[];
  float* col = smem;                  // [P][R]: column sums of each row phase
  float* rowp = col + (size_t)P * R;  // [rows_max][S]: row partials by slot
  float* as = rowp + (size_t)rows_max * S;  // a over the block's rows
  float* hs = as + rows_max;                // h over them (backward)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* mi = m + i * (size_t)D * R + (size_t)r0 * R;
  for (int k = threadIdx.x; k < nrows; k += kThreads) {
    as[k] = a[i * D + r0 + k];
    if constexpr (kBwd) hs[k] = h[i * D + r0 + k];
  }
  __syncthreads();

  // item = phase * tiles + tile; a warp's items share one slot (tile %
  // kWarps), visited in tile order, so its row partials add up in order
  for (int item = warp; item < tiles * P; item += kWarps) {
    const int j = item % tiles;
    const int p = item / tiles;
    const int c = j * TW + lane * VW;
    const int slot = j % kWarps;
    float vv[VW], tv[VW], acc[VW];
    load<VW>(v + i * R, c, R, vv);
    if constexpr (kBwd) load<VW>(t + i * R, c, R, tv);
#pragma unroll
    for (int q = 0; q < VW; ++q) acc[q] = 0.f;
    for (int k0 = p; k0 < nrows; k0 += P * kUnroll) {
      float x[kUnroll][VW];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * P;
        if (k < nrows) {
          load<VW>(mi + (size_t)k * R, c, R, x[u]);
        } else {
#pragma unroll
          for (int q = 0; q < VW; ++q) x[u][q] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * P;
        if (k >= nrows) break;  // the same k on every lane of the warp
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < VW; ++q) s = fmaf(x[u][q], vv[q], s);
        s = warp_sum(s);
        const float ak = as[k];
#pragma unroll
        for (int q = 0; q < VW; ++q) acc[q] = fmaf(ak, x[u][q], acc[q]);
        if (lane == 0) {
          float* rp = rowp + (size_t)k * S + slot;
          *rp = j < kWarps ? s : *rp + s;
        }
        if constexpr (kBwd) {
          const float hk = hs[k];
          float g[VW];
#pragma unroll
          for (int q = 0; q < VW; ++q)
            g[q] = __fadd_rn(__fmul_rn(hk, vv[q]), __fmul_rn(ak, tv[q]));
          store<VW>(dm + i * (size_t)D * R + (size_t)(r0 + k) * R, c, R, g);
        }
      }
    }
    store<VW>(col + (size_t)p * R, c, R, acc);
  }
  __syncthreads();

  // each row whole: its slots in order
  for (int k = threadIdx.x; k < nrows; k += kThreads) {
    float s = rowp[(size_t)k * S];
    for (int q = 1; q < S; ++q) s += rowp[(size_t)k * S + q];
    out_row[i * D + r0 + k] = s;
  }
  // the block's column sums: its row phases in order, into phase 0
  if (P > 1) {
    for (int c = threadIdx.x; c < R; c += kThreads) {
      float s = col[c];
      for (int p = 1; p < P; ++p) s += col[(size_t)p * R + c];
      col[c] = s;
    }
  }
  // the cluster's column sums: each block its share, over ranks in order
  cluster.sync();
  const int c0 = (int)((long long)rank * R / kCluster);
  const int c1 = (int)((long long)(rank + 1) * R / kCluster);
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
    float s = *cluster.map_shared_rank(col + c, 0);
    for (int q = 1; q < kCluster; ++q) s += *cluster.map_shared_rank(col + c, q);
    out_col[i * R + c] = s;
  }
  cluster.sync();  // no block leaves while another reads its sums
}

template <int VW, bool kBwd>
cudaError_t launch(const float* m, const float* a, const float* v, const float* h,
                   const float* t, float* out_col, float* out_row, float* dm, int b,
                   int D, int R, cudaStream_t s) {
  const Plan p = plan<VW, kBwd>(D, R);
  auto kernel = rescal_proj_kernel<VW, kBwd>;
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)b * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, m, a, v, h, t, out_col, out_row, dm, D, R);
}

}  // namespace

// m (b, D * R); the forward (dm null): a = h (b, D), v = t (b, R), out_col
// = ph (b, R), out_row = pt (b, D); the backward: a = dpt, v = dph, h, t,
// out_col = dt, out_row = dh, dm (b, D * R). Every pointer contiguous.
// Launch on `stream`; returns the launch's error (0 = launched).
extern "C" int rescal_proj_launch(const float* m, const float* a, const float* v,
                                  const float* h, const float* t, float* out_col,
                                  float* out_row, float* dm, int b, int D, int R,
                                  void* stream) {
  if (b <= 0 || D <= 0 || R <= 0) return 0;
  const bool bwd = dm != nullptr;
  const bool vec = R % 4 == 0 && aligned16(m) && aligned16(v) &&
                   (!bwd || (aligned16(t) && aligned16(dm)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bwd)
    err = vec ? launch<4, true>(m, a, v, h, t, out_col, out_row, dm, b, D, R, s)
              : launch<1, true>(m, a, v, h, t, out_col, out_row, dm, b, D, R, s);
  else
    err = vec ? launch<4, false>(m, a, v, h, t, out_col, out_row, dm, b, D, R, s)
              : launch<1, false>(m, a, v, h, t, out_col, out_row, dm, b, D, R, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
