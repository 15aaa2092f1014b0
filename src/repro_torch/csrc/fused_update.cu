// Fused sparse-Adagrad row update, in place on the embedding table.
//
//   For each slot i with 0 <= ids[i] < n_rows (valid ids unique):
//     gsq[id]   += g_i^2
//     table[id] -= lr * g_i / (sqrt(gsq[id]) + eps)     (updated gsq: DGL-KE)
//   Slots with id < 0 are no-ops; ids >= n_rows are dropped like the JAX
//   reference's mode="drop" scatter. Untouched rows are never read or written.
//
// Replaces the TPU kernel src/repro/kernels/sparse_adagrad/sparse_adagrad.py
// fused_update_pallas (_update_kernel), whose grid (D // bd, n) tiles each
// row into column blocks. The TPU version remapped pad slots to the previous
// valid row (ops.py:42-58) to dodge a block-pipeline hazard; here a pad
// costs one id load, then the warp exits.
//
// What bounds it: bytes. Per valid slot it reads the grad row, the table row
// and the gsq row and writes both rows back, 5 x D x 4 bytes: 15.3 MB for
// the 1,906 valid of 2,560 entity slots of one FB15k step at D = 400 (4.55
// us at the 3.35 TB/s of the H100 SXM data sheet), 1.10 GB for the 344 valid
// of 1,024 RESCAL/TransR projection rows of 160,000 floats (329 us). The
// arithmetic is 7 operations an element, but the exact division and square
// root take many instructions each. The small applies cannot reach their
// bound: a launch and two dependent round trips to memory (the id, then the
// rows) take longer.
//
// Design: the TPU kernel's (column block, slot) grid, with one warp for
// each (slot, tile of kTile = 256 floats): a 400-wide row takes two warps,
// a 160,000-wide row 625, and every warp has work of the same size however
// wide the row. A lane issues all its loads of the tile (kVec float4s each
// of grad, gsq and table) before any arithmetic, then computes and stores.
// That vector path needs D % 4 == 0 and the three bases 16-byte aligned
// (then every row is); otherwise the launch takes the same kernel with
// scalar loads over the same tiles (an odd D, a storage offset). 46
// registers a thread (ptxas -v): ten blocks of four warps fit an SM.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): the projection apply
// cold in L2 in 372 us, 88% of its bound; the 400-wide applies in 2.4-8.0
// us warm in L2.
//
// Cache policy: the default for all three arrays. Table and gsq rows are
// read again by the next step; the grad rows come fresh from the dedup
// kernel, in L2. Streaming the grad rows (ld.global.cs, evict first) was
// slower on the same card where the bytes are many: by 0.9-1.8 us at the
// 3,584- and 5,632-slot entity applies warm, by 1% at the projection.
//
// Valid ids must be unique (the dedup kernel guarantees it on the training
// path): two warps on one row would race. The arithmetic uses the _rn
// intrinsics so the compiler does not contract it into FMAs, and so matches
// the plain PyTorch version operation by operation, bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;              // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 2;                // float4s a lane loads of each array
constexpr int kTile = 32 * kVec * 4;   // floats of a row one warp takes: 256

__device__ __forceinline__ void adagrad(float g, float& q, float& t, float lr,
                                        float eps) {
  q = __fadd_rn(q, __fmul_rn(g, g));
  t = __fsub_rn(t, __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(__fsqrt_rn(q), eps)));
}

__device__ __forceinline__ void adagrad4(const float4& g, float4& q, float4& t,
                                         float lr, float eps) {
  adagrad(g.x, q.x, t.x, lr, eps);
  adagrad(g.y, q.y, t.y, lr, eps);
  adagrad(g.z, q.z, t.z, lr, eps);
  adagrad(g.w, q.w, t.w, lr, eps);
}

// One warp, one (slot, tile): every load of the tile, then the arithmetic,
// then the stores. kVector: float4 accesses (D % 4 == 0, aligned bases);
// else scalar ones, kVec * 4 a lane of each array, over the same tile.
template <bool kVector>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(float* __restrict__ table, float* __restrict__ gsq,
                    const int* __restrict__ ids,
                    const float* __restrict__ grads, int n, int D, int tiles,
                    long long n_rows, float lr, float eps) {
  const int lane = threadIdx.x % 32;
  const long long item = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= (long long)n * tiles) return;
  const int i = (int)(item / tiles);
  const int c = (int)(item - (long long)i * tiles) * kTile;  // first column
  const int id = ids[i];
  if (id < 0 || id >= n_rows) return;
  float* t = table + (size_t)id * D;
  float* q = gsq + (size_t)id * D;
  const float* g = grads + (size_t)i * D;
  if constexpr (kVector) {
    const int D4 = D / 4;
    const int c4 = c / 4 + lane;
    float4 gv[kVec], qv[kVec], tv[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int k = c4 + 32 * j;
      if (k < D4) {
        gv[j] = reinterpret_cast<const float4*>(g)[k];
        qv[j] = reinterpret_cast<const float4*>(q)[k];
        tv[j] = reinterpret_cast<const float4*>(t)[k];
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int k = c4 + 32 * j;
      if (k < D4) {
        adagrad4(gv[j], qv[j], tv[j], lr, eps);
        reinterpret_cast<float4*>(q)[k] = qv[j];
        reinterpret_cast<float4*>(t)[k] = tv[j];
      }
    }
  } else {
    constexpr int kS = kVec * 4;
    float gs[kS], qs[kS], ts[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int e = c + lane + 32 * j;
      if (e < D) {
        gs[j] = g[e];
        qs[j] = q[e];
        ts[j] = t[e];
      }
    }
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int e = c + lane + 32 * j;
      if (e < D) {
        adagrad(gs[j], qs[j], ts[j], lr, eps);
        q[e] = qs[j];
        t[e] = ts[j];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int fused_update_launch(float* table, float* gsq, const int* ids,
                                   const float* grads, int n, int D,
                                   long long n_rows, float lr, float eps,
                                   void* stream) {
  if (n <= 0) return 0;
  const int tiles = D > kTile ? (D + kTile - 1) / kTile : 1;  // >= 1: one launch
  const long long blocks = ((long long)n * tiles + kWarps - 1) / kWarps;
  const bool vector = D % 4 == 0 && aligned16(table) && aligned16(gsq) &&
                      aligned16(grads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector)
    fused_update_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        table, gsq, ids, grads, n, D, tiles, n_rows, lr, eps);
  else
    fused_update_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        table, gsq, ids, grads, n, D, tiles, n_rows, lr, eps);
  return static_cast<int>(cudaGetLastError());
}
