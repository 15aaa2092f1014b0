// Fused sparse-Adagrad row update, in place on the embedding table.
//
//   For each slot i with 0 <= ids[i] < n_rows (valid ids unique):
//     gsq[id]   += g_i^2
//     table[id] -= lr * g_i / (sqrt(gsq[id]) + eps)     (updated gsq: DGL-KE)
//   Slots with id < 0 are no-ops; ids >= n_rows are dropped like the JAX
//   reference's mode="drop" scatter. Untouched rows are never read or written.
//
// Replaces the TPU kernel src/repro/kernels/sparse_adagrad/sparse_adagrad.py
// fused_update_pallas (_update_kernel). The TPU version remapped pad slots to
// the previous valid row (ops.py:42-58) to dodge a block-pipeline hazard; a
// GPU thread simply skips a pad.
//
// What bounds it: bytes. Per valid slot it reads the grad row, the table row
// and the gsq row and writes both rows back: 5 x D x 4 bytes, 20.5 MB for
// 2560 entity rows of D = 400 (~6.1 us at the 3.35 TB/s of an H100 SXM data
// sheet, 700 W); the arithmetic is a few operations per byte.
//
// Design: one warp per slot, eight slots per block, the lanes striding over
// D so each row moves in coalesced 128-byte lines. Valid ids must be unique
// (the dedup kernel guarantees it on the training path): two warps on one
// row would race. The arithmetic uses the _rn intrinsics so the compiler
// does not contract it into FMAs, and so matches the plain PyTorch version
// operation by operation.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__global__ void __launch_bounds__(kThreads)
fused_update_kernel(float* __restrict__ table, float* __restrict__ gsq,
                    const int* __restrict__ ids,
                    const float* __restrict__ grads, int n, int D,
                    long long n_rows, float lr, float eps) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= n) return;
  const int id = ids[i];
  if (id < 0 || id >= n_rows) return;
  float* t = table + (size_t)id * D;
  float* q = gsq + (size_t)id * D;
  const float* g = grads + (size_t)i * D;
  for (int d = lane; d < D; d += 32) {
    const float gd = g[d];
    const float qd = __fadd_rn(q[d], __fmul_rn(gd, gd));
    q[d] = qd;
    const float step = __fdiv_rn(__fmul_rn(lr, gd), __fadd_rn(__fsqrt_rn(qd), eps));
    t[d] = __fsub_rn(t[d], step);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int fused_update_launch(float* table, float* gsq, const int* ids,
                                   const float* grads, int n, int D,
                                   long long n_rows, float lr, float eps,
                                   void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kWarps - 1) / kWarps;
  fused_update_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, gsq, ids, grads, n, D, n_rows, lr, eps);
  return static_cast<int>(cudaGetLastError());
}
