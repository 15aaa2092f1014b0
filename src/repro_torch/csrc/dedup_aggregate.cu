// In-place-layout dedup-aggregate of one step's sparse gradient rows.
//
//   ids (n,) int32, grads (n, D) fp32  ->  uid (n,) int32, agg (n, D) fp32
//   slot i keeps ids[i] iff no earlier slot holds the same id (its first
//   occurrence); its row becomes the sum of the grad rows of every slot with
//   that id, taken in ascending slot order. Later duplicates and pads
//   (id < 0) get (-1, zero row). The layout equals
//   src/repro_torch/kernels/sparse_adagrad/ref.py::dedup_aggregate_ref.
//
// Replaces the TPU kernel src/repro/kernels/sparse_adagrad/sparse_adagrad.py
// dedup_aggregate_pallas (_dedup_kernel), which built an O(n^2) 0/1 match
// matrix and multiplied it with the grads on the MXU.
//
// What bounds it: the work is one read of the grads and one write of the
// output (n = 2560, D = 400 on the entity table: 8.2 MB, ~2.4 us at the
// 3.35 TB/s of an H100 SXM data sheet). The id comparisons are O(n^2) but
// are 32-bit compares on ids held in shared memory, 6.6 M of them for
// n = 2560, spread over the card. What is not spread is a long duplicate
// chain: the ids of a training batch are Zipf-skewed (on FB15k one relation
// fills 100-140 of 1024 slots, one entity 35-50 of 2560), and all copies of
// an id are summed by the warps of its first occurrence. That chain and the
// scan set the kernel's time, so the design keeps the chain one of register
// adds whose loads are in flight together, never one through global memory,
// and makes a scan step that finds no match cost one vote.
//
// Design: kSplit warps per slot, each owning a quarter of D (128 columns at
// D = 400), two slots per block. The block stages the ids in shared memory
// in chunks of 4096 (16 KB). Each warp compares its slot's id with 128
// staged ids a step (four groups of 32) and votes; only a step with a match
// goes on to __ballot_sync per group. A match below its own slot makes the
// slot a duplicate and ends its work. Otherwise the warp appends the matches
// at or above its slot, in ascending order, to a list in shared memory, and
// drains the list when it is full and at the end: each lane holds kCols
// columns of the sum in registers, and the rows of kBatch duplicates are
// loaded before any is added. The sum order is the ascending slot order, so
// the result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSplit = 4;     // warps per slot, each summing a part of D
static_assert(kWarps % kSplit == 0, "whole slots per block");
constexpr int kChunk = 4096;  // ids staged per pass
constexpr int kScan = 4;      // groups of 32 ids compared per vote
constexpr int kList = 128;    // matches a warp holds before it drains
constexpr int kCols = 4;      // columns of the sum a lane holds per pass
constexpr int kBatch = 16;    // duplicate rows whose loads are in flight

// out[lo:hi] = (fresh ? 0 : out[lo:hi]) + the sum of grads[list[t]][lo:hi]
// over t ascending. The rows are loaded kBatch at a time into registers
// before any of them is added, so a long list costs cnt / kBatch memory
// latencies, not cnt.
__device__ __forceinline__ void drain(const float* __restrict__ grads,
                                      float* __restrict__ out,
                                      const int* list, int cnt, bool fresh,
                                      int D, int lo, int hi, int lane) {
  for (int s0 = lo; s0 < hi; s0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int r = 0; r < kCols; ++r) {
      const int d = s0 + lane + 32 * r;
      acc[r] = (!fresh && d < hi) ? out[d] : 0.f;
    }
    int t = 0;
    for (; t + kBatch <= cnt; t += kBatch) {
      float v[kBatch][kCols];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const float* src = grads + (size_t)list[t + q] * D;
#pragma unroll
        for (int r = 0; r < kCols; ++r) {
          const int d = s0 + lane + 32 * r;
          v[q][r] = d < hi ? src[d] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int r = 0; r < kCols; ++r) acc[r] += v[q][r];
      }
    }
    for (; t < cnt; ++t) {
      const float* src = grads + (size_t)list[t] * D;
#pragma unroll
      for (int r = 0; r < kCols; ++r) {
        const int d = s0 + lane + 32 * r;
        if (d < hi) acc[r] += src[d];
      }
    }
#pragma unroll
    for (int r = 0; r < kCols; ++r) {
      const int d = s0 + lane + 32 * r;
      if (d < hi) out[d] = acc[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dedup_aggregate_kernel(const int* __restrict__ ids,
                       const float* __restrict__ grads,
                       int* __restrict__ uid, float* __restrict__ agg,
                       int n, int D) {
  __shared__ int s_ids[kChunk];
  __shared__ int s_list[kWarps][kList];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int* list = s_list[warp];
  const int i = blockIdx.x * (kWarps / kSplit) + warp / kSplit;
  // this warp's part of the columns, in whole 32-column groups
  const int part = ((D + 32 * kSplit - 1) / (32 * kSplit)) * 32;
  const int lo = min(D, (warp % kSplit) * part);
  const int hi = min(D, lo + part);
  const int my = i < n ? ids[i] : -1;
  bool first = my >= 0;  // uniform across the warp
  bool fresh = true;     // nothing of the sum written to out yet
  int cnt = 0;
  float* out = agg + (size_t)i * D;

  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int cn = min(kChunk, n - c0);
    __syncthreads();
#pragma unroll 4
    for (int t = threadIdx.x; t < cn; t += kThreads) s_ids[t] = ids[c0 + t];
    __syncthreads();
    for (int g0 = 0; first && g0 < cn; g0 += 32 * kScan) {
      // kScan groups of 32 ids at once: most hold no match and cost one vote
      int v[kScan];
      bool any = false;
#pragma unroll
      for (int q = 0; q < kScan; ++q) {
        const int t = g0 + 32 * q + lane;
        v[q] = t < cn ? s_ids[t] : -1;  // my >= 0 here, so -1 never matches
        any |= v[q] == my;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int q = 0; q < kScan; ++q) {
        const int base = c0 + g0 + 32 * q;
        const bool hit = v[q] == my;
        const unsigned mask = __ballot_sync(0xffffffffu, hit);
        const int below = i - base;  // lanes holding slots before i
        const unsigned earlier =
            below <= 0 ? 0u : (below >= 32 ? 0xffffffffu : (1u << below) - 1u);
        if (mask & earlier) {
          first = false;
          break;
        }
        // every match from here on is at or above slot i
        const int m = __popc(mask);
        if (cnt + m > kList) {
          __syncwarp();
          drain(grads, out, list, cnt, fresh, D, lo, hi, lane);
          fresh = false;
          cnt = 0;
          __syncwarp();
        }
        if (hit) list[cnt + __popc(mask & ((1u << lane) - 1u))] = base + lane;
        cnt += m;
      }
    }
  }

  if (i < n) {
    if (lane == 0 && warp % kSplit == 0) uid[i] = first ? my : -1;
    if (first) {
      __syncwarp();
      drain(grads, out, list, cnt, fresh, D, lo, hi, lane);
    } else {
      for (int d = lo + lane; d < hi; d += 32) out[d] = 0.f;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int dedup_aggregate_launch(const int* ids, const float* grads,
                                      int* uid, float* agg, int n, int D,
                                      void* stream) {
  if (n <= 0) return 0;
  constexpr int kSlots = kWarps / kSplit;  // slots per block
  const int blocks = (n + kSlots - 1) / kSlots;
  dedup_aggregate_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ids, grads, uid, agg, n, D);
  return static_cast<int>(cudaGetLastError());
}
