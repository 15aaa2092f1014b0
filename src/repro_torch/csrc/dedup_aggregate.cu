// In-place-layout dedup-aggregate of one step's sparse gradient rows.
//
//   ids (n,) int32, grads (n, D) fp32  ->  uid (n,) int32, agg (n, D) fp32
//   slot i keeps ids[i] iff no earlier slot holds the same id (its first
//   occurrence); its row becomes the sum of the grad rows of every slot with
//   that id. Later duplicates and pads (id < 0) get (-1, zero row). The
//   layout equals src/repro_torch/kernels/sparse_adagrad/ref.py::
//   dedup_aggregate_ref.
//
// Replaces the TPU kernel src/repro/kernels/sparse_adagrad/sparse_adagrad.py
// dedup_aggregate_pallas (_dedup_kernel), which built an O(n^2) 0/1 match
// matrix and multiplied it with the grads on the MXU.
//
// What bounds it: the work is one read of the grads and one write of the
// output (n = 2560, D = 400 on the entity table: 8.2 MB, ~2.4 us at the
// 3.35 TB/s of an H100 SXM data sheet). At the training path's sizes the
// kernel is bound by latency instead. The ids of a training batch are
// Zipf-skewed (on FB15k one relation fills 100-140 of 1024 slots, one
// entity 35-50 of 2560), and a warp can keep only as many row loads in
// flight as it has registers for: summed by one warp, a long group's rows
// take rounds of dependent loads, and the longest group sets the time.
//
// Design (n <= kMaxWarpN; one launch, no atomics): one warp a slot, four a
// block.
//  1. The block stages all n ids in shared memory once (n^2 compares spread
//     over the card cost less than a sort or a hash table that every slot
//     would wait for). The warp compares its slot's id with all of them, 8
//     a lane a step through 16-byte loads, and learns how many slots hold
//     it before its own (its rank) and in all (c), and lists the first
//     kList of them in slot order.
//  2. A pad writes (-1, zero row); a slot that is not its id's first
//     writes (-1, zero row).
//  3. A group's c warps share its first row in slices, slice s to the
//     warp of rank s mod c; a lane sums its columns over every RC-th row
//     of the group, and the RC row classes are added pairwise. The slice
//     shape is picked by c so that at D = 400 each warp has at most one
//     slice of one round of loads (up to 52 a lane): 416 columns x 4 rows
//     for c <= 4 (the first warp alone), 96 x 12 for c <= 12, 32 x 36 for
//     c <= 36, 16 x 72 for c <= 72, 8 x 144 beyond. So the 140 rows of a
//     skewed relation take one round of loads on 50 warps, not a chain of
//     rounds in one; groups past kList = 144 slots list their slots again
//     for each 144.
// The sum order is fixed by the ids: the same inputs give the same bits.
//
// Workspaces past kMaxWarpN (e.g. the naive sampler's b (2 + 2k) slots)
// take dedup_scan_kernel: two slots a block, four warps a slot each summing
// a quarter of D, the ids staged in chunks; O(n^2) compares and one warp
// summing a whole group.

#include <cuda_runtime.h>

#include <mutex>

namespace {

// ---------------------------------------------------------------------------
// the warp-a-slot route, n <= kMaxWarpN
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;                  // slots a block
constexpr int kThreads = kWarps * 32;
constexpr int kStage = 256;                // ids compared a step, 8 a lane
constexpr int kList = 144;                 // slots a warp lists
constexpr int kMaxWarpN = 12288;           // ids staged: 48 KB
constexpr int kMaxDevices = 64;            // slots of the per-device cache

__device__ __forceinline__ void zero_row(float* dst, int D, int lane) {
  for (int c = lane; c < D; c += 32) dst[c] = 0.f;
}

// The slots of the 128 staged at `base` (4 a lane, slot base + 4 lane + e
// in w.e) that hold x: each lane's flags, the hits in lanes below it and
// in the warp.
struct Hits {
  int h[4], below, total;
};

__device__ __forceinline__ Hits hits_of(int4 w, int x, int base, int lane) {
  Hits r;
  r.h[0] = w.x == x;
  r.h[1] = w.y == x;
  r.h[2] = w.z == x;
  r.h[3] = w.w == x;
  const int m = r.h[0] + r.h[1] + r.h[2] + r.h[3];
  r.total = __reduce_add_sync(0xffffffffu, m);
  int incl = m;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  r.below = incl - m;
  return r;
}

// list[rank - lo] = slot for the hits whose rank (counted from `seen`) is
// in [lo, lo + kList)
__device__ __forceinline__ void list_hits(const Hits& r, int seen, int lo,
                                          int base, int lane, int* list) {
  int rank = seen + r.below;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (r.h[e]) {
      if (rank >= lo && rank < lo + kList) list[rank - lo] = base + 4 * lane + e;
      ++rank;
    }
  }
}

// The group's sum into `first`, by the warp of rank `before` of its c:
// slices of P x 32 / RC columns, slice s to the warp of rank s mod c. A
// lane holds P columns of a slice and sums every RC-th row of the group
// (rows RC i + lane / (32 / RC)), R rows' loads a column in flight; the RC
// row classes are then added pairwise. The order is fixed by the ids.
// `list` holds the group's first kList slots; past them (RC R == kList
// then) it is built again for each kList ranks.
template <int RC, int P, int R>
__device__ __forceinline__ void sum_slices(float* first, const float* grads,
                                           int* list, const int4* s_ids4, int x,
                                           int padded, int c, int before, int D,
                                           int lane) {
  constexpr int kCols = 32 / RC;     // the columns of a row class
  constexpr int kWidth = P * kCols;  // the columns of a slice
  const int q = lane / kCols, cl = lane % kCols;
  const int n_slices = (D + kWidth - 1) / kWidth;
  for (int sl = before; sl < n_slices; sl += c) {
    float acc[P] = {};
    for (int k0 = 0; k0 < c; k0 += RC * R) {
      if (c > kList) {
        __syncwarp();
        for (int g0 = 0, seen = 0; g0 < padded && seen < k0 + kList; g0 += 128) {
          const Hits r = hits_of(s_ids4[g0 / 4 + lane], x, g0, lane);
          list_hits(r, seen, k0, g0, lane, list);
          seen += r.total;
        }
        __syncwarp();
      }
      const int rows = min(RC * R, c - k0);
      float v[P][R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int k = RC * i + q;
        const float* row = grads + (size_t)(k < rows ? list[k] : 0) * D;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int col = sl * kWidth + p * kCols + cl;
          v[p][i] = k < rows && col < D ? row[col] : 0.f;
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < R; ++i) acc[p] += v[p][i];
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int o = kCols; o < 32; o *= 2) {
        acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], o);
      }
      const int col = sl * kWidth + p * kCols + cl;
      if (q == 0 && col < D) first[col] = acc[p];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 5)
dedup_warp_kernel(const int* __restrict__ ids, const float* __restrict__ grads,
                  int* __restrict__ uid, float* __restrict__ agg, int n, int D) {
  extern __shared__ int4 s_ids4[];  // the n ids, -1 up to a multiple of kStage
  __shared__ int s_list[kWarps][kList];
  const int* s_ids = reinterpret_cast<const int*>(s_ids4);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int padded = (n + kStage - 1) / kStage * kStage;
#pragma unroll 4
  for (int t = threadIdx.x; t < padded; t += kThreads) {
    reinterpret_cast<int*>(s_ids4)[t] = t < n ? ids[t] : -1;
  }
  __syncthreads();

  const int j = blockIdx.x * kWarps + warp;
  if (j >= n) return;
  int* list = s_list[warp];
  float* out = agg + (size_t)j * D;
  const int x = s_ids[j];
  if (x < 0) {
    if (lane == 0) uid[j] = -1;
    zero_row(out, D, lane);
    return;
  }

  // the slots holding x, in slot order: `before` of them precede j, `c` in
  // all; list = the first kList of them. 256 ids a step, 8 a lane.
  int before = 0, c = 0;
  for (int g0 = 0; g0 < padded; g0 += kStage) {
    const int4 a = s_ids4[g0 / 4 + lane], b = s_ids4[g0 / 4 + 32 + lane];
    const unsigned in_a = __ballot_sync(0xffffffffu, a.x == x || a.y == x ||
                                                    a.z == x || a.w == x);
    const unsigned in_b = __ballot_sync(0xffffffffu, b.x == x || b.y == x ||
                                                    b.z == x || b.w == x);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (!(half ? in_b : in_a)) continue;
      const int base = g0 + 128 * half;
      const Hits r = hits_of(half ? b : a, x, base, lane);
      if (c < kList) list_hits(r, c, 0, base, lane, list);
      const int s = base + 4 * lane;  // hits before j in this lane
      const int bl = r.h[0] * (s < j) + r.h[1] * (s + 1 < j) +
                     r.h[2] * (s + 2 < j) + r.h[3] * (s + 3 < j);
      before += __reduce_add_sync(0xffffffffu, bl);
      c += r.total;
    }
  }
  __syncwarp();
  if (lane == 0) uid[j] = before == 0 ? x : -1;
  if (before != 0) zero_row(out, D, lane);

  // the shape that gives each of the group's warps at most one slice of
  // one round of loads at D = 400 (a slice: 416, 96, 32, 16, 8 columns)
  float* first = agg + (size_t)list[0] * D;
  if (c <= 4) {
    sum_slices<1, 13, 4>(first, grads, list, s_ids4, x, padded, c, before, D, lane);
  } else if (c <= 12) {
    sum_slices<1, 3, 12>(first, grads, list, s_ids4, x, padded, c, before, D, lane);
  } else if (c <= 36) {
    sum_slices<1, 1, 36>(first, grads, list, s_ids4, x, padded, c, before, D, lane);
  } else if (c <= 72) {
    sum_slices<2, 1, 36>(first, grads, list, s_ids4, x, padded, c, before, D, lane);
  } else {
    sum_slices<4, 1, 36>(first, grads, list, s_ids4, x, padded, c, before, D, lane);
  }
}

// ---------------------------------------------------------------------------
// the scan route, n > kMaxWarpN
// ---------------------------------------------------------------------------
constexpr int kScanWarps = 8;
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kSplit = 4;     // warps per slot, each summing a part of D
static_assert(kScanWarps % kSplit == 0, "whole slots per block");
constexpr int kChunk = 4096;  // ids staged per pass
constexpr int kScan = 4;      // groups of 32 ids compared per vote
constexpr int kScanList = 128;    // matches a warp holds before it drains
constexpr int kCols = 4;      // columns of the sum a lane holds per pass
constexpr int kBatch = 16;    // duplicate rows whose loads are in flight

// out[lo:hi] = (fresh ? 0 : out[lo:hi]) + the sum of grads[list[t]][lo:hi]
// over t ascending, kBatch rows' loads in flight at a time.
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

// kSplit warps a slot, two slots a block: each warp compares its slot's id
// with 128 staged ids a step and votes; a match below the slot makes it a
// duplicate, matches above it are listed and drained in ascending order.
__global__ void __launch_bounds__(kScanThreads)
dedup_scan_kernel(const int* __restrict__ ids, const float* __restrict__ grads,
                  int* __restrict__ uid, float* __restrict__ agg, int n, int D) {
  __shared__ int s_ids[kChunk];
  __shared__ int s_list[kScanWarps][kScanList];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int* list = s_list[warp];
  const int i = blockIdx.x * (kScanWarps / kSplit) + warp / kSplit;
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
    for (int t = threadIdx.x; t < cn; t += kScanThreads) s_ids[t] = ids[c0 + t];
    __syncthreads();
    for (int g0 = 0; first && g0 < cn; g0 += 32 * kScan) {
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
        const int m = __popc(mask);
        if (cnt + m > kScanList) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kMaxWarpN) {
    // the shared-memory limit, set once a device; several host threads may
    // launch at once (ctypes releases the GIL), hence std::call_once
    static std::once_flag once[kMaxDevices];
    static cudaError_t sized[kMaxDevices];
    int dev = 0;
    cudaGetDevice(&dev);
    const int slot = dev % kMaxDevices;
    std::call_once(once[slot], [slot] {
      sized[slot] = cudaFuncSetAttribute(
          dedup_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(sizeof(int) * kMaxWarpN));
    });
    if (sized[slot] != cudaSuccess) return static_cast<int>(sized[slot]);
    const size_t staged = sizeof(int) * ((n + kStage - 1) / kStage * kStage);
    dedup_warp_kernel<<<(n + kWarps - 1) / kWarps, kThreads, staged, s>>>(
        ids, grads, uid, agg, n, D);
  } else {
    constexpr int kSlots = kScanWarps / kSplit;  // slots per block
    dedup_scan_kernel<<<(n + kSlots - 1) / kSlots, kScanThreads, 0, s>>>(
        ids, grads, uid, agg, n, D);
  }
  return static_cast<int>(cudaGetLastError());
}
