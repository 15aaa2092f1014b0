// Launch planning shared by l1_bwd.cu, which splits a reduction over the
// blocks of a thread-block cluster, and the l1 mode of pairwise.cu, which
// picks one of two tile shapes with no split.
//
// A launch covers `tiles` output tiles; each tile's reduction of `nch`
// chunks is split over s blocks (s = 1, 2, 4 or 8, at most nch), which
// combine their partial tiles in rank order. The cost of a plan is the work
// of the busiest SM, in chunks times the tile's size, counting one chunk's
// worth a block for its prologue and combine, and stretching the work where
// the busiest SM holds fewer than kFullWarps warps (too few to keep its four
// schedulers issuing); best_split picks the s of the least cost.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace plan {

constexpr int kFullWarps = 8;  // warps an SM needs to keep issuing
constexpr int kMaxDevices = 64;
constexpr int kMaxSplit = 8;   // the largest portable cluster

// Per-device host caches. Several host threads may launch at once (ctypes
// releases the GIL), so each cache fills its slot under std::call_once: one
// thread fills it, the others wait, and every later call reads the finished
// slot. `fill(dev, slot)` runs once for the calling thread's current device.
template <class Fill>
int once_per_device(std::once_flag (&once)[kMaxDevices], Fill fill) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int slot = dev % kMaxDevices;
  std::call_once(once[slot], fill, dev, slot);
  return slot;
}

// The current device's SM count, read once a device.
inline int sm_count() {
  static std::once_flag once[kMaxDevices];
  static int sms[kMaxDevices];
  const int slot = once_per_device(once, [](int dev, int s) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms[s] = v > 0 ? v : 1;
  });
  return sms[slot];
}

// Blocks of `kernel` an SM holds at `threads` threads and `smem` bytes of
// dynamic shared memory (at least 1).
template <class Kernel>
int blocks_per_sm(Kernel kernel, int threads, size_t smem = 0) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return n > 0 ? n : 1;
}

// Work on the busiest SM for `tiles` tiles of `tile_size` (any unit shared
// by the plans compared) split s ways, blocks of `block_warps` warps,
// `resident` blocks an SM.
inline double cost(int sms, long long tiles, long long nch, int s, int resident,
                   int block_warps, double tile_size) {
  const long long per_sm = (tiles * s + sms - 1) / sms;
  const long long warps = (per_sm < resident ? per_sm : resident) * block_warps;
  double work = (double)per_sm * ((nch + s - 1) / s + 1) * tile_size;
  if (warps < kFullWarps) work *= (double)kFullWarps / warps;
  return work;
}

// The split of the least cost (the smaller on a tie); its cost in *best.
inline int best_split(int sms, long long tiles, long long nch, int resident,
                      int block_warps, double tile_size, double* best) {
  int split = 1;
  *best = -1;
  for (int s = 1; s <= kMaxSplit && (s == 1 || s <= nch); s *= 2) {
    const double c = cost(sms, tiles, nch, s, resident, block_warps, tile_size);
    if (*best < 0 || c < *best) {
      *best = c;
      split = s;
    }
  }
  return split;
}

}  // namespace plan
