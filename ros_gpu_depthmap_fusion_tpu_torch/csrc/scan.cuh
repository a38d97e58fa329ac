// Block scan and two-pass tile scan of runs.cuh (fused_unproject_rle.cu).
// segreduce.cu and compact.cu scan in one pass with lookback.cuh.
//
// A stream of N elements is cut into tiles of kTile = kThreads * kItems
// elements; thread t of a tile owns the kItems CONSECUTIVE elements
// [tile * kTile + t * kItems, ... + kItems). Each kernel runs two passes
// around one small scan:
//
//   pass A  every tile counts its flagged elements -> tile_counts[tile]
//   scan    one block turns tile_counts into exclusive tile_offsets and
//           writes counts = {min(total, capacity), total}
//   pass B  every tile re-derives its flags, scans them inside the block
//           (block_excl_scan) and scatters each flagged element to
//           tile_offsets[tile] + its rank inside the tile.
//
// The scan of tile counts is a loop of block scans in one block; at the
// main-path sizes it has < 1,000 entries. A decoupled look-back single-pass
// scan (one read of the input instead of two) is left for later.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fusion {

constexpr int kThreads = 256;              // threads per block
constexpr int kItems = 16;                 // consecutive elements per thread
constexpr int kTile = kThreads * kItems;   // elements per tile
constexpr int kScanThreads = 1024;         // threads of the tile-count scan

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Exclusive scan of one int per thread over a block of THREADS threads
// (a multiple of 32, at most 1024). Returns this thread's exclusive prefix;
// *total receives the block's sum. Every thread of the block must call it.
template <int THREADS>
__device__ __forceinline__ int block_excl_scan(int v, int* total) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "block size");
  constexpr int kWarps = THREADS / 32;
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(v);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    s = warp_incl_scan(s);
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int warp_off = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return warp_off + incl - v;
}

// One block: tile_offsets[i] = sum(tile_counts[:i]);
// counts[0] = min(total, capacity), counts[1] = total.
static __global__ void __launch_bounds__(kScanThreads)
scan_tile_counts_kernel(const int* __restrict__ tile_counts,
                        int* __restrict__ tile_offsets, int n_tiles,
                        int capacity, int* __restrict__ counts) {
  int carry = 0;
  for (int base = 0; base < n_tiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < n_tiles ? tile_counts[i] : 0;
    int total;
    const int excl = block_excl_scan<kScanThreads>(v, &total);
    if (i < n_tiles) tile_offsets[i] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) {
    counts[0] = carry < capacity ? carry : capacity;
    counts[1] = carry;
  }
}

static inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

static inline void launch_scan_tile_counts(const int* tile_counts,
                                           int* tile_offsets, int n_tiles,
                                           int capacity, int* counts,
                                           cudaStream_t stream) {
  scan_tile_counts_kernel<<<1, kScanThreads, 0, stream>>>(
      tile_counts, tile_offsets, n_tiles, capacity, counts);
}

}  // namespace fusion
