// Run-length segmented reduction: one compacted output row
// (key, per-run sums of D value columns) for every run of consecutive
// equal keys, runs in stream order.
//
// Replaces: ros_gpu_depthmap_fusion_tpu/ops/pallas/segreduce.py:233
// rle_reduce_pallas (pallas_call at :209, body rle_body at :63). Same
// contract: sentinel keys are ignored and end runs; force_break = k > 0
// starts a run at every stream position divisible by k; out_keys holds
// the sentinel and out_sums zeros past the count (the caller pre-fills
// them); counts = {min(runs, capacity), runs}.
//
// Design (two passes around the shared tile scan, scan.cuh):
//   pass A  start[i] = valid[i] && (i == 0 || key[i] != key[i-1]
//                                   || (fb && i % fb == 0)),
//           valid[i] = key[i] != sentinel; each tile counts its starts.
//   scan    exclusive tile offsets, and the run total.
//   pass B  each valid element's run id is its tile offset plus the starts
//           at or before it in the tile, minus one. The start element
//           writes the key; every valid element adds its D values into
//           out_sums[run] with atomicAdd when run < capacity. A thread
//           first sums the members of a run inside its own 16 elements
//           and issues one atomicAdd per (run, column) it touches.
//
// Exactness: every value is a non-negative integer-valued float and every
// run sum is below 2^24 (the caller's contract: 10/10/12-bit quantized
// coordinates and 0/1 counts), so every partial sum is an exact float and
// the result does not depend on the order the atomics land in: it is
// deterministic and bit-equal to the plain twin.
//
// Bound on the card: memory. Per element it reads the key twice (passes A
// and B; the neighbour key comes from L1) and D floats once, and does at
// most D atomics per run fragment per thread. At level 1 (N = 3.26M,
// D = 4) that is ~78 MB of reads. Left for later: a single-pass scan with
// decoupled look-back (one key read), and warp-level aggregation of the
// atomics of long level-2 runs (many partials of one cell, all adding
// into one address).
#include "scan.cuh"

namespace fusion {

constexpr int kMaxCols = 7;

__device__ __forceinline__ bool run_start(const int* __restrict__ keys,
                                          int i, int key, int sentinel,
                                          int force_break) {
  if (key == sentinel) return false;
  if (i == 0) return true;
  if (force_break > 0 && i % force_break == 0) return true;
  return keys[i - 1] != key;
}

static __global__ void __launch_bounds__(kThreads)
segreduce_count_kernel(const int* __restrict__ keys, int n, int sentinel,
                       int force_break, int* __restrict__ tile_counts) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int starts = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i < n) starts += run_start(keys, i, keys[i], sentinel, force_break);
  }
  int total;
  block_excl_scan<kThreads>(starts, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

static __global__ void __launch_bounds__(kThreads)
segreduce_emit_kernel(const int* __restrict__ keys,
                      const float* __restrict__ vals, int n, int d,
                      int sentinel, int force_break, int capacity,
                      const int* __restrict__ tile_offsets,
                      int* __restrict__ out_keys,
                      float* __restrict__ out_sums) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int starts = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i < n) starts += run_start(keys, i, keys[i], sentinel, force_break);
  }
  int total;
  const int excl = block_excl_scan<kThreads>(starts, &total);
  // id of the run open just before this thread's first element
  int run = tile_offsets[blockIdx.x] + excl - 1;
  int acc_run = -1;
  float acc[kMaxCols];
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i >= n) break;
    const int key = keys[i];
    if (key == sentinel) continue;
    if (run_start(keys, i, key, sentinel, force_break)) {
      ++run;
      if (run < capacity) out_keys[run] = key;
    }
    if (run >= capacity) continue;
    if (run != acc_run) {
      if (acc_run >= 0)
        for (int c = 0; c < d; ++c)
          atomicAdd(&out_sums[(size_t)acc_run * d + c], acc[c]);
      acc_run = run;
      for (int c = 0; c < d; ++c) acc[c] = 0.0f;
    }
    for (int c = 0; c < d; ++c) acc[c] += vals[(size_t)i * d + c];
  }
  if (acc_run >= 0)
    for (int c = 0; c < d; ++c)
      atomicAdd(&out_sums[(size_t)acc_run * d + c], acc[c]);
}

}  // namespace fusion

// keys [n] int32, vals [n, d] float32 row-major (d <= 7); tile_counts and
// tile_offsets: scratch of fusion_scan_tiles(n) int32 each; counts [2];
// out_keys [capacity] pre-filled with the sentinel; out_sums
// [capacity, d] pre-filled with zeros. Returns cudaGetLastError().
extern "C" int fusion_segreduce(const int* keys, const float* vals, int n,
                                int d, int sentinel, int force_break,
                                int capacity, int* tile_counts,
                                int* tile_offsets, int* counts,
                                int* out_keys, float* out_sums,
                                cudaStream_t stream) {
  using namespace fusion;
  if (d < 1 || d > kMaxCols) return (int)cudaErrorInvalidValue;
  const int tiles = num_tiles(n);
  if (tiles > 0)
    segreduce_count_kernel<<<tiles, kThreads, 0, stream>>>(
        keys, n, sentinel, force_break, tile_counts);
  launch_scan_tile_counts(tile_counts, tile_offsets, tiles, capacity,
                          counts, stream);
  if (tiles > 0)
    segreduce_emit_kernel<<<tiles, kThreads, 0, stream>>>(
        keys, vals, n, d, sentinel, force_break, capacity, tile_offsets,
        out_keys, out_sums);
  return (int)cudaGetLastError();
}
