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
// Design: the two passes around the shared tile scan of runs.cuh, with
// the keys and values read from arrays. A thread first sums the members of
// a run inside its own 16 elements and issues one atomicAdd per (run,
// column) it touches.
//
// Exactness: every value is a non-negative integer-valued float and every
// run sum is below 2^24 (the caller's contract: 10/10/12-bit quantized
// coordinates and 0/1 counts), so every partial sum is an exact float and
// the result does not depend on the order the atomics land in: it is
// deterministic and bit-equal to the plain twin.
//
// Bound on the card: memory. Per element it reads the key twice (passes A
// and B) and D floats once, and does at most D atomics per run fragment
// per thread. At level 1 (N = 3.26M, D = 4) that is ~78 MB of reads. Left
// for later: a single-pass scan with decoupled look-back (one key read),
// and warp-level aggregation of the atomics of long level-2 runs (many
// partials of one cell, all adding into one address).
#include "runs.cuh"

namespace fusion {

struct ArraySource {
  const int* keys;
  const float* vals;
  int d;
  __device__ __forceinline__ int key(int i) const { return keys[i]; }
  __device__ __forceinline__ int elem(int i, float* v) const {
    for (int c = 0; c < d; ++c) v[c] = vals[(size_t)i * d + c];
    return keys[i];
  }
};

static __global__ void __launch_bounds__(kThreads)
segreduce_count_kernel(ArraySource src, int n, int sentinel, int force_break,
                       int* __restrict__ tile_counts) {
  runs_count_tile(src, n, sentinel, force_break, tile_counts, nullptr);
}

static __global__ void __launch_bounds__(kThreads)
segreduce_emit_kernel(ArraySource src, int n, int sentinel, int force_break,
                      int capacity, const int* __restrict__ tile_offsets,
                      int* __restrict__ out_keys,
                      float* __restrict__ out_sums) {
  runs_emit_tile(src, n, src.d, sentinel, force_break, capacity,
                 tile_offsets, out_keys, out_sums);
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
  const ArraySource src{keys, vals, d};
  if (tiles > 0)
    segreduce_count_kernel<<<tiles, kThreads, 0, stream>>>(
        src, n, sentinel, force_break, tile_counts);
  launch_scan_tile_counts(tile_counts, tile_offsets, tiles, capacity,
                          counts, stream);
  if (tiles > 0)
    segreduce_emit_kernel<<<tiles, kThreads, 0, stream>>>(
        src, n, sentinel, force_break, capacity, tile_offsets, out_keys,
        out_sums);
  return (int)cudaGetLastError();
}
