// Stable stream compaction of flagged rows of 32-bit words into a static
// capacity, plus the clamped and the true count.
//
// Replaces: ros_gpu_depthmap_fusion_tpu/ops/pallas/compact.py:268
// compact_rows_pallas (_compact_pallas at :227, pallas_call at :243, body
// _kernel at :192; the slab emitter _emit_slabs :75 and the lane scan
// _prefix_incl :64 are shared there with the segreduce kernel, as
// scan.cuh is shared here). Rows travel as raw 32-bit words, so int32
// payloads of any magnitude and float32 payloads move bit for bit.
//
// Design (two passes around the shared tile scan, scan.cuh): pass A counts
// each tile's flags; one block scans the tile counts; pass B ranks each
// flagged row (tile offset + in-tile exclusive prefix) and copies its d
// words to out[rank] when rank < capacity. Rows past the count stay as the
// caller pre-filled them (zeros).
//
// Bound on the card: memory. The flags are read twice and each flagged
// row once; at the main-path shape (26,250 blocks x 5 words -> 4,096) the
// whole job is ~0.6 MB and the three launches dominate. Left for later:
// the single-pass look-back scan, and fusing the flag computation
// (nonzero bitmap block) into pass A.
#include "scan.cuh"

namespace fusion {

static __global__ void __launch_bounds__(kThreads)
compact_count_kernel(const uint8_t* __restrict__ flags, int n,
                     int* __restrict__ tile_counts) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i < n) cnt += flags[i] != 0;
  }
  int total;
  block_excl_scan<kThreads>(cnt, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

static __global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const int* __restrict__ words,
                       const uint8_t* __restrict__ flags, int n, int d,
                       int capacity, const int* __restrict__ tile_offsets,
                       int* __restrict__ out) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i < n) cnt += flags[i] != 0;
  }
  int total;
  int rank = tile_offsets[blockIdx.x] + block_excl_scan<kThreads>(cnt, &total);
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i >= n || rank >= capacity) break;
    if (!flags[i]) continue;
    for (int c = 0; c < d; ++c)
      out[(size_t)rank * d + c] = words[(size_t)i * d + c];
    ++rank;
  }
}

}  // namespace fusion

// words [n, d] int32 row-major; flags [n] uint8 (0/1); tile_counts and
// tile_offsets: scratch of fusion_scan_tiles(n) int32 each; counts [2];
// out [capacity, d] pre-filled with zeros. Returns cudaGetLastError().
extern "C" int fusion_compact(const int* words, const uint8_t* flags, int n,
                              int d, int capacity, int* tile_counts,
                              int* tile_offsets, int* counts, int* out,
                              cudaStream_t stream) {
  using namespace fusion;
  if (d < 1) return (int)cudaErrorInvalidValue;
  const int tiles = num_tiles(n);
  if (tiles > 0)
    compact_count_kernel<<<tiles, kThreads, 0, stream>>>(flags, n,
                                                         tile_counts);
  launch_scan_tile_counts(tile_counts, tile_offsets, tiles, capacity,
                          counts, stream);
  if (tiles > 0)
    compact_scatter_kernel<<<tiles, kThreads, 0, stream>>>(
        words, flags, n, d, capacity, tile_offsets, out);
  return (int)cudaGetLastError();
}

// Scratch size (int32 entries) of tile_counts / tile_offsets for n
// elements, shared by fusion_segreduce and fusion_compact.
extern "C" int fusion_scan_tiles(int n) { return fusion::num_tiles(n); }

extern "C" const char* fusion_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
