// Run-length segmented reduction: one compacted output row
// (key, per-run sums of D value columns) for every run of consecutive
// equal keys, runs in stream order.
//
// Replaces: ros_gpu_depthmap_fusion_tpu/ops/pallas/segreduce.py:233
// rle_reduce_pallas (pallas_call at :209, body rle_body at :63). Same
// contract: sentinel keys are ignored and end runs; force_break = k > 0
// starts a run at every stream position divisible by k; out_keys holds
// the sentinel and out_sums zeros past the count; counts =
// {min(runs, capacity), runs}.
//
// Design: the single-pass reduce-by-key of reduce_by_key.cuh over an array
// source, one launch after a memset of the look-back descriptors (a few KB).
// Each key is read once (coalesced, through shared memory) and each valid
// position's value row once (a float4 at D = 4; a sentinel's values are
// never read); a thread sums the runs among its 8 consecutive positions
// with plain adds, one segmented warp scan carries the partials between
// threads, and every run's row is written once with plain stores; only
// the rows past the count are filled. At level 1 (force_break = 128,
// which divides the 2048-position tile) no run crosses a tile and the
// carry look-back is skipped; level 2 (sorted partials) carries the open
// run's partial sums between tiles.
//
// Exactness: every value is a non-negative integer-valued float and every
// run sum is below 2^24 (the caller's contract: 10/10/12-bit quantized
// coordinates and 0/1 counts), so every partial sum is an exact float and
// the result does not depend on the order of the additions: it is
// deterministic and bit-equal to the plain twin.
//
// Bound on the card: memory. It must read every key, the value rows of
// the valid (non-sentinel) positions, and write 4 + 4 D bytes per output
// row. At link frame 6, level 1 (N = 3.26M of which 0.52M valid, D = 4,
// capacity 448k) that is ~31 MB, ~9 us at 3.35 TB/s; level 2 (557k sorted
// partials, capacity 16k) ~9 MB, ~3 us. Its own costs beyond that: a
// tile's wait for its look-back, the launch and the memset (PERF.md has
// the measured times).
#include "reduce_by_key.cuh"

namespace fusion {

// The stream from arrays; kVec4 reads a D = 4 row as one float4.
template <int D, bool kVec4>
struct ArraySource {
  const int* keys;
  const float* vals;
  __device__ __forceinline__ int key(int i) const { return keys[i]; }
  __device__ __forceinline__ void elem(int i, float* v) const {
    if constexpr (kVec4) {
      const float4 q = reinterpret_cast<const float4*>(vals)[i];
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) v[c] = vals[(size_t)i * D + c];
    }
  }
};

// At most 64 registers a thread, so that 4 tiles share an SM: a tile's
// latency (key load, look-back, value load) hides behind the others'.
template <int D, bool kVec4>
static __global__ void __launch_bounds__(rbk::kThreads, 4)
segreduce_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                 int n, int sentinel, int force_break, int capacity,
                 bool carry_mode, int tiles, rbk::Scratch s,
                 int* __restrict__ out_keys, float* __restrict__ out_sums,
                 int* __restrict__ counts) {
  const ArraySource<D, kVec4> src{keys, vals};
  rbk::reduce_by_key_block<D>(src, rbk::claim_tile(s), n, sentinel,
                              force_break, capacity, carry_mode, tiles, s,
                              out_keys, out_sums, counts);
}

template <int D, bool kVec4>
static void launch(const int* keys, const float* vals, int n, int sentinel,
                   int force_break, int capacity, void* scratch, int* counts,
                   int* out_keys, float* out_sums, cudaStream_t stream) {
  const int tiles = rbk::num_tiles(n);
  const bool carry_mode = !(force_break > 0 && rbk::kTile % force_break == 0);
  const int blocks = tiles + rbk::num_fill_blocks(capacity);
  segreduce_kernel<D, kVec4><<<blocks, rbk::kThreads, 0, stream>>>(
      keys, vals, n, sentinel, force_break, capacity, carry_mode, tiles,
      rbk::scratch_at(scratch, tiles), out_keys, out_sums, counts);
}

}  // namespace fusion

// Bytes of scratch fusion_segreduce needs for n positions.
extern "C" long long fusion_segreduce_scratch_bytes(int n) {
  return (long long)fusion::rbk::scratch_bytes(fusion::rbk::num_tiles(n));
}

// keys [n] int32, vals [n, d] float32 row-major (1 <= d <= 7); scratch of
// fusion_segreduce_scratch_bytes(n) bytes, 16-byte aligned; counts [2];
// out_keys [capacity] and out_sums [capacity, d] (16-byte aligned) need no
// initialisation. Returns cudaGetLastError().
extern "C" int fusion_segreduce(const int* keys, const float* vals, int n,
                                int d, int sentinel, int force_break,
                                int capacity, void* scratch, int* counts,
                                int* out_keys, float* out_sums,
                                cudaStream_t stream) {
  using namespace fusion;
  if (d < 1 || d > rbk::kMaxD || capacity < 1 || n < 0
      || n > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int tiles = rbk::num_tiles(n);
  cudaError_t err = cudaMemsetAsync(scratch, 0, rbk::memset_bytes(tiles),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const bool vec4 = d == 4 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
#define FUSION_SEGREDUCE_CASE(D)                                          \
  case D:                                                                 \
    launch<D, false>(keys, vals, n, sentinel, force_break, capacity,      \
                     scratch, counts, out_keys, out_sums, stream);        \
    break;
  if (vec4) {
    launch<4, true>(keys, vals, n, sentinel, force_break, capacity, scratch,
                    counts, out_keys, out_sums, stream);
  } else {
    switch (d) {
      FUSION_SEGREDUCE_CASE(1)
      FUSION_SEGREDUCE_CASE(2)
      FUSION_SEGREDUCE_CASE(3)
      FUSION_SEGREDUCE_CASE(4)
      FUSION_SEGREDUCE_CASE(5)
      FUSION_SEGREDUCE_CASE(6)
      FUSION_SEGREDUCE_CASE(7)
    }
  }
#undef FUSION_SEGREDUCE_CASE
  return (int)cudaGetLastError();
}
