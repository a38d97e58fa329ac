// Two-pass run-length reduction machinery of fused_unproject_rle.cu: one
// output row (key, per-run column sums) for every run of consecutive equal
// keys of a stream, runs in stream order. (segreduce.cu runs on the
// single-pass reduce_by_key.cuh, which takes the same SOURCE.)
//
// A kernel supplies the stream as a SOURCE with two device methods:
//   int key(int i)               the key at stream position i;
//   int elem(int i, float* v)    the key, and its D values written to v.
// fused_unproject_rle.cu computes them from a depth image.
//
// Run rule (the contract of the JAX package's rle_body,
// ops/pallas/segreduce.py:63): the sentinel key is ignored and ends runs;
// a run starts at a valid position i when i == 0, when force_break = k > 0
// divides i, or when key(i - 1) != key(i).
//
// Two passes around the tile scan of scan.cuh:
//   count  each tile counts its run starts -> tile_counts[tile] (and,
//          when asked, adds its valid positions to *valid_total);
//   emit   each thread re-derives its starts, takes its run id from the
//          tile offset plus the block scan, writes each run's key and
//          atomically adds its values into the run's row, summing the
//          members of a run inside its own kItems positions first.
// Every value must be a non-negative integer-valued float with every run
// sum below 2^24: then each partial sum is exact and the atomics' order
// does not matter (the result is deterministic).
#pragma once

#include "scan.cuh"

namespace fusion {

constexpr int kMaxCols = 7;

__device__ __forceinline__ bool is_run_start(int i, int key, int prev_key,
                                             int sentinel, int force_break) {
  if (key == sentinel) return false;
  if (i == 0) return true;
  if (force_break > 0 && i % force_break == 0) return true;
  return prev_key != key;
}

// Run starts (and valid positions) among this thread's kItems positions.
template <class Source>
__device__ __forceinline__ void thread_count_runs(const Source& src, int base,
                                                  int n, int sentinel,
                                                  int force_break,
                                                  int* starts, int* valid) {
  int prev = (base > 0 && base < n) ? src.key(base - 1) : sentinel;
  int s = 0, v = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i < n) {
      const int key = src.key(i);
      s += is_run_start(i, key, prev, sentinel, force_break);
      v += key != sentinel;
      prev = key;
    }
  }
  *starts = s;
  *valid = v;
}

// Pass "count" of one tile (blockDim.x == kThreads). valid_total may be
// null; otherwise the tile's valid positions are added to it.
template <class Source>
__device__ void runs_count_tile(const Source& src, int n, int sentinel,
                                int force_break, int* __restrict__ tile_counts,
                                int* __restrict__ valid_total) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int starts, valid;
  thread_count_runs(src, base, n, sentinel, force_break, &starts, &valid);
  int total;
  block_excl_scan<kThreads>(starts, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
  if (valid_total != nullptr) {
    int valid_sum;
    block_excl_scan<kThreads>(valid, &valid_sum);
    if (threadIdx.x == 0) atomicAdd(valid_total, valid_sum);
  }
}

// Pass "emit" of one tile: out_keys[run] = key at the run's start,
// out_sums[run, :d] += values, for runs below capacity (the caller
// pre-fills out_keys with the sentinel and out_sums with zeros).
template <class Source>
__device__ void runs_emit_tile(const Source& src, int n, int d, int sentinel,
                               int force_break, int capacity,
                               const int* __restrict__ tile_offsets,
                               int* __restrict__ out_keys,
                               float* __restrict__ out_sums) {
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int starts, valid;
  thread_count_runs(src, base, n, sentinel, force_break, &starts, &valid);
  int total;
  const int excl = block_excl_scan<kThreads>(starts, &total);
  // id of the run open just before this thread's first position
  int run = tile_offsets[blockIdx.x] + excl - 1;
  int prev = (base > 0 && base < n) ? src.key(base - 1) : sentinel;
  int acc_run = -1;
  float acc[kMaxCols];
  float v[kMaxCols];
  for (int k = 0; k < kItems; ++k) {
    const int i = base + k;
    if (i >= n) break;
    const int key = src.elem(i, v);
    const bool start = is_run_start(i, key, prev, sentinel, force_break);
    prev = key;
    if (key == sentinel) continue;
    if (start) {
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
    for (int c = 0; c < d; ++c) acc[c] += v[c];
  }
  if (acc_run >= 0)
    for (int c = 0; c < d; ++c)
      atomicAdd(&out_sums[(size_t)acc_run * d + c], acc[c]);
}

}  // namespace fusion
