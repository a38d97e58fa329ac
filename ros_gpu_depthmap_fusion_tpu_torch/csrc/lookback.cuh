// Decoupled look-back for single-pass scans (reduce_by_key.cuh and
// compact.cu): a tile learns the exclusive prefix of its count from its
// predecessors' descriptors, without a second pass over the input.
//
// Each tile owns one 64-bit descriptor (status << 32 | value), zeroed
// before the launch. It publishes its own count as an AGGREGATE at once,
// then one warp reads the 32 descriptors before it at a time, waits until
// each is published, and sums back to the nearest INCLUSIVE one (a tile's
// full prefix); the tile then publishes its own inclusive prefix. Tile ids
// come from an atomic counter, so every predecessor of a tile has started
// and the wait always ends. A descriptor is one aligned 64-bit word, so
// status and value are read together; release stores and acquire loads at
// GPU scope order it against the data a tile wrote before.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fusion {
namespace lb {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNotReady = 0, kAggregate = 1, kInclusive = 2;

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long desc(unsigned status,
                                                   int value) {
  return (unsigned long long)status << 32 | (unsigned)value;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Inclusive scan of one int per lane over a warp.
__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// By one whole warp of tile t: publish the tile's count `total`, look back,
// publish the inclusive prefix; returns the exclusive prefix (all lanes).
__device__ __forceinline__ int publish_and_look_back(
    unsigned long long* descs, int t, int total) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) st_release(descs, desc(kInclusive, total));
    return 0;
  }
  if (lane == 0) st_release(descs + t, desc(kAggregate, total));
  int excl = 0;
  for (int j = t - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long d = desc(kInclusive, 0);
    if (idx >= 0) {
      while ((d = ld_acquire(descs + idx)) >> 32 == kNotReady)
        __nanosleep(20);
    }
    __syncwarp();
    const unsigned stop = __ballot_sync(kFull, (d >> 32) == kInclusive);
    int v = (int)(unsigned)d;
    if (stop && lane > __ffs(stop) - 1) v = 0;
    excl += warp_sum(v);
    if (stop) break;
  }
  if (lane == 0) st_release(descs + t, desc(kInclusive, excl + total));
  return excl;
}

// By one thread: wait for tile t's inclusive prefix and return it.
__device__ __forceinline__ int wait_inclusive(
    const unsigned long long* descs, int t) {
  unsigned long long d;
  while ((d = ld_acquire(descs + t)) >> 32 != kInclusive) __nanosleep(100);
  return (int)(unsigned)d;
}

}  // namespace lb
}  // namespace fusion
