// Single-pass reduce-by-key with decoupled look-back: one output row (key,
// per-run column sums) for every run of consecutive equal keys of a stream,
// runs in stream order, in one kernel launch (after one small memset of the
// look-back descriptors).
//
// A kernel supplies the stream as a SOURCE with two device methods:
//   int key(int i)               the key at stream position i;
//   void elem(int i, float* v)   position i's D values, written to v.
// A block asks for the key of every position of its tile and of the two
// positions around it, then (after a block barrier) for the values of the
// tile's valid positions: segreduce.cu reads both from arrays,
// fused_unproject_rle.cu computes them from a depth image and keeps a
// tile's values in shared memory between the two calls.
//
// Run rule (the contract of the JAX package's rle_body,
// ops/pallas/segreduce.py:63): the sentinel key is ignored and ends runs;
// a run starts at a valid position i when i == 0, when force_break = k > 0
// divides i, or when key(i - 1) != key(i).
//
// Layout: a tile of kTile = 2048 positions per block of 256 threads;
// thread t owns the kItems = 8 consecutive positions [tile * 2048 + 8 t,
// ... + 8) (a blocked arrangement, as CUB's reduce-by-key), so a run is
// summed inside a thread with plain adds, and only the threads' trailing
// partials cross lanes.
//
//   stage 1  the block loads the tile's keys coalesced (position
//            r * 256 + t) into shared memory and each thread reads its 8
//            back (two int4); it marks run heads and segment heads (run
//            heads and sentinel positions) and the positions that end a
//            run, counts its heads; a block scan gives each thread its
//            first run id inside the tile, and warp 0 publishes the tile's
//            count and looks back over its predecessors' descriptors (32
//            at a time, lookback.cuh) for the tile's first run id.
//   stage 2  each thread reads the value rows of its valid positions (a
//            float4 each at D = 4) and folds them into its trailing
//            partial (the sum since its last segment head); one segmented
//            warp scan over the 32 lanes and a fold over the 8 warps give
//            each thread the carry into its first position. When runs can
//            cross tiles, warp 0 first publishes the tile's carry and looks
//            back for the carry into the tile. Then each thread sums its
//            runs again from the carry and writes each run it ends once,
//            with plain stores: no atomics, and no fill of live rows.
//   fill     blocks past the last tile wait for the last tile's inclusive
//            count and write the sentinel and zeros to the rows in
//            [count, capacity) only; the last tile writes counts =
//            {min(runs, capacity), runs}.
//
// Tile ids come from an atomic counter in the scratch (claim_tile), so a
// tile's predecessors have all started and the look-back always makes
// progress.
// When force_break divides kTile every tile starts a run (or holds a
// sentinel there), no run crosses a tile, and the carry look-back is
// skipped. Every value must be a non-negative integer-valued float with
// every run sum below 2^24: then every partial sum is exact and the result
// does not depend on the order of the additions.
#pragma once

#include "lookback.cuh"

namespace fusion {
namespace rbk {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kItems = 8;                  // consecutive positions a thread
constexpr int kTile = kThreads * kItems;   // positions per tile (2048)
constexpr int kFillRows = 4096;            // output rows per fill block
constexpr int kMaxD = 7;
using lb::kFull;

// Scratch of one call: count_desc[tiles] (lookback.cuh), counter,
// carry_flag[tiles] (a status), carry_val[tiles][2][8] (the aggregate and
// the inclusive carry: separate slots, so that a reader who saw the
// aggregate status never reads the inclusive values written after it).
// The first memset_bytes must be zero before the launch.
struct Scratch {
  unsigned long long* count_desc;
  int* counter;
  unsigned* carry_flag;
  float* carry_val;
};

static inline size_t memset_bytes(int tiles) {
  return (size_t)tiles * 8 + 4 + (size_t)tiles * 4;
}
static inline size_t carry_offset(int tiles) {
  return (memset_bytes(tiles) + 15) / 16 * 16;
}
static inline size_t scratch_bytes(int tiles) {
  return carry_offset(tiles) + (size_t)tiles * 16 * sizeof(float);
}
static inline Scratch scratch_at(void* base, int tiles) {
  char* p = static_cast<char*>(base);
  Scratch s;
  s.count_desc = reinterpret_cast<unsigned long long*>(p);
  s.counter = reinterpret_cast<int*>(p + (size_t)tiles * 8);
  s.carry_flag = reinterpret_cast<unsigned*>(p + (size_t)tiles * 8 + 4);
  s.carry_val = reinterpret_cast<float*>(p + carry_offset(tiles));
  return s;
}
static inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }
static inline int num_fill_blocks(int capacity) {
  return (capacity + kFillRows - 1) / kFillRows;
}

__device__ __forceinline__ bool forced_break(int i, int fb) {
  if (fb <= 0) return false;
  return (fb & (fb - 1)) == 0 ? (i & (fb - 1)) == 0 : i % fb == 0;
}

// Carry into tile t (> 0), by the whole warp: the sum of the predecessors'
// carries back to the nearest inclusive one. Only a tile without any
// segment head publishes an aggregate (its whole sum, passed through); a
// tile with one publishes its trailing run's partial as inclusive at once.
template <int D>
__device__ __forceinline__ void lookback_carry(const unsigned* flag,
                                               const float* val, int t,
                                               float* carry) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < D; ++c) carry[c] = 0.0f;
  for (int j = t - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned st = lb::kInclusive;
    float v[D];
#pragma unroll
    for (int c = 0; c < D; ++c) v[c] = 0.0f;
    if (idx >= 0) {
      while ((st = lb::ld_acquire(flag + idx)) == lb::kNotReady)
        __nanosleep(20);
      const size_t slot = ((size_t)idx * 2 + (st == lb::kInclusive)) * 8;
#pragma unroll
      for (int c = 0; c < D; ++c) v[c] = __ldcg(val + slot + c);
    }
    __syncwarp();
    const unsigned stop = __ballot_sync(kFull, st == lb::kInclusive);
    const bool use = !stop || lane <= __ffs(stop) - 1;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      float s = use ? v[c] : 0.0f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      carry[c] += s;
    }
    if (stop) return;
  }
}

template <int D>
__device__ __forceinline__ void publish_carry(unsigned* flag, float* val,
                                              int t, unsigned status,
                                              const float* v) {
  const size_t slot = ((size_t)t * 2 + (status == lb::kInclusive)) * 8;
#pragma unroll
  for (int c = 0; c < D; ++c) __stcg(val + slot + c, v[c]);
  lb::st_release(flag + t, status);
}

template <int D>
__device__ __forceinline__ void store_row(int* out_keys, float* out_sums,
                                          int row, int key, const float* v) {
  out_keys[row] = key;
  if constexpr (D == 4) {
    reinterpret_cast<float4*>(out_sums)[row] =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) out_sums[(size_t)row * D + c] = v[c];
  }
}

struct Smem {
  alignas(16) int keys[kTile];  // the tile's keys, striped in, blocked out
  int run_base;
  int edge_key[2];              // the keys just before and after the tile
  int lead;                     // the tile begins inside a run
  int warp_count[kWarps];
  int warp_excl[kWarps];
  int warp_seg[kWarps];         // a segment head in the warp's positions
  float warp_sum[kWarps][kMaxD];  // the warp's trailing partial
  float warp_cin[kWarps][kMaxD];  // the carry into the warp
  int warp_valid[kWarps];         // valid positions (kCountValid only)
};

// The block's tile id (all threads): tiles first, fill blocks after.
__device__ __forceinline__ int claim_tile(const Scratch& s) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(s.counter, 1);
  __syncthreads();
  return tile;
}

// One block, which claimed id t: tile t of the stream, or, past the last
// tile, a fill block. out_sums must be 16-byte aligned when D == 4. With
// kCountValid each tile also adds its number of valid (non-sentinel)
// positions to *valid_out, which must be zero before the launch: one
// integer atomic a tile, exact in any order.
template <int D, bool kCountValid = false, class Source>
__device__ void reduce_by_key_block(const Source& src, int t, int n,
                                    int sentinel, int fb, int capacity,
                                    bool carry_mode, int tiles, Scratch s,
                                    int* __restrict__ out_keys,
                                    float* __restrict__ out_sums,
                                    int* __restrict__ counts,
                                    int* __restrict__ valid_out = nullptr) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;

  if (t >= tiles) {  // ---- fill the rows past the count
    if (tid == 0) {
      sm.run_base = tiles > 0 ? lb::wait_inclusive(s.count_desc, tiles - 1)
                              : 0;
      if (tiles == 0 && t == 0) {
        counts[0] = 0;
        counts[1] = 0;
      }
    }
    __syncthreads();
    const int f = t - tiles;
    const int lo = max(sm.run_base, f * kFillRows);
    const int hi = min(capacity, (f + 1) * kFillRows);
    float z[D];
#pragma unroll
    for (int c = 0; c < D; ++c) z[c] = 0.0f;
    for (int r = lo + tid; r < hi; r += kThreads)
      store_row<D>(out_keys, out_sums, r, sentinel, z);
    return;
  }

  // ---- stage 1: keys, heads, counts
  const int tb = t * kTile;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int i = tb + r * kThreads + tid;
    sm.keys[r * kThreads + tid] = i < n ? src.key(i) : sentinel;
  }
  if (tid == 0) sm.edge_key[0] = tb > 0 ? src.key(tb - 1) : sentinel;
  if (tid == kThreads - 1)
    sm.edge_key[1] = tb + kTile < n ? src.key(tb + kTile) : sentinel;
  __syncthreads();
  int key[kItems];
  {
    const int4* row = reinterpret_cast<const int4*>(sm.keys + tid * kItems);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 k4 = row[q];
      key[4 * q] = k4.x;
      key[4 * q + 1] = k4.y;
      key[4 * q + 2] = k4.z;
      key[4 * q + 3] = k4.w;
    }
  }
  const int i0 = tb + tid * kItems;
  int prev = tid ? sm.keys[tid * kItems - 1] : sm.edge_key[0];
  const int after = tid < kThreads - 1 ? sm.keys[tid * kItems + kItems]
                                       : sm.edge_key[1];
  unsigned head = 0, seg = 0, valid = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = i0 + k;
    const bool ok = key[k] != sentinel;
    const bool h = ok && (i == 0 || forced_break(i, fb) || key[k] != prev);
    head |= (unsigned)h << k;
    seg |= (unsigned)(h || !ok) << k;
    valid |= (unsigned)ok << k;
    prev = key[k];
  }
  const bool seg_after = after == sentinel
                         || forced_break(i0 + kItems, fb) || after != prev;
  // positions whose next position is a segment head end their run
  const unsigned ends = valid & ((seg >> 1) | ((unsigned)seg_after
                                               << (kItems - 1)));
  const int count = __popc(head);
  const int incl = lb::warp_incl_scan(count);
  if (lane == 31) sm.warp_count[w] = incl;
  if (tid == 0) sm.lead = !(seg & 1u);
  if constexpr (kCountValid) {
    const int nv = lb::warp_sum(__popc(valid));
    if (lane == 0) sm.warp_valid[w] = nv;
  }
  __syncthreads();
  if (w == 0) {
    if constexpr (kCountValid) {
      const int nv = lb::warp_sum(lane < kWarps ? sm.warp_valid[lane] : 0);
      if (lane == 0 && nv) atomicAdd(valid_out, nv);
    }
    const int c = lane < kWarps ? sm.warp_count[lane] : 0;
    const int wincl = lb::warp_incl_scan(c);
    if (lane < kWarps) sm.warp_excl[lane] = wincl - c;
    const int total = __shfl_sync(kFull, wincl, kWarps - 1);
    const int run_base = lb::publish_and_look_back(s.count_desc, t, total);
    if (lane == 0) {
      sm.run_base = run_base;
      if (t == tiles - 1) {
        const int runs = run_base + total;
        counts[0] = runs < capacity ? runs : capacity;
        counts[1] = runs;
      }
    }
  }

  // ---- stage 2: values, the thread's trailing partial, the carries
  float v[kItems][D];
  float part[D];
#pragma unroll
  for (int c = 0; c < D; ++c) part[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if ((valid >> k) & 1u) {
      src.elem(i0 + k, v[k]);
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) v[k][c] = 0.0f;
    }
    const bool restart = (seg >> k) & 1u;
#pragma unroll
    for (int c = 0; c < D; ++c) part[c] = restart ? v[k][c] : part[c] + v[k][c];
  }
  // segmented inclusive scan of (has segment head, partial) over the warp
  bool f = seg != 0;
  float sc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) sc[c] = part[c];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const bool fu = __shfl_up_sync(kFull, (int)f, o);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const float u = __shfl_up_sync(kFull, sc[c], o);
      if (lane >= o && !f) sc[c] += u;
    }
    if (lane >= o) f = f || fu;
  }
  if (lane == 31) {
    sm.warp_seg[w] = f;
#pragma unroll
    for (int c = 0; c < D; ++c) sm.warp_sum[w][c] = sc[c];
  }
  // exclusive: the lane before's inclusive value
  bool fx = __shfl_up_sync(kFull, (int)f, 1);
  float cx[D];
#pragma unroll
  for (int c = 0; c < D; ++c) cx[c] = __shfl_up_sync(kFull, sc[c], 1);
  if (lane == 0) {
    fx = false;
#pragma unroll
    for (int c = 0; c < D; ++c) cx[c] = 0.0f;
  }
  __syncthreads();
  if (w == 0) {  // the carry into the tile, then into each warp
    float cin[D];
#pragma unroll
    for (int c = 0; c < D; ++c) cin[c] = 0.0f;
    if (carry_mode) {
      float agg[D];
      bool tile_seg = false;
#pragma unroll
      for (int c = 0; c < D; ++c) agg[c] = 0.0f;
      for (int k = 0; k < kWarps; ++k) {
        tile_seg = tile_seg || sm.warp_seg[k];
#pragma unroll
        for (int c = 0; c < D; ++c)
          agg[c] = sm.warp_seg[k] ? sm.warp_sum[k][c]
                                  : agg[c] + sm.warp_sum[k][c];
      }
      if (lane == 0)
        publish_carry<D>(s.carry_flag, s.carry_val, t,
                         t == 0 || tile_seg ? lb::kInclusive
                                            : lb::kAggregate,
                         agg);
      if (t > 0 && sm.lead) {
        lookback_carry<D>(s.carry_flag, s.carry_val, t, cin);
        if (!tile_seg && lane == 0) {
          float out[D];
#pragma unroll
          for (int c = 0; c < D; ++c) out[c] = cin[c] + agg[c];
          publish_carry<D>(s.carry_flag, s.carry_val, t, lb::kInclusive,
                           out);
        }
      }
    }
    if (lane == 0) {
      for (int k = 0; k < kWarps; ++k) {
#pragma unroll
        for (int c = 0; c < D; ++c) {
          sm.warp_cin[k][c] = cin[c];
          cin[c] = sm.warp_seg[k] ? sm.warp_sum[k][c]
                                  : cin[c] + sm.warp_sum[k][c];
        }
      }
    }
  }
  __syncthreads();

  // ---- the runs this thread ends, each written once
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    acc[c] = fx ? cx[c] : cx[c] + sm.warp_cin[w][c];
  int run = sm.run_base + sm.warp_excl[w] + incl - count - 1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool restart = (seg >> k) & 1u;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] = restart ? v[k][c] : acc[c] + v[k][c];
    run += (head >> k) & 1u;
    if (((ends >> k) & 1u) && run < capacity)
      store_row<D>(out_keys, out_sums, run, key[k], acc);
  }
}

}  // namespace rbk
}  // namespace fusion
