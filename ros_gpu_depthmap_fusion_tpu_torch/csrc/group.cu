// The mapping stage's foreground grouping: the cells of a segmentation
// whose merged id names an object, grouped by (object, layer) in raster
// order, the groups' boundaries, and the list of per-layer components with
// their first pixels, so that the host assembles objects from the
// foreground rows alone instead of passing over the dense label grid.
//
// No TPU counterpart: the JAX package assembles objects on the host
// (native/src/fusionhost.cpp fh_assemble_count and the first half of
// fh_assemble_objects: three passes over every cell of the [Z, Y, X]
// labels). This computes what those passes compute, on the card, from the
// segmentation's merged map; the port's plain twin is
// mapping/segmentation.py group_foreground_plain, bit for bit.
//
// Outputs, with M = num_merged and fg the foreground cells (merged id in
// [1, M)): counts = (fg, ncomp) and, back to back in rows (int32),
//   group_start [M * Z + 1]  the first row of group (m, z), groups in
//                            (m, z) order; the last entry is fg;
//   xy          [fg, 2]      each foreground cell's (x, y), groups in
//                            order, raster order within a group;
//   comps       [ncomp, 4]   (z, l, m, first raster index in the layer) of
//                            each component (z, l > 0) holding a
//                            foreground cell, in ascending (z, l).
//
// Design.
// 1. A memset zeroes the compaction's look-back descriptors and tile
//    counter and the component table.
// 2. compact: a stable compaction of the foreground cells, z-major, into
//    (m, flat index) pairs: 4,096 cells a block, decoupled look-back
//    (lookback.cuh) for the block's first row. A warp also records each
//    (z, label) it sees with the complement of its first cell's raster
//    index, by one atomicMax a distinct label a warp (the table starts at
//    zero, so a present entry is never zero).
// 3. An LSD radix sort of the pairs by m, 8 bits a pass, as many passes
//    as m < Z * L needs (two at 21 layers of 256 labels): hist (each tile
//    of 1,024 pairs counts its digits), scan (one block: the exclusive
//    scan of the digit-major counts) and scatter (a pair's rank among the
//    tile's pairs of its digit, counted in pair order by warp matches).
//    Each pass is stable, so the pairs end in (m, z, raster) order. A pass
//    whose digit is 0 for every id below M returns at once; the finish
//    kernel reads the buffer the last working pass wrote. No host
//    synchronization decides anything.
// 4. finish: each row's (x, y); each group's start by a binary search of
//    its (m, z) key in the sorted rows; in the last block the component
//    list, by a block scan of the component table.
//
// Bound on the card: bytes. The merged map must be read once (4 B a cell:
// 13.4 MB at the node's 21 x 400 x 400 grid), the labels of the foreground
// cells and the rows written once (~0.1 MB at ~8k foreground cells): ~4 us
// at 3.35 TB/s. Past the compaction every kernel touches the foreground
// rows alone, so the chain is held by the compaction's single read and the
// launches' latency.
#include "lookback.cuh"

namespace fusion {
namespace grp {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                  // all kernels but scan
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 16;               // compact: 32-cell rows
constexpr int kCompactTile = kWarps * kRowsPerWarp * 32;   // 4,096 cells
constexpr int kItems = 4;                      // pairs a thread, sort
constexpr int kSortTile = kThreads * kItems;   // 1,024 pairs
constexpr int kDigits = 256;
constexpr int kDigitBits = 8;
constexpr int kScanThreads = 1024;
constexpr int kMaxBlocks = 528;                // grid-stride kernels

struct Args {
  const int* labels;           // [Z, Y, X]
  const int* merged_map;       // [Z, Y, X]
  const int* merged_of_label;  // [Z, L]
  const int* num_merged;       // [1]
  int* counts;                 // [2]: fg, ncomp
  int* rows;                   // group_start | xy | comps
  // scratch
  unsigned long long* descs;   // [compact tiles], zeroed
  int* tile_counter;           // [1], zeroed
  unsigned* first_inv;         // [Z, L], zeroed: ~(first raster index)
  int* hist;                   // [kDigits, sort tiles]
  int2* pairs[2];              // [Z * Y * X] each: (m, flat index)
  int Z, Y, X, L, passes;
};

// Whether radix pass p has a nonzero digit to sort for ids below m_n.
__device__ __forceinline__ bool pass_works(int p, int m_n) {
  return p == 0 || ((m_n - 1) >> (kDigitBits * p)) != 0;
}

__device__ __forceinline__ int sort_tiles(int fg) {
  return (fg + kSortTile - 1) / kSortTile;
}

// Exclusive scan of one int a thread over a 1-D block of THREADS; *total
// is the block's sum. Every thread must call it.
template <int THREADS>
__device__ int block_excl_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x = lb::warp_incl_scan(v);
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    const int s = lane < THREADS / 32 ? s_warp[lane] : 0;
    const int incl = lb::warp_incl_scan(s);
    if (lane < THREADS / 32) s_warp[lane] = incl;
  }
  __syncthreads();
  const int out = x - v + (w ? s_warp[w - 1] : 0);
  *total = s_warp[THREADS / 32 - 1];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads) compact_kernel(Args a,
                                                           int tiles) {
  __shared__ int s_tile, s_base;
  __shared__ int s_count[kWarps], s_excl[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(a.tile_counter, 1);
  __syncthreads();
  const int t = s_tile;
  const int m_n = *a.num_merged;
  const int hw = a.Y * a.X;
  const int n = a.Z * hw;
  const int base = t * kCompactTile + w * (kRowsPerWarp * 32);
  unsigned bits[kRowsPerWarp];
  int ids[kRowsPerWarp];
  int count = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = base + r * 32 + lane;
    const int id = i < n ? __ldg(a.merged_map + i) : 0;
    bits[r] = __ballot_sync(kFull, id >= 1 && id < m_n);
    ids[r] = id;
    count += __popc(bits[r]);
  }
  if (lane == 0) s_count[w] = count;
  __syncthreads();
  if (w == 0) {
    const int c = lane < kWarps ? s_count[lane] : 0;
    const int incl = lb::warp_incl_scan(c);
    if (lane < kWarps) s_excl[lane] = incl - c;
    const int total = __shfl_sync(kFull, incl, kWarps - 1);
    const int first = lb::publish_and_look_back(a.descs, t, total);
    if (lane == 0) {
      s_base = first;
      if (t == tiles - 1) a.counts[0] = first + total;
    }
  }
  __syncthreads();
  int pos = s_base + s_excl[w];
  const unsigned lt = (1u << lane) - 1u;
  int2* out = a.pairs[0];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if ((bits[r] >> lane) & 1u) {
      const int g = base + r * 32 + lane;
      out[pos + __popc(bits[r] & lt)] = make_int2(ids[r], g);
      const int z = g / hw, p = g - z * hw;
      const int l = __ldg(a.labels + g);
      const int key = z * a.L + l;
      // the warp's lowest lane of a label holds its first cell here
      const unsigned peers = __match_any_sync(bits[r], key);
      if (l > 0 && l < a.L && lane == __ffs(peers) - 1)
        atomicMax(a.first_inv + key, ~(unsigned)p);
    }
    pos += __popc(bits[r]);
  }
}

__global__ void __launch_bounds__(kThreads) hist_kernel(Args a, int p) {
  __shared__ int s_hist[kDigits];
  if (!pass_works(p, *a.num_merged)) return;
  const int fg = a.counts[0], tiles = sort_tiles(fg);
  const int shift = kDigitBits * p;
  const int2* src = a.pairs[p & 1];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int d = threadIdx.x; d < kDigits; d += kThreads) s_hist[d] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = t * kSortTile + k * kThreads + threadIdx.x;
      const int d = i < fg ? (src[i].x >> shift) & (kDigits - 1) : kDigits;
      const unsigned peers = __match_any_sync(kFull, d);
      if (d < kDigits && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(s_hist + d, __popc(peers));
    }
    __syncthreads();
    for (int d = threadIdx.x; d < kDigits; d += kThreads)
      a.hist[(size_t)d * tiles + t] = s_hist[d];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kScanThreads) scan_kernel(Args a, int p) {
  __shared__ int s_warp[32];
  if (!pass_works(p, *a.num_merged)) return;
  const int n = kDigits * sort_tiles(a.counts[0]);
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += kScanThreads) {
    const int i = i0 + threadIdx.x;
    const int v = i < n ? a.hist[i] : 0;
    int total;
    const int excl = block_excl_scan<kScanThreads>(v, s_warp, &total);
    if (i < n) a.hist[i] = carry + excl;
    carry += total;
  }
}

__global__ void __launch_bounds__(kThreads) scatter_kernel(Args a, int p) {
  __shared__ int s_cnt[kWarps][kDigits];
  if (!pass_works(p, *a.num_merged)) return;
  const int fg = a.counts[0], tiles = sort_tiles(fg);
  const int shift = kDigitBits * p;
  const int2* src = a.pairs[p & 1];
  int2* dst = a.pairs[(p + 1) & 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int d = lane; d < kDigits; d += 32) s_cnt[w][d] = 0;
    __syncwarp();
    // warp w takes pairs [w * 128, (w + 1) * 128) of the tile, 32 at a
    // time: its counts see them in pair order
    int2 e[kItems];
    int dig[kItems], rank[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = t * kSortTile + (w * kItems + k) * 32 + lane;
      const bool valid = i < fg;
      e[k] = valid ? src[i] : make_int2(0, 0);
      const int d = valid ? (e[k].x >> shift) & (kDigits - 1) : kDigits;
      const unsigned peers = __match_any_sync(kFull, d);
      const int before = valid ? s_cnt[w][valid ? d : 0] : 0;
      dig[k] = d;
      rank[k] = before + __popc(peers & lt);
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1)
        s_cnt[w][d] = before + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // per digit: the tile's global offset, then the warps' in order
    for (int d = threadIdx.x; d < kDigits; d += kThreads) {
      int run = a.hist[(size_t)d * tiles + t];
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int c = s_cnt[v][d];
        s_cnt[v][d] = run;
        run += c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (dig[k] < kDigits) dst[s_cnt[w][dig[k]] + rank[k]] = e[k];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) finish_kernel(Args a) {
  __shared__ int s_warp[32];
  const int m_n = *a.num_merged, fg = a.counts[0];
  int used = 1;  // passes that sorted: the rows are in pairs[used & 1]
  while (used < a.passes && pass_works(used, m_n)) ++used;
  const int2* s = a.pairs[used & 1];
  const int hw = a.Y * a.X;
  const int ng = m_n * a.Z + 1;
  int* xy = a.rows + ng;
  const int stride = gridDim.x * kThreads;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  for (int i = tid; i < fg; i += stride) {
    const int g = s[i].y, q = g % hw, y = q / a.X;
    xy[2 * i] = q - y * a.X;
    xy[2 * i + 1] = y;
  }
  // group k = (m, z) starts at the first row whose key m * Z + z >= k
  for (int k = tid; k < ng; k += stride) {
    int lo = 0, hi = fg;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int2 e = s[mid];
      if (e.x * a.Z + e.y / hw < k)
        lo = mid + 1;
      else
        hi = mid;
    }
    a.rows[k] = lo;
  }
  if (blockIdx.x != gridDim.x - 1) return;
  int* comps = xy + 2 * fg;
  const int table = a.Z * a.L;
  int carry = 0;
  for (int t0 = 0; t0 < table; t0 += kThreads) {
    const int t = t0 + threadIdx.x;
    const unsigned f = t < table ? a.first_inv[t] : 0u;
    int total;
    const int at = carry + block_excl_scan<kThreads>(f != 0u, s_warp,
                                                     &total);
    if (f != 0u) {
      const int z = t / a.L;
      int* c = comps + 4 * at;
      c[0] = z;
      c[1] = t - z * a.L;
      c[2] = a.merged_of_label[t];
      c[3] = (int)~f;
    }
    carry += total;
  }
  if (threadIdx.x == 0) a.counts[1] = carry;
}

struct Layout {
  size_t descs, counter, first, zeroed, hist, pairs0, pairs1, total;
};

static size_t up8(size_t b) { return (b + 7) / 8 * 8; }

static Layout layout(int Z, int Y, int X, int L) {
  const size_t n = (size_t)Z * Y * X;
  const size_t ctiles = (n + kCompactTile - 1) / kCompactTile;
  const size_t stiles = (n + kSortTile - 1) / kSortTile;
  Layout s;
  s.descs = 0;
  s.counter = ctiles * 8;
  s.first = s.counter + 8;
  s.zeroed = up8(s.first + (size_t)Z * L * 4);
  s.hist = s.zeroed;
  s.pairs0 = up8(s.hist + (size_t)kDigits * stiles * 4);
  s.pairs1 = s.pairs0 + n * 8;
  s.total = s.pairs1 + n * 8;
  return s;
}

// Radix passes for merged ids below Z * L, at least one.
static int radix_passes(int Z, int L) {
  int bits = 0;
  for (long long v = (long long)Z * L - 1; v > 0; v >>= 1) ++bits;
  const int p = (bits + kDigitBits - 1) / kDigitBits;
  return p > 0 ? p : 1;
}

}  // namespace grp
}  // namespace fusion

// Bytes of scratch fusion_group needs for a [Z, Y, X] grid of L labels a
// layer.
extern "C" long long fusion_group_scratch_bytes(int Z, int Y, int X, int L) {
  return (long long)fusion::grp::layout(Z, Y, X, L).total;
}

// labels, merged_map [Z, Y, X], merged_of_label [Z, L] and num_merged [1]:
// int32 device pointers of one segmentation (mapping/segmentation.py
// segment). scratch: fusion_group_scratch_bytes(Z, Y, X, L) bytes, 8-byte
// aligned; counts [2] and rows [Z * L * Z + 1 + 2 * Z * Y * X + 4 * Z * L]
// need no initialisation. The caller checks the extents
// (mapping/segmentation.py group_foreground). Launches one memset and
// 2 + 3 * radix_passes(Z, L) kernels on stream (group_launches_per_call
// there); returns the first launch error, or cudaGetLastError().
extern "C" int fusion_group(const int* labels, const int* merged_map,
                            const int* merged_of_label,
                            const int* num_merged, int Z, int Y, int X,
                            int L, void* scratch, int* counts, int* rows,
                            cudaStream_t stream) {
  using namespace fusion::grp;
  const Layout s = layout(Z, Y, X, L);
  auto* base = static_cast<unsigned char*>(scratch);
  Args a;
  a.labels = labels;
  a.merged_map = merged_map;
  a.merged_of_label = merged_of_label;
  a.num_merged = num_merged;
  a.counts = counts;
  a.rows = rows;
  a.descs = reinterpret_cast<unsigned long long*>(base + s.descs);
  a.tile_counter = reinterpret_cast<int*>(base + s.counter);
  a.first_inv = reinterpret_cast<unsigned*>(base + s.first);
  a.hist = reinterpret_cast<int*>(base + s.hist);
  a.pairs[0] = reinterpret_cast<int2*>(base + s.pairs0);
  a.pairs[1] = reinterpret_cast<int2*>(base + s.pairs1);
  a.Z = Z;
  a.Y = Y;
  a.X = X;
  a.L = L;
  a.passes = radix_passes(Z, L);
  cudaError_t err = cudaMemsetAsync(scratch, 0, s.zeroed, stream);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)Z * Y * X;
  const int ctiles = (int)((n + kCompactTile - 1) / kCompactTile);
  compact_kernel<<<ctiles, kThreads, 0, stream>>>(a, ctiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long stiles = (n + kSortTile - 1) / kSortTile;
  const int blocks = (int)(stiles < kMaxBlocks ? stiles : kMaxBlocks);
  for (int p = 0; p < a.passes; ++p) {
    hist_kernel<<<blocks, kThreads, 0, stream>>>(a, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scan_kernel<<<1, kScanThreads, 0, stream>>>(a, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    scatter_kernel<<<blocks, kThreads, 0, stream>>>(a, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  finish_kernel<<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
