// The mapping stage's device segmentation in eight launches: per-layer
// 8-connected components, their dense labels, the connections between
// adjacent layers, the cross-layer merge and the per-object voxel
// statistics, with no host round trip.
//
// No TPU counterpart: the JAX package's mapping/segmentation.py is plain
// XLA (iterated min-label propagation in a while_loop), and the port's
// plain twin, mapping/segmentation.py segment_plain, is that program op for
// op, with a host synchronisation a fixpoint step. Every output but the
// twin's iteration counts is bit-equal to the twin: a component's root is
// its smallest flat index in its layer (its first pixel in raster order),
// which the twin's min-propagation converges to; merged ids rank the merge
// roots (smallest global label id) in ascending order; sums are exact
// integers, and the centroid is one rounded conversion and one IEEE
// division, as the twin's.
//
// Design.
// 1. local: a block takes a 32 x 32 tile of one layer and unions its
//    occupied pixels with their earlier neighbours (W, NW, N, NE) in
//    shared memory, linking a root to the smaller index by atomicMin
//    (Playne and Hawick's union), then writes each pixel's tile root as a
//    flat index of the layer. It also zeroes the connection bitmap.
// 2. border: a block takes one tile's top row and outer columns and unions
//    them, in global memory, with the neighbours that lie in other tiles.
//    Every link points to a smaller index, so a root is its component's
//    smallest index.
// 3. rows: a warp a row finds each pixel's root (and stores it, so that
//    every pixel points at its root), and numbers the row's roots in raster
//    order; a root stores -(its rank in the row + 1).
// 4. row scan: a block a layer scans the row counts into row offsets and
//    writes num_labels.
// 5. labels: a thread a column of 32 x 8 columns x layers: label = row
//    offset + rank + 1, clamped at max_labels - 1; each warp then records
//    the label pairs it sees between layer z-1 and z in a bitmap of
//    [Z-1, L, L] bits, once a distinct pair a warp (match_any), and only
//    the pairs the merge may join (both background or both objects).
// 6. merge: one block holds the Z x L label table in shared memory, unions
//    every recorded pair, ranks the roots in ascending order and writes
//    merged_of_label and num_merged; it also resets the statistics'
//    accumulators.
// 7. stats: each block takes a contiguous run of voxels, writes merged_map,
//    and accumulates count, int64 coordinate sums and minimum and maximum
//    in block-private shared slots: a warp whose occupied voxels share an
//    object adds its sums with one redux a quantity, so the contended
//    slot takes one atomic a warp. Each block then adds its touched slots
//    to the global accumulators.
// 8. finish: centroid = float(sum) / float(max(count, 1)); vmin and vmax of
//    slots that saw no voxel read 0 and -1.
//
// Bound on the card: bytes. At the node's 21 x 400 x 400 grid with 256
// labels a layer and 64 objects the stage must read the 3.36 MB occupancy
// and write 13.4 MB of labels and 13.4 MB of merged ids: ~9 us at
// 3.35 TB/s. The chain moves about 3x that (the root table written and
// read twice, labels read back by the stats), and union-find is irregular;
// nothing here waits on the host, and no atomic but the per-block flush
// goes to device memory.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace fusion {
namespace seg {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;              // local / border tiles: 32 x 32
constexpr int kBorder = 3 * kTile - 2; // top row, left and right columns
constexpr int kRowThreads = 256;       // rows: 8 warps, one row each
constexpr int kScanThreads = 1024;     // row scan and merge
constexpr int kLabelZ = 8;             // labels: 32 columns x 8 layers
constexpr int kStatsThreads = 256;
constexpr int kStatsChunk = 4096;      // voxels a stats block, at least
constexpr int kStatsBlocks = 1024;     // at most
// a stats slot: count, 3 sums, 3 min, 3 max
constexpr int kSlotBytes = 3 * sizeof(unsigned long long) + 7 * sizeof(int);

struct Args {
  const uint8_t* occ;      // [Z, Y, X], nonzero = occupied
  int* labels;             // [Z, Y, X]
  int* num_labels;         // [Z]
  int* merged_of_label;    // [Z, L]
  int* num_merged;         // [1]
  int* merged_map;         // [Z, Y, X]
  int* voxel_count;        // [M]
  float* centroid;         // [M, 3]
  int* vmin;               // [M, 3]
  int* vmax;               // [M, 3]
  // scratch
  int* parent;             // [Z, Y * X]
  int* rows;               // [Z, Y]
  unsigned* conn;          // [max(Z - 1, 1), L, ceil(L / 32)]
  unsigned long long* acc_sum;  // [M, 3]
  int* acc_int;            // [M, 7]: count, min x y z, max x y z
  int Z, Y, X, L, M;
};

extern __shared__ __align__(16) unsigned char dyn_smem[];

// The root of x: follow parents to a node that is its own parent (or,
// after the rows kernel, holds its negative rank). Volatile reads: other
// threads lower parents meanwhile, and an older parent is still an
// ancestor.
__device__ __forceinline__ int find_root(const volatile int* par, int x) {
  while (true) {
    const int v = par[x];
    if (v < 0 || v == x) return x;
    x = v;
  }
}

// Join the trees of a and b: the larger root is linked to the smaller by
// atomicMin; a root that was linked meanwhile is followed and tried again
// (Playne and Hawick, "A new algorithm for parallel connected-component
// labelling on GPUs", 2018). Every parent stays at most its node's index.
__device__ void unite(int* par, int a, int b) {
  while (true) {
    a = find_root(par, a);
    b = find_root(par, b);
    if (a == b) return;
    if (a < b) {
      const int old = atomicMin(par + b, a);
      if (old == b) return;
      b = old;
    } else {
      const int old = atomicMin(par + a, b);
      if (old == a) return;
      a = old;
    }
  }
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Inclusive scan of one int a thread over a 1-D block of kScanThreads;
// *total is the block's sum. Every thread must call it.
__device__ int block_incl_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x = warp_incl_scan(v);
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) s_warp[lane] = warp_incl_scan(s_warp[lane]);
  __syncthreads();
  const int out = x + (w ? s_warp[w - 1] : 0);
  *total = s_warp[kScanThreads / 32 - 1];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kTile * kTile) local_kernel(Args a) {
  __shared__ int s[kTile * kTile];
  const int lx = threadIdx.x, ly = threadIdx.y, li = ly * kTile + lx;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int x = x0 + lx, y = y0 + ly;
  const int n = a.Y * a.X;
  const bool in = x < a.X && y < a.Y;
  const size_t g = (size_t)blockIdx.z * n + (size_t)y * a.X + x;
  const bool o = in && a.occ[g] != 0;
  s[li] = o ? li : -1;      // an unoccupied slot stays -1
  __syncthreads();
  if (o) {
    if (lx > 0 && s[li - 1] >= 0) unite(s, li, li - 1);
    if (ly > 0) {
      if (lx > 0 && s[li - kTile - 1] >= 0) unite(s, li, li - kTile - 1);
      if (s[li - kTile] >= 0) unite(s, li, li - kTile);
      if (lx < kTile - 1 && s[li - kTile + 1] >= 0)
        unite(s, li, li - kTile + 1);
    }
  }
  __syncthreads();
  if (in) {
    int r = -1;
    if (o) {
      const int lr = find_root(s, li);
      r = (y0 + lr / kTile) * a.X + x0 + lr % kTile;
    }
    a.parent[g] = r;
  }
  // zero the connection bitmap for the labels kernel
  const size_t words = (size_t)max(a.Z - 1, 1) * a.L * ((a.L + 31) / 32);
  const size_t threads = (size_t)gridDim.x * gridDim.y * gridDim.z
                         * (kTile * kTile);
  const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y)
                       * gridDim.x + blockIdx.x;
  for (size_t w = block * (kTile * kTile) + li; w < words; w += threads)
    a.conn[w] = 0u;
}

__global__ void __launch_bounds__(kBorder + 2) border_kernel(Args a) {
  const int t = threadIdx.x;
  if (t >= kBorder) return;
  // t < 32: top row; then the left column, then the right, below row 0
  const int lx = t < kTile ? t : (t < 2 * kTile - 1 ? 0 : kTile - 1);
  const int ly = t < kTile ? 0 : (t < 2 * kTile - 1 ? t - kTile + 1
                                                    : t - 2 * kTile + 2);
  const int tx = blockIdx.x, ty = blockIdx.y;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  if (x >= a.X || y >= a.Y) return;
  const int n = a.Y * a.X;
  const uint8_t* occ = a.occ + (size_t)blockIdx.z * n;
  const int p = y * a.X + x;
  if (!occ[p]) return;
  int* par = a.parent + (size_t)blockIdx.z * n;
  const int dx[4] = {-1, -1, 0, 1}, dy[4] = {0, -1, -1, -1};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int qx = x + dx[k], qy = y + dy[k];
    if (qx < 0 || qx >= a.X || qy < 0) continue;
    if (qx / kTile == tx && qy / kTile == ty) continue;  // united locally
    const int q = qy * a.X + qx;
    if (occ[q]) unite(par, p, q);
  }
}

__global__ void __launch_bounds__(kRowThreads) rows_kernel(Args a) {
  const long long row =
      ((long long)blockIdx.x * kRowThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.Z * a.Y) return;  // whole warps
  const int z = (int)(row / a.Y), y = (int)(row - (long long)z * a.Y);
  const size_t base = (size_t)z * a.Y * a.X;
  int* par = a.parent + base;
  const uint8_t* occ = a.occ + base;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;
  for (int x0 = 0; x0 < a.X; x0 += 32) {
    const int x = x0 + lane, c = x < a.X ? y * a.X + x : -2;
    int r = -1;
    if (c >= 0 && occ[c]) r = find_root(par, c);
    const bool root = r == c;
    const unsigned m = __ballot_sync(kFull, root);
    if (root)
      par[c] = -(count + __popc(m & below) + 1);
    else if (r >= 0)
      par[c] = r;
    count += __popc(m);
  }
  if (lane == 0) a.rows[row] = count;
}

__global__ void __launch_bounds__(kScanThreads) row_scan_kernel(Args a) {
  __shared__ int s_warp[32];
  int* rows = a.rows + (size_t)blockIdx.x * a.Y;
  int carry = 0;
  for (int y0 = 0; y0 < a.Y; y0 += kScanThreads) {
    const int y = y0 + threadIdx.x;
    const int v = y < a.Y ? rows[y] : 0;
    int total;
    const int incl = block_incl_scan(v, s_warp, &total);
    if (y < a.Y) rows[y] = carry + incl - v;
    carry += total;
  }
  if (threadIdx.x == 0) a.num_labels[blockIdx.x] = min(carry + 1, a.L);
}

__global__ void __launch_bounds__(32 * kLabelZ) labels_kernel(Args a) {
  __shared__ int lab[kLabelZ + 1][32];  // row 0: the previous chunk's last
  const int lane = threadIdx.x, zy = threadIdx.y;
  const int n = a.Y * a.X;
  const int c = blockIdx.x * 32 + lane;
  const bool col = c < n;
  const int words = (a.L + 31) / 32;
  for (int z0 = 0; z0 < a.Z; z0 += kLabelZ) {
    const int z = z0 + zy;
    int l = 0;
    if (col && z < a.Z) {
      const size_t g = (size_t)z * n + c;
      if (a.occ[g]) {
        const int* par = a.parent + (size_t)z * n;
        int r = c, v = par[c];
        if (v >= 0) {           // every pixel points at its root
          r = v;
          v = par[r];
        }
        l = min(a.rows[(size_t)z * a.Y + r / a.X] - v, a.L - 1);
      }
      a.labels[g] = l;
    }
    lab[zy + 1][lane] = l;
    __syncthreads();
    if (z >= 1 && z < a.Z) {    // warp-uniform: a warp is one layer
      const int prev = lab[zy][lane];
      const bool ok = col && ((prev == 0) == (l == 0));
      // distinct for L <= 65535, and never the sentinel
      const unsigned key = ok ? (unsigned)prev * a.L + l : 0xffffffffu;
      const unsigned grp = __match_any_sync(kFull, key);
      if (ok && lane == __ffs(grp) - 1) {
        unsigned* w = a.conn + ((size_t)(z - 1) * a.L + prev) * words
                      + (l >> 5);
        const unsigned bit = 1u << (l & 31);
        if (!(*w & bit)) atomicOr(w, bit);
      }
    }
    __syncthreads();
    if (zy == 0) lab[0][lane] = lab[kLabelZ][lane];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kScanThreads) merge_kernel(Args a) {
  int* tab = reinterpret_cast<int*>(dyn_smem);
  __shared__ int s_warp[32];
  const int t_n = a.Z * a.L;
  for (int t = threadIdx.x; t < t_n; t += kScanThreads) tab[t] = t;
  for (int i = threadIdx.x; i < a.M; i += kScanThreads) {
    int* s = a.acc_int + 7 * i;
    s[0] = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.acc_sum[3 * i + k] = 0ull;
      s[1 + k] = INT_MAX;
      s[4 + k] = INT_MIN;
    }
  }
  __syncthreads();
  const int words = (a.L + 31) / 32;
  const size_t n_words = (size_t)(a.Z - 1) * a.L * words;
  for (size_t w = threadIdx.x; w < n_words; w += kScanThreads) {
    unsigned bits = a.conn[w];
    if (!bits) continue;
    const size_t row = w / words;               // (z, label in z)
    const int hi = (int)(w - row * words) * 32;
    const int src = (int)row;                   // z * L + label
    const int dst_layer = (int)(row / a.L) + 1;
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1u;
      unite(tab, src, dst_layer * a.L + hi + b);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < t_n; t += kScanThreads)
    tab[t] = find_root(tab, t);
  __syncthreads();
  // rank the valid roots in ascending order; a root keeps -(rank + 1)
  int carry = 0;
  for (int t0 = 0; t0 < t_n; t0 += kScanThreads) {
    const int t = t0 + threadIdx.x;
    bool root = false;
    if (t < t_n) {
      const int z = t / a.L;
      root = t - z * a.L < a.num_labels[z] && tab[t] == t;
    }
    int total;
    const int incl = block_incl_scan(root ? 1 : 0, s_warp, &total);
    if (root) tab[t] = -(carry + incl);
    carry += total;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < t_n; t += kScanThreads) {
    const int z = t / a.L;
    int m = 0;
    if (t - z * a.L < a.num_labels[z]) {
      const int v = tab[t];
      m = (v < 0 ? -v : -tab[v]) - 1;
    }
    a.merged_of_label[t] = m;
  }
  if (threadIdx.x == 0) *a.num_merged = carry;
}

__global__ void __launch_bounds__(kStatsThreads) stats_kernel(Args a,
                                                              int chunk) {
  const int m_n = a.M;
  unsigned long long* s_sum = reinterpret_cast<unsigned long long*>(dyn_smem);
  int* s_cnt = reinterpret_cast<int*>(s_sum + 3 * m_n);
  int* s_min = s_cnt + m_n;
  int* s_max = s_min + 3 * m_n;
  for (int i = threadIdx.x; i < m_n; i += kStatsThreads) {
    s_cnt[i] = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_sum[3 * i + k] = 0ull;
      s_min[3 * i + k] = INT_MAX;
      s_max[3 * i + k] = INT_MIN;
    }
  }
  __syncthreads();
  const int n = a.Y * a.X;
  const int total = a.Z * n;
  const int begin = blockIdx.x * chunk;
  const int end = min(begin + chunk, total);
  const int lane = threadIdx.x & 31;
  for (int g0 = begin; g0 < end; g0 += kStatsThreads) {
    const int g = g0 + threadIdx.x;
    bool o = false;
    int id = 0, c[3] = {0, 0, 0};
    if (g < end) {
      const int z = g / n, p = g - z * n;
      const int merged = __ldg(a.merged_of_label + z * a.L + a.labels[g]);
      a.merged_map[g] = merged;
      if (a.occ[g]) {
        o = true;
        id = min(merged, m_n - 1);
        c[1] = p / a.X;
        c[0] = p - c[1] * a.X;
        c[2] = z;
      }
    }
    const unsigned act = __ballot_sync(kFull, o);
    if (!act) continue;                          // warp-uniform
    const int lead = __ffs(act) - 1;
    const int id0 = __shfl_sync(kFull, id, lead);
    if (__all_sync(kFull, !o || id == id0)) {
      // one object in the warp: reduce in registers, one atomic a slot
      // (coordinates are below 2^27, so 32 of them sum below 2^32)
      unsigned sum[3];
      int mn[3], mx[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sum[k] = __reduce_add_sync(kFull, o ? (unsigned)c[k] : 0u);
        mn[k] = __reduce_min_sync(kFull, o ? c[k] : INT_MAX);
        mx[k] = __reduce_max_sync(kFull, o ? c[k] : INT_MIN);
      }
      if (lane == lead) {
        atomicAdd(s_cnt + id0, __popc(act));
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          atomicAdd(s_sum + 3 * id0 + k, (unsigned long long)sum[k]);
          atomicMin(s_min + 3 * id0 + k, mn[k]);
          atomicMax(s_max + 3 * id0 + k, mx[k]);
        }
      }
    } else if (o) {
      atomicAdd(s_cnt + id, 1);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        atomicAdd(s_sum + 3 * id + k, (unsigned long long)c[k]);
        atomicMin(s_min + 3 * id + k, c[k]);
        atomicMax(s_max + 3 * id + k, c[k]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m_n; i += kStatsThreads) {
    if (!s_cnt[i]) continue;
    int* d = a.acc_int + 7 * i;
    atomicAdd(d, s_cnt[i]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      atomicAdd(a.acc_sum + 3 * i + k, s_sum[3 * i + k]);
      atomicMin(d + 1 + k, s_min[3 * i + k]);
      atomicMax(d + 4 + k, s_max[3 * i + k]);
    }
  }
}

__global__ void __launch_bounds__(kStatsThreads) finish_kernel(Args a) {
  for (int i = threadIdx.x; i < a.M; i += kStatsThreads) {
    const int* s = a.acc_int + 7 * i;
    const int count = s[0];
    a.voxel_count[i] = count;
    const float den = __int2float_rn(max(count, 1));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.centroid[3 * i + k] = __fdiv_rn(
          __ll2float_rn((long long)a.acc_sum[3 * i + k]), den);
      a.vmin[3 * i + k] = count > 0 ? s[1 + k] : 0;
      a.vmax[3 * i + k] = count > 0 ? s[4 + k] : -1;
    }
  }
}

cudaError_t launch_dyn(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace seg
}  // namespace fusion

// args: every pointer a device pointer on one card, laid out as in Args;
// outputs and scratch need no initialisation. The caller checks the
// extents (mapping/segmentation.py check_chain_input); a table or slots
// past the device's shared memory fail in cudaFuncSetAttribute. Launches
// eight kernels on stream and returns the first launch error, or
// cudaGetLastError().
extern "C" int fusion_segment(const fusion::seg::Args* args,
                              cudaStream_t stream) {
  using namespace fusion::seg;
  const Args& a = *args;
  const long long n = (long long)a.Y * a.X;
  const long long total = n * a.Z;
  const long long table = (long long)a.Z * a.L;
  const dim3 tiles((a.X + kTile - 1) / kTile, (a.Y + kTile - 1) / kTile,
                   a.Z);
  local_kernel<<<tiles, dim3(kTile, kTile), 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  border_kernel<<<tiles, kBorder + 2, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long rows = (long long)a.Z * a.Y;
  rows_kernel<<<(unsigned)((rows * 32 + kRowThreads - 1) / kRowThreads),
                kRowThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  row_scan_kernel<<<a.Z, kScanThreads, 0, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  labels_kernel<<<(unsigned)((n + 31) / 32), dim3(32, kLabelZ), 0,
                  stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int merge_bytes = (int)table * 4;
  if ((err = launch_dyn((const void*)merge_kernel, merge_bytes))
      != cudaSuccess)
    return (int)err;
  merge_kernel<<<1, kScanThreads, merge_bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int stats_bytes = a.M * kSlotBytes;
  if ((err = launch_dyn((const void*)stats_kernel, stats_bytes))
      != cudaSuccess)
    return (int)err;
  long long blocks = (total + kStatsChunk - 1) / kStatsChunk;
  if (blocks > kStatsBlocks) blocks = kStatsBlocks;
  long long chunk = (total + blocks - 1) / blocks;
  chunk = (chunk + kStatsThreads - 1) / kStatsThreads * kStatsThreads;
  blocks = (total + chunk - 1) / chunk;
  stats_kernel<<<(unsigned)blocks, kStatsThreads, stats_bytes, stream>>>(
      a, (int)chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  finish_kernel<<<1, kStatsThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
