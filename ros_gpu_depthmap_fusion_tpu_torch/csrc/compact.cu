// Stable stream compaction of flagged rows of 32-bit words into a static
// capacity, plus the clamped and the true count.
//
// Replaces: ros_gpu_depthmap_fusion_tpu/ops/pallas/compact.py:268
// compact_rows_pallas (_compact_pallas at :227, pallas_call at :243, body
// _kernel at :192; the slab emitter _emit_slabs :75 and the lane scan
// _prefix_incl :64 are shared there with the segreduce kernel, as
// lookback.cuh is shared here). Rows travel as raw 32-bit words, so int32
// payloads of any magnitude and float32 payloads move bit for bit.
//
// Design: one launch (after a memset of the look-back descriptors) of a
// single-pass scan with decoupled look-back (lookback.cuh). A tile of 1,024
// flags per block of 8 warps; warp w reads 4 rows of 32 flags (coalesced
// bytes), ballots them and counts; the block scans the warp counts and warp
// 0 looks back for the tile's first output row. Then each warp lists its
// flagged positions in shared memory and copies their k rows of d words
// together: the k * d output words are contiguous, so lane l moves words
// l, l + 32, ... (coalesced stores; the loads of a row's words are
// adjacent, and the loop's loads are independent, so several are in
// flight). Blocks past the last tile wait for the total and zero only
// the rows in [count, capacity); the last tile writes the counts.
//
// Bound on the card: memory, and at the main path's size the latency of
// one launch. It must read the flags and the flagged rows and write the
// capacity rows: at 26,250 blocks x 5 words -> 4,096 that is ~0.17 MB,
// 0.05 us at 3.35 TB/s, far below one launch's latency.
#include "lookback.cuh"

namespace fusion {
namespace cmp {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;
constexpr int kChunk = kRows * 32;
constexpr int kTile = kWarps * kChunk;   // flags per tile (1024)
constexpr int kFillRows = 2048;          // output rows per fill block

static inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }
// scratch: desc[tiles] (lookback.cuh), then the tile counter; all zeroed
static inline size_t scratch_bytes(int tiles) {
  return (size_t)tiles * 8 + 4;
}

static __global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ words,
               const uint8_t* __restrict__ flags, int n, int d, int capacity,
               int tiles, unsigned long long* __restrict__ descs,
               int* __restrict__ counter, int* __restrict__ counts,
               int* __restrict__ out) {
  __shared__ int s_tile, s_base;
  __shared__ int s_count[kWarps], s_excl[kWarps];
  __shared__ int s_rows[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int t = s_tile;

  if (t >= tiles) {  // ---- zero the rows past the count
    if (threadIdx.x == 0) {
      s_base = tiles > 0 ? lb::wait_inclusive(descs, tiles - 1) : 0;
      if (tiles == 0 && t == 0) {
        counts[0] = 0;
        counts[1] = 0;
      }
    }
    __syncthreads();
    const int f = t - tiles;
    const size_t lo = (size_t)max(s_base, f * kFillRows) * d;
    const size_t hi = (size_t)min(capacity, (f + 1) * kFillRows) * d;
    for (size_t q = lo + threadIdx.x; q < hi; q += kThreads) out[q] = 0;
    return;
  }

  // ---- stage 1: flags, counts, look-back
  const int base = t * kTile + w * kChunk;
  unsigned m[kRows];
  int count = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = base + r * 32 + lane;
    m[r] = __ballot_sync(lb::kFull, i < n && flags[i] != 0);
    count += __popc(m[r]);
  }
  if (lane == 0) s_count[w] = count;
  __syncthreads();
  if (w == 0) {
    const int c = lane < kWarps ? s_count[lane] : 0;
    const int incl = lb::warp_incl_scan(c);
    if (lane < kWarps) s_excl[lane] = incl - c;
    const int total = __shfl_sync(lb::kFull, incl, kWarps - 1);
    const int first = lb::publish_and_look_back(descs, t, total);
    if (lane == 0) {
      s_base = first;
      if (t == tiles - 1) {
        const int all = first + total;
        counts[0] = all < capacity ? all : capacity;
        counts[1] = all;
      }
    }
  }
  __syncthreads();

  // ---- stage 2: list the warp's flagged rows, then move all their words
  const int first = s_base + s_excl[w];
  const unsigned lt = (1u << lane) - 1u;
  int k = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if ((m[r] >> lane) & 1u)
      s_rows[w][k + __popc(m[r] & lt)] = base + r * 32 + lane;
    k += __popc(m[r]);
  }
  __syncwarp();
  const int rows = min(k, capacity - first);
#pragma unroll 4
  for (int q = lane; q < rows * d; q += 32) {
    const int j = q / d;
    const int c = q - j * d;
    out[(size_t)(first + j) * d + c] = words[(size_t)s_rows[w][j] * d + c];
  }
}

}  // namespace cmp
}  // namespace fusion

// Bytes of scratch fusion_compact needs for n rows.
extern "C" long long fusion_compact_scratch_bytes(int n) {
  return (long long)fusion::cmp::scratch_bytes(fusion::cmp::num_tiles(n));
}

// words [n, d] int32 row-major; flags [n] uint8 (0/1); scratch of
// fusion_compact_scratch_bytes(n) bytes, 8-byte aligned; counts [2]; out
// [capacity, d] needs no initialisation. Returns cudaGetLastError().
extern "C" int fusion_compact(const int* words, const uint8_t* flags, int n,
                              int d, int capacity, void* scratch, int* counts,
                              int* out, cudaStream_t stream) {
  using namespace fusion::cmp;
  if (d < 1 || capacity < 1 || n < 0 || n > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int tiles = num_tiles(n);
  cudaError_t err = cudaMemsetAsync(scratch, 0, scratch_bytes(tiles), stream);
  if (err != cudaSuccess) return (int)err;
  auto* descs = static_cast<unsigned long long*>(scratch);
  auto* counter = reinterpret_cast<int*>(descs + tiles);
  const int blocks = tiles + (capacity + kFillRows - 1) / kFillRows;
  compact_kernel<<<blocks, kThreads, 0, stream>>>(
      words, flags, n, d, capacity, tiles, descs, counter, counts, out);
  return (int)cudaGetLastError();
}

extern "C" const char* fusion_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
