// Fused raster front: unproject -> world and crop transform -> crop test
// -> clamped cell -> cell-relative 10/10/12-bit quantization -> level-1
// run-length reduction, in one kernel from masked metric depth.
//
// Replaces: ros_gpu_depthmap_fusion_tpu/ops/pallas/fused_unproject_rle.py
// :128 unproject_voxelize_l1 (_kernel at :50, pallas_call at :182). Same
// contract: rows are padded to Wp = ceil(W / 128) * 128 columns, so stream
// position p = (cam * H + row) * Wp + col; padding columns are invalid; a
// run starts at a valid position whose key differs from position p-1's,
// or where force_break divides p (with Wp % 128 == 0 and force_break =
// 128: every row start and every 128th column). Outputs: out_keys and
// out_sums (qx, qy, qz, count) per run, counts = {min(runs, capacity),
// runs, valid points}.
//
// Float order, op for op as the JAX kernel writes it (:69-103), built with
// --fmad=false and IEEE division so that no multiply-add is contracted:
//   x = (col - cx) / fx * d, y likewise;
//   each transform row ((a*x + b*y) + c*d) + t;
//   g = floor(clip((w - lo) / cs, 0, gs - 1)); cell = (gx + gy*gs0) +
//   gz*(gs0*gs1) (exact below 2^24);
//   q = clip(floor((w - (lo + g*cs)) / cs * 1024), 0, 1023), 4096 / 4095
//   for z.
//
// Design: one launch of the single-pass reduce-by-key of reduce_by_key.cuh
// (after one memset of its look-back scratch and the counts) over a source
// that computes each position's key and values in registers from the depth
// image; the padded image is never materialized (index arithmetic gives the
// same positions). The front is computed once a position: when a block asks
// for a tile position's key the source also packs its 10 + 10 + 12-bit
// values into one word of a shared array of the tile, and unpacks them when
// the block comes back for the values. Every run's row is written once with
// plain stores; with force_break = 128 (which divides the 2,048-position
// tile) no run crosses a tile and the carry look-back is skipped. Each tile
// adds its valid positions to counts[2] with one integer atomic. The
// per-camera parameters ([C, 32]: fx fy cx cy, world rows 0-2, crop rows
// 0-2, padding, as the JAX kernel's SMEM table) and the grid and crop
// constants go to shared memory once per block.
//
// Bound on the card: memory, the depth read (13 MB at 8 x 480 x 848) and
// the capacity-wide rows written (9 MB at 448k). It is held above that by
// the front's instructions (8 IEEE divisions a valid position at ~10
// instructions each, and a warp runs the whole front when any of its lanes
// is valid) on top of what holds segreduce: per-tile latency and the count
// look-back. PERF.md has the measured times.
#include "reduce_by_key.cuh"

namespace fusion {

constexpr int kCamParams = 32;
constexpr int kGridConsts = 32;
// grid and crop constants: lower[3] cell[3] grid_size-1[3] gs0 gs0*gs1
// crop_lo[3] crop_hi[3]
enum { kLo = 0, kCs = 3, kGsm1 = 6, kGs0 = 9, kGs01 = 10, kCropLo = 11,
       kCropHi = 14 };

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 as a multiply and a shift
// (Granlund and Montgomery's round-up multiplier: with l = ceil(log2 d),
// m = floor(2^(31 + l) / d) + 1 < 2^32 and n / d = (n * m) >> (31 + l)),
// in place of the ~20 instructions of an integer division a position.
struct FastDiv {
  unsigned m;
  int shift;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)(((unsigned long long)(unsigned)n * m) >> shift);
  }
};
static inline FastDiv fast_div(int d) {
  int l = 0;
  while ((1LL << l) < d) ++l;
  return FastDiv{(unsigned)((1ULL << (31 + l)) / (unsigned)d + 1), 31 + l};
}

struct FrontSource {
  const float* depth;   // [C, H, W] metres, 0 = invalid
  const float* cam;     // shared [C, kCamParams]
  const float* g;       // shared [kGridConsts]
  unsigned* packed;     // shared [rbk::kTile]: the tile's qx | qy | qz
  int tile_base;        // the tile's first stream position
  int h, w, wp, sentinel;
  FastDiv by_wp, by_h;

  // The block also asks for the keys just before and after its tile:
  // only the tile's own positions have a slot.
  __device__ __forceinline__ int key(int i) const {
    const int row_g = by_wp(i);        // cam * H + row
    const int col = i - row_g * wp;
    if (col >= w) return sentinel;
    const float d = depth[(size_t)row_g * w + col];
    if (!(d > 0.0f)) return sentinel;
    const int cm = by_h(row_g);
    const int row = row_g - cm * h;
    const float* p = cam + cm * kCamParams;
    const float x = ((float)col - p[2]) / p[0] * d;
    const float y = ((float)row - p[3]) / p[1] * d;
    const float px = ((p[16] * x + p[17] * y) + p[18] * d) + p[19];
    const float py = ((p[20] * x + p[21] * y) + p[22] * d) + p[23];
    const float pz = ((p[24] * x + p[25] * y) + p[26] * d) + p[27];
    const bool inside = px >= g[kCropLo] && px <= g[kCropHi]
        && py >= g[kCropLo + 1] && py <= g[kCropHi + 1]
        && pz >= g[kCropLo + 2] && pz <= g[kCropHi + 2];
    if (!inside) return sentinel;
    const float wx = ((p[4] * x + p[5] * y) + p[6] * d) + p[7];
    const float wy = ((p[8] * x + p[9] * y) + p[10] * d) + p[11];
    const float wz = ((p[12] * x + p[13] * y) + p[14] * d) + p[15];
    const float gx = floorf(fminf(fmaxf((wx - g[kLo]) / g[kCs], 0.0f),
                                  g[kGsm1]));
    const float gy = floorf(fminf(fmaxf((wy - g[kLo + 1]) / g[kCs + 1],
                                        0.0f), g[kGsm1 + 1]));
    const float gz = floorf(fminf(fmaxf((wz - g[kLo + 2]) / g[kCs + 2],
                                        0.0f), g[kGsm1 + 2]));
    const float qx = fminf(fmaxf(floorf((wx - (g[kLo] + gx * g[kCs]))
                                        / g[kCs] * 1024.0f), 0.0f), 1023.0f);
    const float qy = fminf(fmaxf(floorf((wy - (g[kLo + 1] + gy * g[kCs + 1]))
                                        / g[kCs + 1] * 1024.0f), 0.0f),
                           1023.0f);
    const float qz = fminf(fmaxf(floorf((wz - (g[kLo + 2] + gz * g[kCs + 2]))
                                        / g[kCs + 2] * 4096.0f), 0.0f),
                           4095.0f);
    const unsigned slot = (unsigned)(i - tile_base);
    if (slot < (unsigned)rbk::kTile)
      packed[slot] = (unsigned)qx | (unsigned)qy << 10 | (unsigned)qz << 20;
    return (int)((gx + gy * g[kGs0]) + gz * g[kGs01]);
  }
  __device__ __forceinline__ void elem(int i, float* v) const {
    const unsigned q = packed[i - tile_base];
    v[0] = (float)(q & 1023u);
    v[1] = (float)((q >> 10) & 1023u);
    v[2] = (float)(q >> 20);
    v[3] = 1.0f;
  }
};

// The first 16 bytes of a call's scratch hold counts[3] (zeroed with the
// look-back descriptors by the one memset; counts[2] is the tiles' atomic
// sum), the scratch of reduce_by_key.cuh follows.
constexpr size_t kCountsBytes = 16;

// 3 blocks an SM (85 registers a thread): the front's transforms and
// quantization keep more values live than segreduce's array reads, which
// fit 4 blocks' 64 registers (there the front spills, for no gain).
static __global__ void __launch_bounds__(rbk::kThreads, 3)
fused_unproject_rle_kernel(const float* __restrict__ depth,
                           const float* __restrict__ params,
                           const float* __restrict__ consts, int c, int h,
                           int w, int wp, int n, int sentinel,
                           int force_break, int capacity, bool carry_mode,
                           int tiles, FastDiv by_wp, FastDiv by_h,
                           rbk::Scratch s,
                           int* __restrict__ out_keys,
                           float* __restrict__ out_sums,
                           int* __restrict__ counts) {
  extern __shared__ float tables[];   // [c, kCamParams] + [kGridConsts]
  __shared__ unsigned packed[rbk::kTile];
  const int np = c * kCamParams;
  for (int j = threadIdx.x; j < np + kGridConsts; j += blockDim.x)
    tables[j] = j < np ? params[j] : consts[j - np];
  const int t = rbk::claim_tile(s);   // its barrier also covers the tables
  const int tile_base = t < tiles ? t * rbk::kTile : 0;
  const FrontSource src{depth, tables, tables + np, packed, tile_base, h, w,
                        wp, sentinel, by_wp, by_h};
  rbk::reduce_by_key_block<4, true>(src, t, n, sentinel, force_break,
                                    capacity, carry_mode, tiles, s, out_keys,
                                    out_sums, counts, counts + 2);
}

}  // namespace fusion

// Bytes of scratch fusion_unproject_rle needs for a stream of n = c * h *
// wp positions.
extern "C" long long fusion_unproject_rle_scratch_bytes(int n) {
  using namespace fusion;
  return (long long)(kCountsBytes + rbk::scratch_bytes(rbk::num_tiles(n)));
}

// depth [c, h, w] float32; params [c, 32] and consts [32] float32 (layout
// above); the stream has n = c * h * wp <= 2^30 positions. scratch:
// fusion_unproject_rle_scratch_bytes(n) bytes, 16-byte aligned; on return
// its first three int32 are counts = {min(runs, capacity), runs, valid
// points}. out_keys [capacity] and out_sums [capacity, 4] (16-byte aligned)
// need no initialisation. Returns cudaGetLastError().
extern "C" int fusion_unproject_rle(const float* depth, const float* params,
                                    const float* consts, int c, int h, int w,
                                    int wp, int sentinel, int force_break,
                                    int capacity, void* scratch,
                                    int* out_keys, float* out_sums,
                                    cudaStream_t stream) {
  using namespace fusion;
  const long long n_ll = (long long)c * h * wp;
  const size_t dyn = (size_t)(c * kCamParams + kGridConsts) * sizeof(float);
  // static (the tile's keys and packed values) + dynamic (the tables)
  // shared memory must fit the 48 KB a kernel gets without opting in
  if (c < 1 || h < 1 || w < 1 || wp < w || capacity < 1
      || n_ll > (1LL << 30)
      || dyn + sizeof(rbk::Smem) + rbk::kTile * sizeof(unsigned) + 64
             > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int n = (int)n_ll;
  const int tiles = rbk::num_tiles(n);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, kCountsBytes + rbk::memset_bytes(tiles), stream);
  if (err != cudaSuccess) return (int)err;
  const bool carry_mode = !(force_break > 0
                            && rbk::kTile % force_break == 0);
  const int blocks = tiles + rbk::num_fill_blocks(capacity);
  fused_unproject_rle_kernel<<<blocks, rbk::kThreads, dyn, stream>>>(
      depth, params, consts, c, h, w, wp, n, sentinel, force_break, capacity,
      carry_mode, tiles, fast_div(wp), fast_div(h),
      rbk::scratch_at(static_cast<char*>(scratch) + kCountsBytes, tiles),
      out_keys, out_sums, static_cast<int*>(scratch));
  return (int)cudaGetLastError();
}
