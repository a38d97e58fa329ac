// Fused raster front: unproject -> world and crop transform -> crop test
// -> clamped cell -> cell-relative 10/10/12-bit quantization -> level-1
// run-length reduction, in one kernel pair from masked metric depth.
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
// Design (simple first): the two passes of runs.cuh with a source that
// computes each position's key and values in registers from the depth
// image; the padded image is never materialized (index arithmetic gives
// the same positions), and a thread recomputes its left neighbour's key.
// The per-camera parameters ([C, 32]: fx fy cx cy, world rows 0-2, crop
// rows 0-2, padding, as the JAX kernel's SMEM table) and the grid and crop
// constants go to shared memory once per block. The front is computed three
// times per position (the count pass, and the emit pass's start count and
// values); its ~60 flops are cheap beside the atomics.
//
// Bound on the card: the emit pass's atomics and the depth read (13 MB at
// 8 x 480 x 848); a single pass with decoupled look-back and keys cached
// in registers is left for later.
#include "runs.cuh"

namespace fusion {

constexpr int kCamParams = 32;
constexpr int kGridConsts = 32;
// grid and crop constants: lower[3] cell[3] grid_size-1[3] gs0 gs0*gs1
// crop_lo[3] crop_hi[3]
enum { kLo = 0, kCs = 3, kGsm1 = 6, kGs0 = 9, kGs01 = 10, kCropLo = 11,
       kCropHi = 14 };

struct FrontSource {
  const float* depth;   // [C, H, W] metres, 0 = invalid
  const float* cam;     // shared [C, kCamParams]
  const float* g;       // shared [kGridConsts]
  int h, w, wp, sentinel;

  template <bool kVals>
  __device__ __forceinline__ int front(int i, float* v) const {
    const int row_g = i / wp;          // cam * H + row
    const int col = i - row_g * wp;
    if (col >= w) return sentinel;
    const int cm = row_g / h;
    const int row = row_g - cm * h;
    const float d = depth[(size_t)row_g * w + col];
    const float* p = cam + cm * kCamParams;
    const float x = ((float)col - p[2]) / p[0] * d;
    const float y = ((float)row - p[3]) / p[1] * d;
    const float px = ((p[16] * x + p[17] * y) + p[18] * d) + p[19];
    const float py = ((p[20] * x + p[21] * y) + p[22] * d) + p[23];
    const float pz = ((p[24] * x + p[25] * y) + p[26] * d) + p[27];
    const bool inside = px >= g[kCropLo] && px <= g[kCropHi]
        && py >= g[kCropLo + 1] && py <= g[kCropHi + 1]
        && pz >= g[kCropLo + 2] && pz <= g[kCropHi + 2];
    if (!(d > 0.0f && inside)) return sentinel;
    const float wx = ((p[4] * x + p[5] * y) + p[6] * d) + p[7];
    const float wy = ((p[8] * x + p[9] * y) + p[10] * d) + p[11];
    const float wz = ((p[12] * x + p[13] * y) + p[14] * d) + p[15];
    const float gx = floorf(fminf(fmaxf((wx - g[kLo]) / g[kCs], 0.0f),
                                  g[kGsm1]));
    const float gy = floorf(fminf(fmaxf((wy - g[kLo + 1]) / g[kCs + 1],
                                        0.0f), g[kGsm1 + 1]));
    const float gz = floorf(fminf(fmaxf((wz - g[kLo + 2]) / g[kCs + 2],
                                        0.0f), g[kGsm1 + 2]));
    if (kVals) {
      v[0] = fminf(fmaxf(floorf((wx - (g[kLo] + gx * g[kCs])) / g[kCs]
                                * 1024.0f), 0.0f), 1023.0f);
      v[1] = fminf(fmaxf(floorf((wy - (g[kLo + 1] + gy * g[kCs + 1]))
                                / g[kCs + 1] * 1024.0f), 0.0f), 1023.0f);
      v[2] = fminf(fmaxf(floorf((wz - (g[kLo + 2] + gz * g[kCs + 2]))
                                / g[kCs + 2] * 4096.0f), 0.0f), 4095.0f);
      v[3] = 1.0f;
    }
    return (int)((gx + gy * g[kGs0]) + gz * g[kGs01]);
  }
  __device__ __forceinline__ int key(int i) const {
    return front<false>(i, nullptr);
  }
  __device__ __forceinline__ int elem(int i, float* v) const {
    return front<true>(i, v);
  }
};

__device__ __forceinline__ FrontSource load_front(
    float* smem, const float* depth, const float* params,
    const float* consts, int c, int h, int w, int wp, int sentinel) {
  const int np = c * kCamParams;
  for (int j = threadIdx.x; j < np + kGridConsts; j += blockDim.x)
    smem[j] = j < np ? params[j] : consts[j - np];
  __syncthreads();
  return FrontSource{depth, smem, smem + np, h, w, wp, sentinel};
}

static __global__ void __launch_bounds__(kThreads)
fused_count_kernel(const float* __restrict__ depth,
                   const float* __restrict__ params,
                   const float* __restrict__ consts, int c, int h, int w,
                   int wp, int n, int sentinel, int force_break,
                   int* __restrict__ tile_counts, int* __restrict__ valid) {
  extern __shared__ float smem[];
  const FrontSource src =
      load_front(smem, depth, params, consts, c, h, w, wp, sentinel);
  runs_count_tile(src, n, sentinel, force_break, tile_counts, valid);
}

static __global__ void __launch_bounds__(kThreads)
fused_emit_kernel(const float* __restrict__ depth,
                  const float* __restrict__ params,
                  const float* __restrict__ consts, int c, int h, int w,
                  int wp, int n, int sentinel, int force_break, int capacity,
                  const int* __restrict__ tile_offsets,
                  int* __restrict__ out_keys, float* __restrict__ out_sums) {
  extern __shared__ float smem[];
  const FrontSource src =
      load_front(smem, depth, params, consts, c, h, w, wp, sentinel);
  runs_emit_tile(src, n, 4, sentinel, force_break, capacity, tile_offsets,
                 out_keys, out_sums);
}

}  // namespace fusion

// Scratch size (int32 entries) of tile_counts / tile_offsets for a stream
// of n positions (the two-pass scan of scan.cuh).
extern "C" int fusion_scan_tiles(int n) { return fusion::num_tiles(n); }

// depth [c, h, w] float32; params [c, 32] and consts [32] float32 (layout
// above); the stream has n = c * h * wp positions. tile_counts and
// tile_offsets: scratch of fusion_scan_tiles(n) int32 each; counts [3]
// pre-filled with zeros; out_keys [capacity] pre-filled with the sentinel;
// out_sums [capacity, 4] pre-filled with zeros. Returns cudaGetLastError().
extern "C" int fusion_unproject_rle(const float* depth, const float* params,
                                    const float* consts, int c, int h, int w,
                                    int wp, int sentinel, int force_break,
                                    int capacity, int* tile_counts,
                                    int* tile_offsets, int* counts,
                                    int* out_keys, float* out_sums,
                                    cudaStream_t stream) {
  using namespace fusion;
  const long long n_ll = (long long)c * h * wp;
  const size_t smem = (size_t)(c * kCamParams + kGridConsts) * sizeof(float);
  if (c < 1 || h < 1 || w < 1 || wp < w || n_ll >= (1LL << 31)
      || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int n = (int)n_ll;
  const int tiles = num_tiles(n);
  fused_count_kernel<<<tiles, kThreads, smem, stream>>>(
      depth, params, consts, c, h, w, wp, n, sentinel, force_break,
      tile_counts, counts + 2);
  launch_scan_tile_counts(tile_counts, tile_offsets, tiles, capacity, counts,
                          stream);
  fused_emit_kernel<<<tiles, kThreads, smem, stream>>>(
      depth, params, consts, c, h, w, wp, n, sentinel, force_break,
      capacity, tile_offsets, out_keys, out_sums);
  return (int)cudaGetLastError();
}
