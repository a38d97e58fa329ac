// Flying-pixel filter: per depth pixel, reject points beyond max_distance
// and points whose local surface normal (from ring neighbours) is seen at
// a grazing angle.
//
// Replaces: ros_gpu_depthmap_fusion_tpu/ops/pallas/flying_pixels.py:130
// filter_flying_pixels_pallas (pallas_call at :162, body _kernel at :48).
// The arithmetic follows the plain formulation the JAX engine runs off the
// TPU, ros_gpu_depthmap_fusion_tpu/ops/stencil.py:38-115, op for op:
//   dist2 = (x*x + y*y) + z*z;  keep = mask && dist2 <= maxd*maxd
//   view  = -p / max(sqrt(|p|^2), 1e-30)
//   for each ring d = 1..filter_size, and its rot45 twin when enabled:
//     all 4 neighbours (and the centre) valid and in bounds,
//     normal = cross(down - up, right - left) / max(|normal|, 1e-30),
//     keep &= (nx*vx + ny*vy) + nz*vz >= threshold.
// It is built with --fmad=false and IEEE division and square root, so each
// operation rounds as it does in the plain twin; the masks are equal.
//
// Design: a 2-D grid of kFpTileX x kFpTileY pixel tiles, the camera in
// blockIdx.z (no integer division anywhere). A block first stages its tile
// plus a halo of filter_size pixels on all four sides in shared memory,
// one coalesced 16-byte load and one 16-byte shared store a point, with the
// mask folded into the point's unused w lane (all ones = valid). A halo
// position outside the image is staged invalid, which is the border rule:
// a pixel within d of any border has a ring-d neighbour (plain and rot45
// rings both touch all four sides) that is out of bounds, and fails. Every
// neighbour then comes from shared memory as one 16-byte load: a quarter
// warp's 8 consecutive pixels read 128 consecutive bytes, so the loads are
// free of bank conflicts, and a ring costs 4 shared loads (as three
// coordinate planes and a flag plane it cost 16, each with its own address;
// measured slower). A thread takes kFpPix pixels of one column,
// kFpThreadsY rows apart, so that the staging and the set-up are paid once
// for them; the kernel is compiled with and without the rot45 ring, so
// that the ring's offsets are not chosen at run time. A warp packs its 32
// results with one ballot and every fourth lane stores four of them as one
// 32-bit word; only where a row of the output is not 4-byte aligned
// (w % 4 != 0) or the image ends inside the four, each lane stores its own
// byte. threshold and max_distance are read from a device array so a live
// reconfiguration costs no host sync.
//
// Bound on the card: per pixel it must read 16 bytes of point and 1 byte of
// mask and write 1 byte, ~59 MB at 8 x 480 x 848; a tile also reads its
// halo, (34 x 10) / (32 x 8) = 1.33 times the points at filter_size 1,
// mostly from L2. What holds it above that is instruction rate: the IEEE
// divisions and square roots (3 + 1 for the view ray, 3 + 1 a ring) expand
// to ~10 instructions each, 120 of a pixel's ~300 at one ring pair
// (PERF.md has the measured times).
#include <cuda_runtime.h>
#include <stdint.h>

namespace fusion {

constexpr int kFpTileX = 32;     // a multiple of 32: a warp is one row piece
constexpr int kFpThreadsY = 4;
constexpr int kFpPix = 2;        // pixels a thread, kFpThreadsY rows apart
constexpr int kFpTileY = kFpThreadsY * kFpPix;
// rings a launch takes: the halo columns are staged by the first 2 *
// filter_size threads of a row, and the tile with its halo must fit the 48
// KB of shared memory a kernel gets without opting in
// ((32 + 16) x (8 + 16) x 16 bytes = 18 KB)
constexpr int kFpMaxFilter = 8;
static_assert(2 * kFpMaxFilter <= kFpTileX && kFpTileX % 32 == 0, "");
constexpr unsigned kFpFull = 0xffffffffu;

static inline size_t fp_smem_bytes(int filter_size) {
  return (size_t)(kFpTileX + 2 * filter_size)
         * (kFpTileY + 2 * filter_size) * sizeof(float4);
}

// Ring test of a pixel whose neighbours are staged at up, down, left and
// right: all four valid (w lanes all ones), then cos(normal, view) >=
// threshold, op for op as stencil.py:92-115.
__device__ __forceinline__ bool fp_ring(const float4* up_p,
                                        const float4* down_p,
                                        const float4* left_p,
                                        const float4* right_p, float vx,
                                        float vy, float vz, float threshold) {
  const float4 up = *up_p, down = *down_p, left = *left_p, right = *right_p;
  if (!(__float_as_uint(up.w) & __float_as_uint(down.w)
        & __float_as_uint(left.w) & __float_as_uint(right.w)))
    return false;
  // a = down - up, b = right - left, normal = cross(a, b)
  const float a0 = down.x - up.x, a1 = down.y - up.y, a2 = down.z - up.z;
  const float b0 = right.x - left.x, b1 = right.y - left.y,
              b2 = right.z - left.z;
  float n0 = a1 * b2 - a2 * b1;
  float n1 = a2 * b0 - a0 * b2;
  float n2 = a0 * b1 - a1 * b0;
  const float nlen = fmaxf(sqrtf((n0 * n0 + n1 * n1) + n2 * n2), 1e-30f);
  n0 = n0 / nlen;
  n1 = n1 / nlen;
  n2 = n2 / nlen;
  const float cos_view = (n0 * vx + n1 * vy) + n2 * vz;
  return cos_view >= threshold;
}

template <bool kRot45>
static __global__ void __launch_bounds__(kFpTileX * kFpThreadsY)
flying_pixels_kernel(const float4* __restrict__ pts,
                     const uint8_t* __restrict__ mask,
                     uint8_t* __restrict__ out, int h, int w,
                     int filter_size, const float* __restrict__ params) {
  extern __shared__ float4 tile[];             // [sh][sw]: x, y, z, valid
  const int sw = kFpTileX + 2 * filter_size;   // staged row pitch
  const int sh = kFpTileY + 2 * filter_size;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kFpTileX, y0 = blockIdx.y * kFpTileY;
  const int cam_base = blockIdx.z * h * w;
  const float4* img = pts + cam_base;
  const uint8_t* msk = mask + cam_base;
  const float threshold = params[0];
  const float max_distance = params[1];

  // ---- stage the tile and its halo: a thread takes column tx of every
  // kFpThreadsY-th staged row, the first 2 * filter_size threads also the
  // column past the tile's width
  for (int r = ty; r < sh; r += kFpThreadsY) {
    const int gy = y0 - filter_size + r;
    const bool row_in = gy >= 0 && gy < h;
    const int g_row = gy * w + x0 - filter_size;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tx + q * kFpTileX;
      if (c >= sw) break;
      const int gx = x0 - filter_size + c;
      float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row_in && gx >= 0 && gx < w) {
        const bool m = msk[g_row + c] != 0;
        p = img[g_row + c];
        p.w = __uint_as_float(m ? 0xffffffffu : 0u);
      }
      tile[r * sw + c] = p;
    }
  }
  __syncthreads();

  const int lane = tx & 31;
  const int quad = lane & 3;
  const int x = x0 + tx;
#pragma unroll
  for (int j = 0; j < kFpPix; ++j) {
    // ---- one pixel, all reads from the staged tile
    const int yt = ty + j * kFpThreadsY;
    const int y = y0 + yt;
    const float4* centre = tile + (yt + filter_size) * sw + tx + filter_size;
    const float4 p = *centre;
    bool keep = __float_as_uint(p.w) != 0;   // false outside the image
    if (keep) {
      const float px = p.x, py = p.y, pz = p.z;
      const float dist2 = (px * px + py * py) + pz * pz;
      keep = dist2 <= max_distance * max_distance;
      if (keep && filter_size > 0) {
        const float v0 = -px, v1 = -py, v2 = -pz;
        const float vlen =
            fmaxf(sqrtf((v0 * v0 + v1 * v1) + v2 * v2), 1e-30f);
        const float vx = v0 / vlen, vy = v1 / vlen, vz = v2 / vlen;
        // up, down, left, right of ring d (stencil.py:77-90), as (dy, dx):
        // (-d, 0) (d, 0) (0, -d) (0, d), then rotated by 45 degrees
        // (-d, -d) (d, d) (d, -d) (-d, d)
        for (int d = 1; d <= filter_size && keep; ++d) {
          const int dr = d * sw;
          keep = fp_ring(centre - dr, centre + dr, centre - d, centre + d,
                         vx, vy, vz, threshold);
          if (kRot45 && keep)
            keep = fp_ring(centre - dr - d, centre + dr + d, centre + dr - d,
                           centre - dr + d, vx, vy, vz, threshold);
        }
      }
    }

    // ---- a warp is 32 consecutive pixels of one row: four results a word
    const unsigned kept = __ballot_sync(kFpFull, keep);
    // dereferenced only inside the image
    uint8_t* dst = out + ((size_t)cam_base + (size_t)y * w + x);
    const bool whole = y < h && x - quad + 3 < w
                       && (reinterpret_cast<uintptr_t>(dst - quad) & 3) == 0;
    if (whole) {
      if (quad == 0) {
        const unsigned b = kept >> lane;
        *reinterpret_cast<uint32_t*>(dst) =
            (b & 1u) | (b & 2u) << 7 | (b & 4u) << 14 | (b & 8u) << 21;
      }
    } else if (y < h && x < w) {
      *dst = keep ? 1 : 0;
    }
  }
}

}  // namespace fusion

// points [cams, h*w, 4] float32 (16-byte aligned); mask, out [cams, h*w]
// uint8 (0/1); params [2] float32 = {threshold, max_distance}; 0 <=
// filter_size <= 8 (kFpMaxFilter), cams * h * w < 2^31,
// cams and the rows' tiles at most 65,535 (a grid's y and z extents).
// Returns cudaGetLastError().
extern "C" int fusion_flying_pixels(const float* points, const uint8_t* mask,
                                    uint8_t* out, int cams, int h, int w,
                                    int filter_size, int rot45,
                                    const float* params,
                                    cudaStream_t stream) {
  using namespace fusion;
  const long long total = (long long)cams * h * w;
  const int tiles_y = (h + kFpTileY - 1) / kFpTileY;
  if (cams < 0 || h < 0 || w < 0 || filter_size < 0
      || filter_size > kFpMaxFilter || total >= (1LL << 31) || cams > 65535
      || tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  if (total > 0) {
    const dim3 grid((w + kFpTileX - 1) / kFpTileX, tiles_y, cams);
    const dim3 block(kFpTileX, kFpThreadsY);
    const size_t smem = fp_smem_bytes(filter_size);
    const float4* pts = reinterpret_cast<const float4*>(points);
    if (rot45)
      flying_pixels_kernel<true><<<grid, block, smem, stream>>>(
          pts, mask, out, h, w, filter_size, params);
    else
      flying_pixels_kernel<false><<<grid, block, smem, stream>>>(
          pts, mask, out, h, w, filter_size, params);
  }
  return (int)cudaGetLastError();
}
