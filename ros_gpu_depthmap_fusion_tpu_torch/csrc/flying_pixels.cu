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
// Design: one thread per pixel, neighbours read straight from global
// memory (a neighbour row is shared by the threads of the rows around it
// and hits L1/L2). threshold and max_distance are read from a device array
// so a live reconfiguration costs no host sync.
//
// Bound on the card: memory. Per pixel it reads 16 bytes of point and 1
// byte of mask and writes 1 byte; the 4 * (1 + rot45) * filter_size
// neighbour reads come from cache. At 8 x 480 x 848 that is ~55 MB of
// compulsory traffic. Left for later: a shared-memory tile with a
// filter_size halo, and reading the three coordinates as planes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace fusion {

constexpr int kFpThreads = 256;

__device__ __forceinline__ float3 load_xyz(const float4* __restrict__ p,
                                           int idx) {
  const float4 v = p[idx];
  return make_float3(v.x, v.y, v.z);
}

static __global__ void __launch_bounds__(kFpThreads)
flying_pixels_kernel(const float4* __restrict__ pts,
                     const uint8_t* __restrict__ mask,
                     uint8_t* __restrict__ out, int cams, int h, int w,
                     int filter_size, int rot45,
                     const float* __restrict__ params) {
  const long long hw = (long long)h * w;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)cams * hw) return;
  const int cam = (int)(gid / hw);
  const int pix = (int)(gid - (long long)cam * hw);
  const int y = pix / w;
  const int x = pix - y * w;
  const float4* img = pts + (long long)cam * hw;
  const uint8_t* msk = mask + (long long)cam * hw;

  const float threshold = params[0];
  const float max_distance = params[1];

  const bool m = msk[pix] != 0;
  const float3 p = load_xyz(img, pix);
  const float dist2 = (p.x * p.x + p.y * p.y) + p.z * p.z;
  bool keep = m && dist2 <= max_distance * max_distance;

  const float3 v = make_float3(-p.x, -p.y, -p.z);
  const float vlen = fmaxf(sqrtf((v.x * v.x + v.y * v.y) + v.z * v.z),
                           1e-30f);
  const float vx = v.x / vlen, vy = v.y / vlen, vz = v.z / vlen;

  for (int d = 1; d <= filter_size && keep; ++d) {
    // in-bounds test shared by both neighbourhoods of ring d
    if (x - d < 0 || x + d > w - 1 || y - d < 0 || y + d > h - 1) {
      keep = false;
      break;
    }
    for (int r = 0; r <= rot45 && keep; ++r) {
      // (dy, dx) of up, down, left, right (stencil.py:77-90)
      int o[4][2];
      if (r == 0) {
        o[0][0] = -d; o[0][1] = 0;  o[1][0] = d;  o[1][1] = 0;
        o[2][0] = 0;  o[2][1] = -d; o[3][0] = 0;  o[3][1] = d;
      } else {
        o[0][0] = -d; o[0][1] = -d; o[1][0] = d;  o[1][1] = d;
        o[2][0] = d;  o[2][1] = -d; o[3][0] = -d; o[3][1] = d;
      }
      int nb[4];
      bool ok = true;
      for (int k = 0; k < 4; ++k) {
        nb[k] = (y + o[k][0]) * w + (x + o[k][1]);
        ok = ok && msk[nb[k]] != 0;
      }
      if (!ok) {
        keep = false;
        break;
      }
      const float3 up = load_xyz(img, nb[0]);
      const float3 down = load_xyz(img, nb[1]);
      const float3 left = load_xyz(img, nb[2]);
      const float3 right = load_xyz(img, nb[3]);
      // a = down - up, b = right - left, normal = cross(a, b)
      const float a0 = down.x - up.x, a1 = down.y - up.y, a2 = down.z - up.z;
      const float b0 = right.x - left.x, b1 = right.y - left.y,
                  b2 = right.z - left.z;
      float n0 = a1 * b2 - a2 * b1;
      float n1 = a2 * b0 - a0 * b2;
      float n2 = a0 * b1 - a1 * b0;
      const float nlen =
          fmaxf(sqrtf((n0 * n0 + n1 * n1) + n2 * n2), 1e-30f);
      n0 = n0 / nlen;
      n1 = n1 / nlen;
      n2 = n2 / nlen;
      const float cos_view = (n0 * vx + n1 * vy) + n2 * vz;
      keep = cos_view >= threshold;
    }
  }
  out[gid] = keep ? 1 : 0;
}

}  // namespace fusion

// points [cams, h*w, 4] float32 (16-byte aligned); mask, out [cams, h*w]
// uint8 (0/1); params [2] float32 = {threshold, max_distance}. Returns
// cudaGetLastError().
extern "C" int fusion_flying_pixels(const float* points, const uint8_t* mask,
                                    uint8_t* out, int cams, int h, int w,
                                    int filter_size, int rot45,
                                    const float* params,
                                    cudaStream_t stream) {
  using namespace fusion;
  const long long total = (long long)cams * h * w;
  if (total > 0) {
    const long long blocks = (total + kFpThreads - 1) / kFpThreads;
    flying_pixels_kernel<<<(unsigned)blocks, kFpThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(points), mask, out, cams, h, w,
        filter_size, rot45 ? 1 : 0, params);
  }
  return (int)cudaGetLastError();
}
