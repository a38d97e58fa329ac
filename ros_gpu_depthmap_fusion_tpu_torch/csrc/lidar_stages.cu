// The engine step's lidar stages 1-5 in two launches: the point-sequence
// filter of the staged batch, the rollbuffer insert, the expiry, the
// selection of the aggregation window and its gather into world and crop
// coordinates.
//
// No TPU counterpart: the JAX package runs these stages as plain jnp
// (state/rollbuffer.py, ops/stencil.py filter_point_sequence), and the
// port's plain twin, state/rollbuffer.py advance_and_gather_plain, is that
// chain op for op. Every output is bit-equal to the twin: the same integer
// clamps and shifts, and each float operation an explicit round-to-nearest
// intrinsic in the twin's order (the library is built with --fmad=false;
// the intrinsics are never contracted whatever the flags). The twin's
// transform_points_indirect is a chain of correctly rounded fused
// multiply-adds (emulated in float64 there), which is __fmaf_rn here.
//
// Design. Kernel A, the plan, is one block of 1,024 threads over the
// sequence slots (the default capacity, 1,024; larger capacities loop):
// block scans of the staged counts give insert_sequences' fit (a sequence
// cut by the point capacity drops whole, with every one after it), then
// the monotone-time clamp, roll's expiry counts, the new sequence arrays
// (written to the new buffer, dead slots 0 and the identity), the
// selection window, the window's composed T_world<-seq and T_crop<-seq,
// and a small int32 plan record. Kernel B, the points, is a grid over the
// point capacity: output row i of the new buffer is row i + n_disc_pts of
// the post-insert buffer, an old row or a staged one (whose scan-order
// filter it computes inline from its neighbours), and gathered row i is
// the new buffer's row point_start + i, transformed by its sequence's
// composed transforms. Nothing goes back to the host.
//
// Bound on the card: launch latency. At the link path's size (98,304
// buffer rows, 16,384 staged points, 1,024 sequence slots) the kernels
// move ~7.7 MB, ~2.3 us at 3.35 TB/s; the two dependent launches take
// tens of microseconds (PERF.md has the measured times).
#include <cuda_runtime.h>
#include <stdint.h>

namespace fusion {
namespace lidar {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPlanThreads = 1024;
constexpr int kPointThreads = 256;

// the plan record (int32), then the staged batch's exclusive count prefix
enum Plan {
  kNpOld, kNsOld, kStagedPoints, kFitPoints, kFitSeqs, kDiscPoints,
  kDiscSeqs, kNumPoints, kNumSeqs, kSelPointStart, kSelPointCount,
  kSelSeqStart, kSelSeqCount, kPlanInts = 16
};

struct Args {
  // the buffer the step starts from
  const float* points;     // [P, 4]
  const uint8_t* mask;     // [P]
  const int* seq_idx;      // [P]
  const int* seq_sec;      // [S]
  const int* seq_nsec;
  const int* seq_start;
  const int* seq_count;
  const float* seq_tf;     // [S, 4, 4]
  const int* num_points;   // [1]
  const int* num_seqs;
  // the staged batch
  const float* st_points;  // [SP, 4]
  const int* st_seq_idx;   // [SP]
  const int* st_sec;       // [SS]
  const int* st_nsec;
  const int* st_count;
  const float* st_tf;      // [SS, 4, 4]
  const int* st_num_points;
  const int* st_num_seqs;
  // frame scalars, [1] each
  const float* threshold;
  const int* min_sec;
  const int* min_nsec;
  const int* max_sec;
  const int* max_nsec;
  const float* tf_world_move;  // [4, 4]
  const float* tf_crop_move;
  // the new buffer
  float* o_points;
  uint8_t* o_mask;
  int* o_seq_idx;
  int* o_sec;
  int* o_nsec;
  int* o_start;
  int* o_count;
  float* o_tf;
  int* plan;               // [kPlanInts + SS]
  float* tfs;              // [2, S, 16]: world, crop
  // the gathered selection
  float* g_world;          // [capacity, 4]
  float* g_crop;
  uint8_t* g_valid;        // [capacity]
  int P, S, SP, SS, capacity, filter_size;
};

__device__ __forceinline__ bool time_lt(int as, int an, int bs, int bn) {
  return as < bs || (as == bs && an < bn);
}
__device__ __forceinline__ bool time_le(int as, int an, int bs, int bn) {
  return as < bs || (as == bs && an <= bn);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// torch.clamp_min: a NaN stays NaN
__device__ __forceinline__ float clamp_min_f(float v, float lo) {
  return v < lo ? lo : v;
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

// Inclusive scan of one int a thread over the plan block; *total is the
// block's sum. Every thread must call it.
__device__ int block_incl_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x = warp_incl_scan(v);
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) s_warp[lane] = warp_incl_scan(s_warp[lane]);
  __syncthreads();
  const int out = x + (w ? s_warp[w - 1] : 0);
  *total = s_warp[kPlanThreads / 32 - 1];
  __syncthreads();
  return out;
}

__device__ int block_sum(int v, int* s_warp) {
  int total;
  block_incl_scan(v, s_warp, &total);
  return total;
}

__device__ int block_min(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) s_warp[w] = v;
  __syncthreads();
  int m = s_warp[0];
  for (int k = 1; k < kPlanThreads / 32; ++k) m = min(m, s_warp[k]);
  __syncthreads();
  return m;
}

// Sequence slot k of the post-insert buffer (insert_sequences): staged
// record k - ns_old where it was written, else the old slot.
struct Inserted {
  const Args* a;
  const int* excl;
  int ns_old, np_old, fit_seqs, last_sec, last_nsec;

  __device__ int staged(int k) const {
    const int s = k - ns_old;
    return s >= 0 && s < fit_seqs ? s : -1;
  }
  __device__ void time(int k, int* sec, int* nsec) const {
    const int s = staged(k);
    if (s < 0) {
      *sec = a->seq_sec[k];
      *nsec = a->seq_nsec[k];
      return;
    }
    // the monotone-time clamp against the buffer's last stamp
    const int ss = a->st_sec[s], sn = a->st_nsec[s];
    const bool behind = time_lt(ss, sn, last_sec, last_nsec);
    *sec = behind ? last_sec : ss;
    *nsec = behind ? last_nsec : sn;
  }
  __device__ int start(int k) const {
    const int s = staged(k);
    return s < 0 ? a->seq_start[k] : np_old + excl[s];
  }
  __device__ int count(int k) const {
    const int s = staged(k);
    return s < 0 ? a->seq_count[k] : a->st_count[s];
  }
  __device__ const float* tf(int k) const {
    const int s = staged(k);
    return s < 0 ? a->seq_tf + 16 * k : a->st_tf + 16 * s;
  }
};

// compose_seq_transforms: T[r][c] = (A[r][0] B[0][c] + A[r][1] B[1][c])
//                                 + (A[r][2] B[2][c] + A[r][3] B[3][c])
__device__ __forceinline__ void compose(const float* A, const float* B,
                                        float* out) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[4 * r + c] = __fadd_rn(
          __fadd_rn(__fmul_rn(A[4 * r], B[c]), __fmul_rn(A[4 * r + 1],
                                                         B[4 + c])),
          __fadd_rn(__fmul_rn(A[4 * r + 2], B[8 + c]),
                    __fmul_rn(A[4 * r + 3], B[12 + c])));
}

static __global__ void __launch_bounds__(kPlanThreads)
plan_kernel(Args a) {
  __shared__ int s_warp[32];
  const int tid = threadIdx.x;
  const int P = a.P, S = a.S, SS = a.SS;
  const int np_old = *a.num_points, ns_old = *a.num_seqs;
  const int n_new_seqs = *a.st_num_seqs;
  int* excl = a.plan + kPlanInts;

  // -- insert_sequences: the sequences and points that fit
  const int fit_seqs0 = min(n_new_seqs, S - ns_old);
  int by_seq = 0;
  for (int s = tid; s < SS; s += kPlanThreads)
    by_seq += s < fit_seqs0 ? a.st_count[s] : 0;
  by_seq = block_sum(by_seq, s_warp);
  const int fit_points0 = min(by_seq, P - np_old);
  int fit_seqs = 0, carry_live = 0, carry_all = 0;
  for (int base = 0; base < SS; base += kPlanThreads) {
    const int s = base + tid;
    const int c = s < SS ? a.st_count[s] : 0;
    const bool fits = s < SS && s < fit_seqs0;
    int t_live, t_all;
    const int cum = carry_live
        + block_incl_scan(fits ? c : 0, s_warp, &t_live);
    const int incl = carry_all + block_incl_scan(c, s_warp, &t_all);
    carry_live += t_live;
    carry_all += t_all;
    fit_seqs += fits && cum <= fit_points0;
    if (s < SS) excl[s] = incl - c;
  }
  fit_seqs = block_sum(fit_seqs, s_warp);
  int fit_points = 0;
  for (int s = tid; s < SS; s += kPlanThreads)
    fit_points += s < fit_seqs ? a.st_count[s] : 0;
  fit_points = block_sum(fit_points, s_warp);  // syncs: excl is visible
  const int np_ins = np_old + fit_points, ns_ins = ns_old + fit_seqs;

  const bool has = ns_old > 0;
  const int last = max(ns_old - 1, 0);
  const Inserted ins{&a, excl, ns_old, np_old, fit_seqs,
                     has ? a.seq_sec[last] : -2147483647,
                     has ? a.seq_nsec[last] : 0};

  // -- roll: the expired sequences and their points
  const int min_sec = *a.min_sec, min_nsec = *a.min_nsec;
  int n_disc_seqs = 0, n_disc_pts = 0;
  for (int k = tid; k < S; k += kPlanThreads) {
    if (k >= ns_ins) continue;
    int sec, nsec;
    ins.time(k, &sec, &nsec);
    if (time_lt(sec, nsec, min_sec, min_nsec)) {
      ++n_disc_seqs;
      n_disc_pts += ins.count(k);
    }
  }
  n_disc_seqs = block_sum(n_disc_seqs, s_warp);
  n_disc_pts = block_sum(n_disc_pts, s_warp);
  const int num_points = np_ins - n_disc_pts;
  const int num_seqs = ns_ins - n_disc_seqs;

  // -- the new sequence arrays: slot k is post-insert slot k + n_disc_seqs
  const int shift = clampi(n_disc_seqs, 0, S);
  for (int k = tid; k < S; k += kPlanThreads) {
    const bool live = k < num_seqs;
    const int src = k + shift;
    const bool inside = src < S;
    const int j = min(src, S - 1);
    int sec = 0, nsec = 0, start = 0, count = 0;
    if (inside) {
      ins.time(j, &sec, &nsec);
      start = ins.start(j);
      count = ins.count(j);
    }
    a.o_sec[k] = live ? sec : 0;
    a.o_nsec[k] = live ? nsec : 0;
    a.o_start[k] = live ? start - n_disc_pts : 0;
    a.o_count[k] = live ? count : 0;
    const float* tf = ins.tf(j);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      a.o_tf[16 * k + e] = live ? (inside ? tf[e] : 0.0f)
                                : (e % 5 == 0 ? 1.0f : 0.0f);
  }
  __syncthreads();

  // -- select_timespan on the new arrays
  const int max_sec = *a.max_sec, max_nsec = *a.max_nsec;
  int n_in = 0, pts_in = 0, first = S;
  for (int k = tid; k < S; k += kPlanThreads) {
    if (k >= num_seqs) continue;
    const int sec = a.o_sec[k], nsec = a.o_nsec[k];
    if (!time_lt(sec, nsec, min_sec, min_nsec)
        && time_le(sec, nsec, max_sec, max_nsec)) {
      ++n_in;
      pts_in += a.o_count[k];
      first = min(first, k);
    }
  }
  n_in = block_sum(n_in, s_warp);
  pts_in = block_sum(pts_in, s_warp);
  first = block_min(first, s_warp);
  const bool any = n_in > 0;
  const int sel_seq_start = any ? first : num_seqs;

  // -- the window's composed transforms: entry t is slot t + seq_start
  float A[16], C[16], B[16], T[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    A[e] = a.tf_world_move[e];
    C[e] = a.tf_crop_move[e];
  }
  for (int t = tid; t < S; t += kPlanThreads) {
    const int slot = (int)min(max((long long)t + sel_seq_start, 0LL),
                              (long long)S - 1);
#pragma unroll
    for (int e = 0; e < 16; ++e) B[e] = a.o_tf[16 * slot + e];
    compose(A, B, T);
#pragma unroll
    for (int e = 0; e < 16; ++e) a.tfs[16 * t + e] = T[e];
    compose(C, B, T);
#pragma unroll
    for (int e = 0; e < 16; ++e) a.tfs[16 * (S + t) + e] = T[e];
  }

  if (tid == 0) {
    int* p = a.plan;
    p[kNpOld] = np_old;
    p[kNsOld] = ns_old;
    p[kStagedPoints] = *a.st_num_points;
    p[kFitPoints] = fit_points;
    p[kFitSeqs] = fit_seqs;
    p[kDiscPoints] = n_disc_pts;
    p[kDiscSeqs] = n_disc_seqs;
    p[kNumPoints] = num_points;
    p[kNumSeqs] = num_seqs;
    p[kSelPointStart] = any ? a.o_start[first] : 0;
    p[kSelPointCount] = pts_in;
    p[kSelSeqStart] = sel_seq_start;
    p[kSelSeqCount] = n_in;
#pragma unroll
    for (int e = kSelSeqCount + 1; e < kPlanInts; ++e) p[e] = 0;
  }
}

struct Row {
  float x, y, z, w;
  bool mask;
  int seq_idx;
};

// filter_point_sequence of staged point k: offsets {-1, .., f - 2} U
// {1, .., f} without 0, i.e. -1 and 1..f (none at f < 1); a neighbour
// counts inside [0, valid); each operation rounds as in ops/stencil.py.
__device__ bool filter_staged(const Args& a, int k, int valid, float thr) {
  const float* p = a.st_points + 4 * k;
  const float px = p[0], py = p[1], pz = p[2];
  const float norm = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                __fmul_rn(pz, pz)));
  if (!(k < valid && norm >= 1e-3f)) return false;
  const float den = clamp_min_f(norm, 1e-30f);
  const float vx = __fdiv_rn(-px, den), vy = __fdiv_rn(-py, den),
              vz = __fdiv_rn(-pz, den);
  for (int d = -1; d <= a.filter_size; ++d) {
    if (d == 0 || a.filter_size < 1) continue;
    const int q = k + d;
    if (q < 0 || q >= valid) continue;
    const float* n = a.st_points + 4 * q;
    const float dx = __fsub_rn(n[0], px), dy = __fsub_rn(n[1], py),
                dz = __fsub_rn(n[2], pz);
    const float dn = clamp_min_f(
        __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz))),
        1e-30f);
    const float cosb = fabsf(__fadd_rn(
        __fadd_rn(__fmul_rn(__fdiv_rn(dx, dn), vx),
                  __fmul_rn(__fdiv_rn(dy, dn), vy)),
        __fmul_rn(__fdiv_rn(dz, dn), vz)));
    if (__fsub_rn(1.0f, cosb) < thr) return false;
  }
  return true;
}

// Row r of the post-insert buffer: staged point r - np_old where the
// insert wrote one, else the old row.
__device__ Row inserted_row(const Args& a, const int* plan, int r,
                            float thr) {
  const int k = r - clampi(plan[kNpOld], 0, a.P);
  Row out;
  if (k >= 0 && k < plan[kFitPoints] && k < a.SP) {
    const float* p = a.st_points + 4 * k;
    out = {p[0], p[1], p[2], p[3],
           filter_staged(a, k, plan[kStagedPoints], thr),
           a.st_seq_idx[k] + plan[kNsOld]};
  } else {
    const float* p = a.points + 4 * r;
    out = {p[0], p[1], p[2], p[3], a.mask[r] != 0, a.seq_idx[r]};
  }
  return out;
}

// Row j of the new buffer (roll): post-insert row j + n_disc_pts.
__device__ Row new_row(const Args& a, const int* plan, int j, float thr) {
  const bool live = j < plan[kNumPoints];
  const int src = j + clampi(plan[kDiscPoints], 0, a.P);
  const bool inside = src < a.P;
  Row r = {0.0f, 0.0f, 0.0f, 0.0f, false, 0};
  if (inside) r = inserted_row(a, plan, min(src, a.P - 1), thr);
  if (!live) return {0.0f, 0.0f, 0.0f, 0.0f, false, 0};
  r.seq_idx -= plan[kDiscSeqs];
  return r;
}

// transform_points_indirect: out_r = fma(T[r][3], w, fma(T[r][2], z,
// fma(T[r][1], y, T[r][0] * x)))
__device__ __forceinline__ void transform(const float* T, const Row& p,
                                          float* out) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float acc = __fmul_rn(T[4 * r], p.x);
    acc = __fmaf_rn(T[4 * r + 1], p.y, acc);
    acc = __fmaf_rn(T[4 * r + 2], p.z, acc);
    out[r] = __fmaf_rn(T[4 * r + 3], p.w, acc);
  }
}

static __global__ void __launch_bounds__(kPointThreads)
points_kernel(Args a) {
  const int i = blockIdx.x * kPointThreads + threadIdx.x;
  if (i >= a.P) return;
  const int* plan = a.plan;
  const float thr = *a.threshold;

  const Row r = new_row(a, plan, i, thr);
  float* o = a.o_points + 4 * i;
  o[0] = r.x;
  o[1] = r.y;
  o[2] = r.z;
  o[3] = r.w;
  a.o_mask[i] = r.mask;
  a.o_seq_idx[i] = r.seq_idx;
  if (i >= a.capacity) return;

  // gather_selection: the new buffer's row point_start + i
  const int src = i + clampi(plan[kSelPointStart], 0, a.P);
  Row g = {0.0f, 0.0f, 0.0f, 0.0f, false, 0};
  if (src < a.P) g = new_row(a, plan, src, thr);
  const bool valid = g.mask && i < plan[kSelPointCount];
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (valid) {
    const int t = clampi(g.seq_idx - plan[kSelSeqStart], 0, a.S - 1);
    transform(a.tfs + 16 * t, g, w);
    transform(a.tfs + 16 * (a.S + t), g, c);
  }
  float* ow = a.g_world + 4 * i;
  float* oc = a.g_crop + 4 * i;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ow[e] = w[e];
    oc[e] = c[e];
  }
  a.g_valid[i] = valid;
}

}  // namespace lidar
}  // namespace fusion

// The lidar stages of one step (see the top of this file): every output of
// *args needs no initialisation; the plan buffer holds kPlanInts + SS int32
// words. Returns cudaGetLastError().
extern "C" int fusion_lidar_stages(const fusion::lidar::Args* args,
                                   cudaStream_t stream) {
  using namespace fusion::lidar;
  const Args& a = *args;
  if (a.P < 1 || a.S < 1 || a.SP < 1 || a.SS < 1 || a.capacity < 0
      || a.capacity > a.P || a.P > (1 << 29))
    return (int)cudaErrorInvalidValue;
  plan_kernel<<<1, kPlanThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  points_kernel<<<(a.P + kPointThreads - 1) / kPointThreads, kPointThreads,
                  0, stream>>>(a);
  return (int)cudaGetLastError();
}
